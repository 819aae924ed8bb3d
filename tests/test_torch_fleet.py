"""The port's serving fleet (src/repro_torch/launch/fleet.py and the Session
publish hook) against the reference's tests/test_fleet.py, case for case:
after every applied wire record a replica's params are BIT-IDENTICAL to the
trainer's post-step model; mid-stream join via checkpoint + replay; the
trainer's kill-and-resume republish; gap → resync, never drift; the
decode-budget scheduler's admissions (equal to the reference's).

The anchor grid runs within the port: downlinks dense, quant8, quant4
(sparse payload) and fused_quant4 × the uniform plan and a mixed schedule,
and a randk downlink (the port's own generator), SGD, then AdamW (the
optimizer steps at the PRE-increment step).

Across the packages, on smoke smollm-360m, 3 steps, the norms on a dense
leg and every other leaf on a quant4 downlink (sparse payload), SGD and
AdamW:
- (d) a port ServeReplica joins a stream the JAX trainer published;
- (e) a JAX ServeReplica (its Subscriber) replays a stream the port
  published.
The dense legs' h (the server's own leaves) is equal bit for bit, and so
are their params under SGD. Elsewhere the replica is held within 2 f32
ulps of each leaf's largest magnitude a record applied (2·t ulps after
record t): XLA-CPU contracts the reference's integrate (h + q·scale) and
its AdamW arithmetic to FMA, the port rounds twice (ROADMAP standing
facts). Measured on these inputs, the worst leaf after records 1, 2, 3:
(d) SGD 0, 0.5, 1 ulps, AdamW 2 (final_norm), 2, 3; (e) SGD 0, 1, 1,
AdamW 1, 2, 3.
"""
import collections
import os
import shutil
import warnings

import jax
import numpy as np
import pytest
import torch

from repro.launch import fleet as jax_fleet
from repro.launch import session as jax_session
from repro.launch import spec as jax_spec
from repro_torch.core import ef as ef_lib
from repro_torch.core import stream as stream_lib
from repro_torch.launch import fleet as fleet_lib
from repro_torch.launch.fleet import DecodeBudgetScheduler, Request
from repro_torch.launch.session import Session
from repro_torch.launch.spec import RunSpec
from test_torch_schedule import one_torch_thread  # noqa: F401 (autouse)
from test_torch_schedule import torch_threads

TINY = dict(arch="smollm-360m", smoke=True, clients=2, global_batch=4,
            seq_len=32)
QUANT4 = dict(compressor="block_topk", ratio=0.1,
              downlink_carrier="quant4", downlink_ratio=0.05)
DOWNLINKS = {
    "dense": {},
    "quant8": {"downlink_carrier": "quant8", "downlink_ratio": 0.05},
    "quant4": {"downlink_carrier": "quant4", "downlink_ratio": 0.05},
    "fused_quant4": {"downlink_carrier": "fused_quant4",
                     "downlink_ratio": 0.05},
}
# the reference's MIXED_GROUPS, the catch-all's downlink from DOWNLINKS
MIXED = [{"pattern": "norm|bias", "carrier": "dense"},
         {"pattern": "embed", "carrier": "quant4", "ratio": 0.05}]
# (d)/(e): the norms on a dense leg, the rest on the quant4 downlink
CROSS = dict(compressor="block_topk", ratio=0.1, groups=[
    {"pattern": "norm", "carrier": "dense"},
    {"pattern": "*", "carrier": "dense", "downlink_carrier": "quant4",
     "downlink_ratio": 0.05}])
ADAMW = dict(optimizer="adamw", lr=1e-3)


def _grid():
    for down, fields in DOWNLINKS.items():
        yield pytest.param(dict(compressor="block_topk", ratio=0.1, **fields),
                           id=f"uniform-{down}")
        yield pytest.param(dict(compressor="block_topk", ratio=0.1, groups=[
            *MIXED, {"pattern": "*", "carrier": "sparse", "ratio": 0.02,
                     **fields}]), id=f"mixed-{down}")
    yield pytest.param(dict(compressor="randk", ratio=0.1,
                            downlink_carrier="sparse", downlink_ratio=0.05),
                       id="uniform-randk")
    yield pytest.param(dict(QUANT4, **ADAMW), id="uniform-quant4-adamw")


def _clone(tree):
    return {k: v.detach().clone() for k, v in tree.items()}


def _leaves_equal(a, b) -> bool:
    return sorted(a) == sorted(b) and all(torch.equal(a[k], b[k]) for k in a)


def _publish_run(stream_dir, steps, **spec_kw):
    """A publishing session on the CPU, and its params after every step."""
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")         # randk's dense-plan notice
        sess = Session(RunSpec(**TINY, **spec_kw), device="cpu")
    sess.publish_to(str(stream_dir), bootstrap_every=2)
    snaps = {}
    for _ in range(steps):
        sess.step_once()
        snaps[sess.step] = _clone(sess.params)
    return sess, snaps


@pytest.fixture(scope="module")
def quant4_stream(tmp_path_factory):
    """One quant4 stream shared by the read-only fleet tests: 5 published
    steps, bootstraps at 0/2/4, the trainer's params at every step."""
    root = tmp_path_factory.mktemp("wire_q4")
    with torch_threads(1):
        sess, snaps = _publish_run(root, steps=5, **QUANT4)
    return {"dir": str(root), "snaps": snaps, "spec": sess.spec}


def _replica(stream, **kw):
    return fleet_lib.ServeReplica(stream, device="cpu", **kw)


# ---------------------------------------------------------------------------
# the anchor invariant: bit-identity after every applied record
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("spec_kw", list(_grid()))
def test_replica_bit_identical_after_every_record(tmp_path, spec_kw):
    """Replay from the step-0 bootstrap, comparing the replica against the
    trainer after EVERY applied step: the dense push, quant8, quant4 and
    fused_quant4 downlinks, each uniform and under a mixed schedule, a
    randk downlink drawing from the port's generator, and AdamW."""
    sess, snaps = _publish_run(tmp_path, steps=3, **spec_kw)
    rep = _replica(str(tmp_path), bootstrap_step=0)
    assert rep.step == 0
    assert "ef_state" not in rep._likes or \
        sorted(rep._likes["ef_state"]) == ["h"]   # no client EF state
    for step in (1, 2, 3):
        assert rep.sync(upto=step) == 1
        assert rep.step == step
        assert _leaves_equal(rep.params, snaps[step]), \
            f"replica drifted from trainer at step {step}"
    if rep.sub.h is not None:
        assert _leaves_equal(rep.sub.h, sess.ef_state["h"])
    assert _leaves_equal(rep.sub.opt_state.get("m", {}),
                         sess.opt_state.get("m", {}))


def test_replica_bit_identical_quant4_every_step(quant4_stream):
    rep = _replica(quant4_stream["dir"], bootstrap_step=0)
    for step in range(1, 6):
        rep.sync(upto=step)
        assert _leaves_equal(rep.params, quant4_stream["snaps"][step])


def test_mid_stream_join_uses_newest_bootstrap(quant4_stream):
    """A replica joining late joins from the newest bootstrap (step 4 of
    5), not step 0, and lands bit-identical to the head."""
    rep = _replica(quant4_stream["dir"])
    assert rep.step == 4
    rep.sync()
    assert rep.step == 5
    assert _leaves_equal(rep.params, quant4_stream["snaps"][5])


def test_lagged_replica_joins_behind_and_stays_behind(quant4_stream):
    rep = _replica(quant4_stream["dir"], lag=3)
    rep.sync()
    assert rep.step == 2                       # head 5 − lag 3
    assert _leaves_equal(rep.params, quant4_stream["snaps"][2])


def test_trainer_kill_and_resume_republish_is_idempotent(tmp_path):
    """Kill the trainer after publishing step 3, resume from its step-2
    checkpoint: the resumed run REPUBLISHES step 3 (verified equal → no-op,
    a diverged record would raise) and extends the stream; a replica
    replaying the whole log lands on the resumed trainer's head."""
    stream, ckpt = tmp_path / "wire", tmp_path / "ckpt"
    sess = Session(RunSpec(**TINY, **QUANT4, ckpt_dir=str(ckpt)),
                   device="cpu")
    sess.publish_to(str(stream), bootstrap_every=2)
    sess.train(2, log_every=0)                 # checkpoints at step 2
    sess.step_once()                           # publishes step 3, no ckpt
    del sess                                   # "kill" after step 3
    resumed = Session.resume(str(ckpt), device="cpu")
    assert resumed.step == 2
    resumed.publish_to(str(stream))
    for _ in range(3):                         # steps 3 (republish), 4, 5
        resumed.step_once()
    assert stream_lib.WireLog(str(stream)).last_step() == 5
    rep = _replica(str(stream), bootstrap_step=0)
    rep.sync()
    assert rep.step == 5
    assert _leaves_equal(rep.params, resumed.params)


def test_publisher_refuses_a_wire_that_misses_h(tmp_path):
    """The verify: an h_new one ulp off the wires' integrate raises, and no
    record is written. The step leaves the old h's tensors untouched, so
    the hook's pre-step h is the h the step integrated."""
    sess = Session(RunSpec(**TINY, **QUANT4), device="cpu")
    log = sess.publish_to(str(tmp_path))
    h_prev = sess.ef_state["h"]
    before = _clone(h_prev)
    sess.step_once()
    assert _leaves_equal(h_prev, before)
    h_new = _clone(sess.ef_state["h"])
    h_new["embed"].view(-1)[0] = torch.nextafter(h_new["embed"].view(-1)[0],
                                                 torch.tensor(np.inf))
    pub = stream_lib.Publisher(stream_lib.WireLog(str(tmp_path / "x")),
                               sess.spec.spec_hash(), sess.publisher.legs,
                               sess.spec.seed)
    with pytest.raises(stream_lib.StreamIntegrityError):
        pub.publish(1, sess.ef_state["server"], h_prev, h_new)
    assert pub.log.steps() == []
    assert pub.publish(1, sess.ef_state["server"], h_prev,
                       sess.ef_state["h"]) == 1
    assert stream_lib.records_equal(pub.log.read(1, 0), log.read(1, 0))


# ---------------------------------------------------------------------------
# gaps and foreign streams: resync, never drift
# ---------------------------------------------------------------------------

def _mutable_copy(stream, tmp_path):
    dst = tmp_path / "wire_copy"
    shutil.copytree(stream["dir"], dst)
    return str(dst)


def test_gap_triggers_resync_via_later_bootstrap(quant4_stream, tmp_path):
    """Delete the step-3 record set: a replica replaying from step 0 hits
    the gap and RESYNCS from the step-4 bootstrap, landing bit-identical at
    the head — never skipping the missing step."""
    d = _mutable_copy(quant4_stream, tmp_path)
    os.remove(stream_lib.WireLog(d).record_path(3, 0))
    rep = _replica(d, bootstrap_step=0)
    assert rep.sync() == 5                     # 2 replayed + resync to 4 + 1
    assert rep.step == 5
    assert _leaves_equal(rep.params, quant4_stream["snaps"][5])


def test_unbridgeable_gap_raises_and_keeps_consistent_params(quant4_stream,
                                                             tmp_path):
    d = _mutable_copy(quant4_stream, tmp_path)
    log = stream_lib.WireLog(d)
    os.remove(log.record_path(3, 0))
    for b in (2, 4):                           # only the step-0 anchor left
        os.remove(log.bootstrap_path(b))
    rep = _replica(d, bootstrap_step=0)
    with pytest.raises(stream_lib.StreamGapError):
        rep.sync()
    assert rep.step == 2                       # applied 1..2, refused to skip 3
    assert _leaves_equal(rep.params, quant4_stream["snaps"][2])


def test_foreign_record_refused_loudly(quant4_stream, tmp_path):
    d = _mutable_copy(quant4_stream, tmp_path)
    log = stream_lib.WireLog(d)
    rec5 = log.read(5, 0)
    log.append(stream_lib.WireRecord(**{**rec5.__dict__, "step": 6,
                                        "spec_hash": "0" * 16}))
    rep = _replica(d)                          # joins at bootstrap 4
    with pytest.raises(stream_lib.StreamSpecMismatch):
        rep.sync()


def test_empty_stream_refuses_replica(tmp_path):
    with pytest.raises(stream_lib.StreamError):
        _replica(str(tmp_path / "nope"))


# ---------------------------------------------------------------------------
# decode-budget scheduler
# ---------------------------------------------------------------------------

def _queue(*max_new):
    return collections.deque(
        Request(rid=i, tokens=np.zeros(4, np.int64), max_new_tokens=m)
        for i, m in enumerate(max_new))


def test_scheduler_respects_budget_and_batch_cap():
    sched = DecodeBudgetScheduler(decode_budget=16, max_batch=8)
    q = _queue(4, 4, 4, 4, 4)
    batch, d = sched.admit(q)
    assert [r.rid for r in batch] == [0, 1, 2, 3]   # FIFO prefix
    assert d == 4 and len(batch) * d <= 16
    assert [r.rid for r in q] == [4]
    batch, d = DecodeBudgetScheduler(decode_budget=64, max_batch=2).admit(
        _queue(4, 4, 4))
    assert len(batch) == 2                          # max_batch binds first


def test_scheduler_buckets_decode_to_pow2():
    batch, d = DecodeBudgetScheduler(decode_budget=64, max_batch=4).admit(
        _queue(5, 3))
    assert d == 8 and len(batch) == 2


def test_scheduler_admits_oversized_request_alone_capped():
    sched = DecodeBudgetScheduler(decode_budget=8, max_batch=4)
    q = _queue(100, 2)
    batch, d = sched.admit(q)
    assert [r.rid for r in batch] == [0] and d == 8
    batch, d = sched.admit(q)
    assert [r.rid for r in batch] == [1] and d == 2


@pytest.mark.parametrize("budget,cap", [(8, 4), (64, 4), (256, 8), (5, 3)])
def test_scheduler_admissions_equal_the_reference(budget, cap):
    """The same queues through both schedulers: the same batches, the same
    decode steps, until the queues drain."""
    rng = np.random.default_rng(budget * 10 + cap)
    news = [int(x) for x in rng.integers(1, 70, size=40)]
    ours = DecodeBudgetScheduler(decode_budget=budget, max_batch=cap)
    theirs = jax_fleet.DecodeBudgetScheduler(decode_budget=budget,
                                             max_batch=cap)
    q = _queue(*news)
    jq = collections.deque(jax_fleet.Request(rid=i, tokens=np.zeros(4),
                                             max_new_tokens=m)
                           for i, m in enumerate(news))
    while q:
        (b, d), (jb, jd) = ours.admit(q), theirs.admit(jq)
        assert ([r.rid for r in b], d) == ([r.rid for r in jb], jd)
    assert not jq


def test_synthetic_requests_deterministic_and_the_references():
    a = fleet_lib.synthetic_requests(5, rate=10.0, seed=3)
    b = fleet_lib.synthetic_requests(5, rate=10.0, seed=3)
    assert all(np.array_equal(x.tokens, y.tokens) and
               x.arrival_s == y.arrival_s for x, y in zip(a, b))
    assert all(a[i].arrival_s < a[i + 1].arrival_s for i in range(4))
    ref = jax_fleet.synthetic_requests(5, rate=10.0, seed=3,
                                       vocab_size=49152, prompt_len=7)
    ours = fleet_lib.synthetic_requests(5, rate=10.0, seed=3,
                                        vocab_size=49152, prompt_len=7)
    assert all(np.array_equal(x.tokens, y.tokens) and
               x.arrival_s == y.arrival_s for x, y in zip(ours, ref))


# ---------------------------------------------------------------------------
# the fleet serves at lags
# ---------------------------------------------------------------------------

def test_fleet_serves_two_lagged_replicas(quant4_stream):
    """Two replicas on ONE wire at lags (0, 2): every request completes, each
    replica serves exactly its lag target's params, and the summary carries
    the latency/staleness schema."""
    fleet = fleet_lib.Fleet(quant4_stream["dir"], n_replicas=2, lags=(0, 2),
                            decode_budget=8, max_batch=2, prompt_len=8,
                            device="cpu")
    fleet.sync()
    assert [r.step for r in fleet.replicas] == [5, 3]
    for rep in fleet.replicas:
        assert _leaves_equal(rep.params, quant4_stream["snaps"][rep.step])
    reqs = fleet_lib.synthetic_requests(4, rate=50.0, prompt_len=8,
                                        max_new_tokens=4)
    out = fleet.run(reqs, sync_every=1)
    assert len(out["requests"]) == 4
    assert out["batches"] >= 2
    assert {r.replica for r in out["requests"]} == {"r0", "r1"}
    assert all(r.tokens_out is not None and r.latency_s >= 0
               for r in out["requests"])
    assert all(r.tokens_generated == r.max_new_tokens
               for r in out["requests"])
    assert out["short_requests"] == 0
    assert out["staleness_max"] <= 2
    assert out["p50_ms"] <= out["p99_ms"]


def test_fleet_rejects_mismatched_lags(quant4_stream):
    with pytest.raises(ValueError):
        fleet_lib.Fleet(quant4_stream["dir"], n_replicas=2, lags=(0,),
                        device="cpu")


# ---------------------------------------------------------------------------
# sync cadence + shortfall accounting (stubbed replicas)
# ---------------------------------------------------------------------------

class _FakeReplica:
    """Stand-in for ServeReplica with the surface Fleet.run drives. The
    fakes share one ``head`` emulating the trainer: it advances one step a
    completed round-robin ROUND."""

    def __init__(self, name, lag, head, n_replicas):
        self.name, self.lag, self.head = name, int(lag), head
        self._n = n_replicas
        self.step = max(head["v"] - self.lag, 0)
        self.sync_calls = 0

    def sync(self, upto=None):
        self.sync_calls += 1
        target = max(self.head["v"] - self.lag, 0)
        advanced = max(target - self.step, 0)
        self.step = max(self.step, target)
        return advanced

    def staleness(self):
        return max(self.head["v"] - self.step, 0)

    def serve_batch(self, batch, prompt_len, decode_steps,
                    sync_during_decode=False):
        self.head["served"] += 1
        if self.head["served"] % self._n == 0:
            self.head["v"] += 1                # one trainer step a round
        return {"tokens": np.zeros((len(batch), decode_steps + 1), np.int64),
                "mid_applied": 0}


def _fake_fleet(n_replicas, lags, head0=0, decode_budget=8, max_batch=1):
    fl = fleet_lib.Fleet.__new__(fleet_lib.Fleet)
    head = {"v": head0, "served": 0}
    fl.replicas = [_FakeReplica(f"r{i}", lags[i], head, n_replicas)
                   for i in range(n_replicas)]
    fl.scheduler = DecodeBudgetScheduler(decode_budget=decode_budget,
                                         max_batch=max_batch)
    fl.prompt_len = 8
    return fl


def test_every_replica_syncs_regression():
    fl = _fake_fleet(2, [0, 0])
    out = fl.run(fleet_lib.synthetic_requests(8, max_new_tokens=4),
                 sync_every=2)
    assert out["batches"] == 8
    for rep in fl.replicas:
        assert rep.sync_calls >= 2, (rep.name, rep.sync_calls)
    assert out["staleness_max"] <= 0 + 2       # lag + sync_every


@pytest.mark.parametrize("n_replicas", [1, 2, 3])
@pytest.mark.parametrize("sync_every", [1, 2, 3])
def test_staleness_bounded_for_every_replica(n_replicas, sync_every):
    lags = list(range(n_replicas))
    fl = _fake_fleet(n_replicas, lags, head0=4)
    out = fl.run(fleet_lib.synthetic_requests(6 * n_replicas,
                                              max_new_tokens=4),
                 sync_every=sync_every)
    assert len(out["requests"]) == 6 * n_replicas
    by_name = {rep.name: rep for rep in fl.replicas}
    for r in out["requests"]:
        rep = by_name[r.replica]
        assert r.staleness <= rep.lag + sync_every
    for rep in fl.replicas:
        assert rep.sync_calls >= 1, rep.name


def test_capped_request_surfaces_shortfall():
    sched = DecodeBudgetScheduler(decode_budget=8, max_batch=4)
    q = _queue(100, 2)
    batch, d = sched.admit(q)                  # rid 0 alone, capped at 8
    row = np.arange(d + 1)                     # prefill token + d decodes
    fleet_lib.finalize_request(batch[0], row)
    assert batch[0].tokens_generated == 9
    assert np.array_equal(batch[0].tokens_out, row)
    batch2, d2 = sched.admit(q)
    fleet_lib.finalize_request(batch2[0], np.arange(d2 + 1))
    assert batch2[0].tokens_generated == 2
    summary = fleet_lib._summary([batch[0], batch2[0]], batches=2)
    assert summary["short_requests"] == 1
    assert summary["tokens_short"] == 100 - 9


def test_run_summary_reports_capped_shortfall():
    fl = _fake_fleet(1, [0], decode_budget=8, max_batch=4)
    reqs = [Request(rid=0, tokens=np.zeros(4, np.int64), max_new_tokens=100),
            Request(rid=1, tokens=np.zeros(4, np.int64), max_new_tokens=4)]
    out = fl.run(reqs)
    assert out["short_requests"] == 1
    assert out["tokens_short"] == 100 - 9
    by_rid = {r.rid: r for r in out["requests"]}
    assert by_rid[0].tokens_generated == 9
    assert by_rid[1].tokens_generated == 4


# ---------------------------------------------------------------------------
# (d), (e): streams across the packages
# ---------------------------------------------------------------------------

def _ulps(got, want):
    """max |got − want| in f32 ulps of want's largest magnitude."""
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    return float(np.abs(got - want).max()
                 / np.spacing(np.float32(np.abs(want).max())))


def _hold(got, want, got_h, want_h, record, exact_params, dense_keys):
    """Returns the worst leaf in ulps after ``record`` records."""
    worst = 0.0
    for k in want:
        u = _ulps(got[k], want[k])
        worst = max(worst, u)
        assert u <= 2 * record, (k, record, u)
        if k in dense_keys:
            assert np.array_equal(np.asarray(got_h[k]),
                                  np.asarray(want_h[k])), k
            if exact_params:
                assert u == 0, (k, record, u)
    return worst


@pytest.mark.parametrize("opt", [{}, ADAMW], ids=["sgd", "adamw"])
def test_port_replica_joins_a_jax_published_stream(tmp_path, opt):
    """(d): the JAX trainer publishes 3 steps; a port ServeReplica joins
    from its bootstrap and lands on its post-step params after every
    record, within the module doc's bound."""
    js = jax_session.Session(jax_spec.RunSpec(**TINY, **CROSS, **opt))
    js.publish_to(str(tmp_path))
    snaps = {}
    for _ in range(3):
        js.step_once()
        snaps[js.step] = (ef_lib.flatten(jax.device_get(js.params)),
                          ef_lib.flatten(jax.device_get(js.ef_state["h"])))
    rep = _replica(str(tmp_path), bootstrap_step=0)
    dense = set(rep.legs[0].keys)
    assert rep.legs[0].carrier is None and all("norm" in k for k in dense)
    for step in (1, 2, 3):
        assert rep.sync(upto=step) == 1
        got = {k: v.numpy() for k, v in rep.params.items()}
        h = {k: v.numpy() for k, v in rep.sub.h.items()}
        _hold(got, snaps[step][0], h, snaps[step][1], step,
              exact_params=not opt, dense_keys=dense)


@pytest.mark.parametrize("opt", [{}, ADAMW], ids=["sgd", "adamw"])
def test_jax_subscriber_replays_a_port_published_stream(tmp_path, opt):
    """(e): the port publishes 3 steps (its bootstrap is the port's
    checkpoint); the reference's ServeReplica joins from it and its
    Subscriber lands on the port trainer's params after every record,
    within the module doc's bound."""
    sess, snaps = _publish_run(tmp_path, steps=3, **CROSS, **opt)
    hs = {}
    rep = jax_fleet.ServeReplica(str(tmp_path), bootstrap_step=0)
    dense = {k for k in snaps[1] if "norm" in k}
    for step in (1, 2, 3):
        assert rep.sync(upto=step) == 1
        got = ef_lib.flatten(jax.device_get(rep.params))
        h = ef_lib.flatten(jax.device_get(rep.sub.h))
        want = {k: v.numpy() for k, v in snaps[step].items()}
        hs = {k: stream_lib.WireLog(str(tmp_path)).read_step(step)[0]
              .payload[i].numpy() for i, k in enumerate(sorted(dense))}
        _hold(got, want, h, hs, step, exact_params=not opt,
              dense_keys=dense)
