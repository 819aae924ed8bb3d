"""The port's replica worker processes (src/repro_torch/launch/
replica_worker.py + ProcessFleet) against the reference's
tests/test_replica_worker.py, case for case, with the workers spawned on
the CPU (``--device cpu``): a worker process joins the wire via checkpoint
+ replay and its params digest-match the trainer's at every synced step,
survives kill-and-restart bit-identically, applies fresh records BETWEEN
decode steps, and a ProcessFleet completes every request even when a
worker is killed mid-run. Then (f): ``params_digest`` is the reference's on
one numpy tree, f32 and bfloat16. The workers run on one torch thread
(OMP_NUM_THREADS=1), as this file does."""
import threading

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.launch import replica_worker as jax_worker
from repro_torch.launch import fleet as fleet_lib
from repro_torch.launch import replica_worker as worker_lib
from repro_torch.launch.session import Session
from repro_torch.launch.spec import RunSpec
from test_torch_schedule import one_torch_thread  # noqa: F401 (autouse)
from test_torch_schedule import torch_threads

TINY = dict(arch="smollm-360m", smoke=True, clients=2, global_batch=4,
            seq_len=32)
QUANT4 = dict(compressor="block_topk", ratio=0.1,
              downlink_carrier="quant4", downlink_ratio=0.05)


@pytest.fixture(scope="module", autouse=True)
def one_thread_workers():
    mp = pytest.MonkeyPatch()
    mp.setenv("OMP_NUM_THREADS", "1")
    yield
    mp.undo()


def _digest_now(sess):
    return worker_lib.params_digest(sess.params)


@pytest.fixture(scope="module")
def wire(tmp_path_factory, one_thread_workers):
    """A quant4 stream with 3 published steps; the trainer stays alive so
    tests can extend the stream mid-decode."""
    root = tmp_path_factory.mktemp("wire_rw")
    with torch_threads(1):
        sess = Session(RunSpec(**TINY, **QUANT4), device="cpu")
        sess.publish_to(str(root), bootstrap_every=2)
        digests = {}
        for _ in range(3):
            sess.step_once()
            digests[sess.step] = _digest_now(sess)
    return {"dir": str(root), "sess": sess, "digests": digests}


@pytest.fixture(scope="module")
def worker(wire):
    w = worker_lib.WorkerHandle(wire["dir"], name="w0", lag=0,
                                bootstrap_step=0, prompt_len=8, device="cpu")
    w.wait_ready()
    yield w
    w.stop()


# ---------------------------------------------------------------------------
# digest — the cross-process identity check
# ---------------------------------------------------------------------------

def test_params_digest_is_bitwise():
    tree = {"a": torch.arange(6, dtype=torch.float32).reshape(2, 3),
            "b": torch.ones(4, dtype=torch.int32)}
    same = {k: v.clone() for k, v in tree.items()}
    assert worker_lib.params_digest(tree) == worker_lib.params_digest(same)
    flipped = {k: v.clone() for k, v in tree.items()}
    flipped["a"][1, 2] = torch.nextafter(flipped["a"][1, 2],
                                         torch.tensor(np.inf))  # one ulp
    assert worker_lib.params_digest(tree) != worker_lib.params_digest(flipped)
    recast = {"a": tree["a"].double(), "b": tree["b"]}
    assert worker_lib.params_digest(tree) != worker_lib.params_digest(recast)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_params_digest_equals_the_reference(dtype):
    """(f): one numpy tree, digested by both packages (the port's from
    tensors and from the numpy arrays themselves): equal."""
    rng = np.random.RandomState(3)
    tree = {"embed": rng.randn(5, 3), "layers/attn/wq": rng.randn(2, 3, 4),
            "final_norm": rng.randn(3)}
    if dtype == "float32":
        jtree = {k: v.astype(np.float32) for k, v in tree.items()}
        ptree = {k: torch.from_numpy(v) for k, v in jtree.items()}
    else:
        jtree = {k: np.asarray(jnp.asarray(v, jnp.bfloat16))
                 for k, v in tree.items()}
        ptree = {k: torch.from_numpy(v).bfloat16() for k, v in tree.items()}
        assert all(np.array_equal(jtree[k].view(np.int16),
                                  ptree[k].view(torch.int16).numpy())
                   for k in tree)
    want = jax_worker.params_digest(jtree)
    assert worker_lib.params_digest(ptree) == want
    if dtype == "float32":
        assert worker_lib.params_digest(jtree) == want


# ---------------------------------------------------------------------------
# one worker process: sync, digest, heartbeat, continuous sync
# ---------------------------------------------------------------------------

def test_worker_syncs_bit_identical_to_trainer(wire, worker):
    head = max(wire["digests"])
    r = worker.call({"cmd": "sync", "upto": head})
    assert r["step"] == head
    assert worker.call({"cmd": "digest"})["digest"] == wire["digests"][head]


def test_worker_heartbeats_and_reports_step(worker):
    worker.call({"cmd": "sync"})
    threading.Event().wait(0.6)                # > 2 heartbeat intervals
    assert worker.hb_age() < 5.0
    assert worker.step is not None


def test_worker_rejects_unknown_command(worker):
    with pytest.raises(RuntimeError, match="unknown cmd"):
        worker.call({"cmd": "frobnicate"})


def test_worker_continuous_sync_during_decode(wire, worker):
    """Publish fresh steps AFTER the worker synced, then serve with
    ``sync_during_decode``: the decode hook applies them mid-batch and the
    worker finishes ON the new head."""
    worker.call({"cmd": "sync"})
    sess = wire["sess"]
    with torch_threads(1):
        for _ in range(2):
            sess.step_once()
            wire["digests"][sess.step] = _digest_now(sess)
    head = sess.step
    r = worker.call({"cmd": "serve", "requests": [
        {"rid": 0, "tokens": list(range(8)), "max_new_tokens": 4},
        {"rid": 1, "tokens": [0, 7, 0], "max_new_tokens": 4}],
        "decode_steps": 4, "prompt_len": 8, "sync_during_decode": True})
    assert r["step"] == head
    assert r["mid_applied"] >= 1
    assert r["tokens_generated"] == [4, 4]
    assert all(len(t) == 4 for t in r["tokens"])
    assert worker.call({"cmd": "digest"})["digest"] == wire["digests"][head]


def test_worker_kill_and_restart_bit_identity(wire, worker):
    worker.call({"cmd": "sync"})
    before = worker.call({"cmd": "digest"})["digest"]
    assert before == wire["digests"][max(wire["digests"])]
    worker.kill()
    assert not worker.alive()
    worker.restart()
    worker.call({"cmd": "sync"})
    assert worker.call({"cmd": "digest"})["digest"] == before
    assert worker.restarts == 1


# ---------------------------------------------------------------------------
# the multi-process fleet
# ---------------------------------------------------------------------------

def test_process_fleet_serves_and_survives_kill(wire):
    """Two worker processes on one stream: every request completes across
    both; then a worker is killed mid-run — its in-flight batch is
    requeued, the worker restarts, every request STILL completes, and the
    restarted worker's digest is the trainer's at its step."""
    with fleet_lib.ProcessFleet(wire["dir"], n_workers=2, lags=(0, 2),
                                decode_budget=8, max_batch=2,
                                prompt_len=8, device="cpu") as fl:
        fl.sync()
        steps = [w.call({"cmd": "sync"})["step"] for w in fl.workers]
        assert steps[0] - steps[1] == 2        # lags honored
        reqs = fleet_lib.synthetic_requests(6, rate=50.0, prompt_len=8,
                                            max_new_tokens=4)
        out = fl.run(reqs)
        assert sorted(r.rid for r in out["requests"]) == list(range(6))
        assert {r.replica for r in out["requests"]} == {"w0", "w1"}
        assert out["restarts"] == 0
        assert out["short_requests"] == 0
        assert all(r.tokens_generated == 4 for r in out["requests"])
        assert out["p50_ms"] <= out["p99_ms"]

        killer = threading.Timer(0.2, fl.workers[1].kill)
        killer.start()
        reqs = fleet_lib.synthetic_requests(6, rate=20.0, prompt_len=8,
                                            max_new_tokens=4, seed=1)
        out = fl.run(reqs)
        killer.cancel()
        assert sorted(r.rid for r in out["requests"]) == list(range(6))
        assert out["restarts"] >= 1
        fl.sync()
        for w, d in zip(fl.workers, fl.digests()):
            assert d == wire["digests"][w.call({"cmd": "sync"})["step"]]
