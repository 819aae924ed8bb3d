"""The port's multi-process runtime on the CPU: launch/mesh.py's geometry
against the reference's, launch/multiproc.py (the ``DISTRIBUTED_OK`` CLI
on 2 processes, idempotent init), the RunSpec's meshes, and a Session of
one client a rank on 4 gloo ranks (spawned once for the module, with a
timeout of its own):

- 3 steps of results/specs/fused_quant8_overlap.json at smoke size (mesh
  pod: data 4, model 1) from the reference Session's initial state, loss
  and g_norm within rtol 1e-4 of the reference's Session on the smoke mesh
  with clients 4 (tests/test_torch_schedule.py's bar); the params, server g
  and h bit-identical on every rank after every step (a digest a rank);
- a run of quant8 under ``overlap`` killed after 2 steps and resumed to 4,
  bit for bit the uninterrupted run (tests/test_overlap.py:118), its
  checkpoint written once, with the keys, shapes and spec_hash of the
  single-device layout;
- ``serve`` on the 4 ranks (B dividing the data ranks, B not dividing
  them, ``prompt_lens``) equal to the port's single-device serve of the
  same params, with planted faults (the rows not split, the rows gathered
  out of order) caught; a spec whose head padding expands the kv heads
  refused by name, on one rank and on four;
- ``publish_to`` with a fused_quant4 downlink: a single-device replica
  joined from the 4-rank stream is bit for bit on the trainer's params;
  the training CLI with ``--coordinator`` and ``--publish-stream``.
"""
import dataclasses
import json
import os
import socket
import subprocess
import sys

import numpy as np
import pytest
import torch

from repro_torch.launch import mesh as mesh_lib
from repro_torch.launch import multiproc
from repro_torch.launch import shardings as sh
from repro_torch.launch import spec as pt_spec

ROOT = os.path.join(os.path.dirname(__file__), "..")
SRC = os.path.join(ROOT, "src")
SPECS = os.path.join(ROOT, "results", "specs")
N = 4
STEPS = 3


def shipped(name, **overrides):
    with open(os.path.join(SPECS, f"{name}.json")) as f:
        return dict(json.load(f), **overrides)


# the 4-rank Session: fused_quant8_overlap.json cut to smoke size
SESSION = shipped("fused_quant8_overlap", smoke=True, seq_len=32)
# the resumed run: the gathered quantized wire, so the ring carries it
RESUME = dict(pt_spec.RunSpec(smoke=True, seq_len=32, mesh="pod",
                              clients=N, carrier="quant8",
                              overlap=True).to_dict())
# serving on the 4 ranks: (B, prompt_lens), prompts of SERVE_S, SERVE_STEPS
# decode steps; B 8 gives each rank 2 rows, B 3 leaves every rank all rows
# and splits the cache's 20 slots over the 4 data ranks (the reference's
# layout, which needs the slots to divide: 16 + 3 would not)
SERVE_CASES = {"dividing": (8, None), "non-dividing": (3, None),
               "prompt_lens": (4, [5, 16, 9, 12])}
SERVE_S, SERVE_STEPS = 16, 4
# planted faults of the row split: each rank serves all rows into a cache
# of its block's size; the gathered rows put in reverse rank order
SERVE_FAULTS = ("rows-unsplit", "rows-reordered")
# publishing on the 4 ranks: fused_quant4 down, 2 steps
PUBLISH = dict(SESSION, downlink_carrier="fused_quant4")
PUBLISH_STEPS = 2
# the training CLI on the 4 ranks, publishing with a bootstrap every step
CLI_STEPS = 2


def serve_prompts(cfg_vocab, B):
    """The prompts of a serving case (the same in every process)."""
    return np.random.RandomState(B).randint(0, cfg_vocab, (B, SERVE_S))


def _padded(**fields):
    return pt_spec.RunSpec(**dict(dict(smoke=True, seq_len=32,
                                       tp_pad_heads=2), **fields))


# ---------------------------------------------------------------------------
# geometry and specs (no process group)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("world", range(1, 33))
def test_shrink_shape_is_the_reference_rule(world):
    """Both production shapes on 1–32 ranks. The model axis stays 1 on up
    to 16 ranks, and for two pods on every even world up to 32; an odd
    world above 16 drops the pod axis to 1 and can leave model > 1 (21, 25,
    27: refused at Session construction), and a prime above 16 is not
    filled (mesh construction fails, in both packages)."""
    from repro.launch import mesh as jax_mesh
    for shape in ((mesh_lib.PROD_DATA, mesh_lib.PROD_MODEL),
                  (mesh_lib.PROD_PODS, mesh_lib.PROD_DATA,
                   mesh_lib.PROD_MODEL)):
        got = mesh_lib._shrink_shape(shape, world)
        assert got == jax_mesh._shrink_shape(shape, world)
        assert world % int(np.prod(got)) == 0
        if world <= 16 or (len(shape) == 3 and world % 2 == 0):
            assert got[-1] == 1
    assert (mesh_lib.PROD_DATA, mesh_lib.PROD_MODEL, mesh_lib.PROD_PODS) \
        == (jax_mesh.PROD_DATA, jax_mesh.PROD_MODEL, jax_mesh.PROD_PODS)


def test_a_mesh_without_a_process_group_is_a_world_of_one():
    for mesh in (mesh_lib.make_smoke_mesh(),
                 mesh_lib.make_production_mesh(),
                 mesh_lib.make_production_mesh(multi_pod=True)):
        assert mesh.size == 1 and mesh.device_mesh is None
        axes = mesh.axes(mesh.client_axes())
        assert (axes.group, axes.size, axes.index) == (None, 1, 0)
    mp = mesh_lib.make_production_mesh(multi_pod=True)
    assert mp.client_axes() == ("pod", "data")
    assert mesh_lib.dp_size(mp) == 1


def test_mesh_coordinates_and_groups_are_pod_major():
    """Rank r of a (pod 2, data 2, model 1) mesh is client r; its pod group
    holds the ranks of its data index, its data group those of its pod."""
    for rank in range(4):
        mesh = mesh_lib.Mesh((2, 2, 1), ("pod", "data", "model"), None, rank)
        c = mesh.coordinate()
        assert (c["pod"], c["data"], c["model"]) == (rank // 2, rank % 2, 0)
        assert mesh.axes(("pod", "data")).index == rank
        assert mesh.axes(("data",)).index == rank % 2
        assert mesh.axes(("pod",)).index == rank // 2


def test_spec_loads_fused_quant8_overlap_with_the_reference_hash():
    from repro.launch import spec as jax_spec
    d = shipped("fused_quant8_overlap")
    spec = pt_spec.RunSpec.from_dict(d)
    assert (spec.mesh, spec.overlap, spec.shape) == ("pod", True, "train_4k")
    assert spec.spec_hash() == jax_spec.RunSpec.from_dict(d).spec_hash()
    js = jax_spec.RunSpec.from_dict(d)
    assert spec.n_clients_preview() == js.n_clients_preview() == 16
    assert pt_spec.RunSpec.from_json(spec.to_json()) == spec


@pytest.mark.parametrize("fields", [
    {"mesh": "multi_pod", "global_batch": 32}, {"shape": "train_4k"},
    {"mesh": "multi_pod", "global_batch": 32, "hops": {"pods": 2}},
])
def test_spec_takes_the_multi_pod_mesh_and_shape(fields):
    from repro.launch import spec as jax_spec
    spec = pt_spec.RunSpec(**fields)
    js = jax_spec.RunSpec(**fields)
    assert spec.spec_hash() == js.spec_hash()
    assert spec.n_clients_preview() == js.n_clients_preview()


@pytest.mark.parametrize("fields", [
    {"shape": "train_5k"}, {"mesh": "pod", "global_batch": 8},
    {"mesh": "pod", "hops": {"pods": 2}},
    {"mesh": "multi_pod", "global_batch": 32, "hops": {"pods": 4}},
    {"mesh": "torus"},
])
def test_spec_refuses_bad_meshes_as_the_reference(fields):
    from repro.launch import spec as jax_spec
    with pytest.raises(ValueError, match="invalid RunSpec"):
        pt_spec.RunSpec(**fields)
    with pytest.raises(ValueError):
        jax_spec.RunSpec(**fields)


def _on_four_ranks(monkeypatch, geometry):
    """Sessions built on a 4-rank mesh object of ``geometry`` (axes named
    pod-major) without a process group: enough for every refusal that
    comes before a collective."""
    names = ("pod", "data", "model")[-len(geometry):]
    monkeypatch.setattr(mesh_lib, "make_production_mesh",
                        lambda multi_pod=False: mesh_lib.Mesh(geometry,
                                                              names))


@pytest.mark.parametrize("fields,needs", [
    ({"state_sharding": "zero"}, "serve"),
    ({"client_granularity": "pod"}, "publish_to"),
])
def test_what_stays_refused_names_the_slice_that_brings_it(
        monkeypatch, tmp_path, fields, needs):
    """``serve`` and ``publish_to`` on more than one rank arrived with
    their slice (ROADMAP Queue 1 item 3): no rank refuses them as later
    work. What stays refused is serving a config whose head padding
    expands its kv heads, as the reference's serve fails there: named
    (the reference's TypeError, the standing fact), on a 4-rank mesh of
    either granularity, before any cache or training state is built; a
    publishing Session's serve too."""
    from repro_torch.launch.session import Session
    spec = _padded(**dict(fields, mesh="multi_pod", global_batch=32))
    _on_four_ranks(monkeypatch, (2, 2, 1))
    sess = Session(spec, device="cpu")
    assert sess.sharded and sess.n_clients == \
        (2 if spec.client_granularity == "pod" else 4)
    if needs == "publish_to":
        sess._publisher = object()       # as publish_to leaves it
    with pytest.raises(ValueError) as err:
        sess.serve(batch=2, prompt_len=8, decode_steps=1)
    msg = str(err.value)
    assert "tp_pad_heads=2" in msg and "TypeError: dynamic_update_slice" \
        in msg and "ROADMAP Queue 3" in msg
    assert "later slice" not in msg and sess._tr is None
    assert not hasattr(Session, "_refuse_sharded")


def test_serve_refuses_expanded_padding_on_one_rank_as_the_reference():
    """On one rank too: the reference's own serve of the padded smoke
    config fails with its TypeError, and the port's refuses it by name;
    padding that expands nothing (2 on granite's 4 q heads and 1 kv head
    expands them, 1 on smollm's expands nothing) serves as the unpadded
    config does."""
    from repro.launch import session as jax_session
    from repro.launch import spec as jax_spec
    from repro_torch.launch.session import Session
    with pytest.raises(TypeError, match="dynamic_update_slice"):
        jax_session.Session(jax_spec.RunSpec(
            smoke=True, seq_len=32, tp_pad_heads=2)).serve(
                batch=2, prompt_len=8, decode_steps=1)
    sess = Session(_padded(), device="cpu")
    with pytest.raises(ValueError, match="TypeError: dynamic_update_slice"):
        sess.serve(batch=2, prompt_len=8, decode_steps=1)
    one = Session(_padded(tp_pad_heads=1), device="cpu", dtype="float32")
    plain = Session(_padded(tp_pad_heads=0), device="cpu", dtype="float32")
    np.testing.assert_array_equal(
        one.serve(batch=2, prompt_len=8, decode_steps=2)["tokens"],
        plain.serve(batch=2, prompt_len=8, decode_steps=2)["tokens"])


@pytest.mark.parametrize("pad", [2, 16])
def test_spec_takes_tp_pad_heads_with_the_reference_hash(pad):
    """tp_pad_heads was refused until the 'model' axis: the spec now takes
    it (and its --tp-pad-heads flag) under the reference's spec_hash."""
    from repro.launch import spec as jax_spec
    spec = pt_spec.RunSpec(tp_pad_heads=pad, mesh="pod")
    assert spec.spec_hash() == jax_spec.RunSpec(
        tp_pad_heads=pad, mesh="pod").spec_hash()
    ap = pt_spec.argparse.ArgumentParser()
    pt_spec.add_flags(ap)
    assert pt_spec.from_args(ap.parse_args(
        ["--tp-pad-heads", str(pad), "--mesh", "pod"])) == spec


def test_the_zero_spec_stays_refused_naming_what_it_needs(monkeypatch):
    """quant4_multipod_zero.json and dryrun_sparse_pod.json load with the
    reference's hash. The zero spec's training state stays refused where
    the reference's round fails, a pod of more than one data rank (its
    production geometry, here (pod 2, data 2, model 1) on 4 ranks), naming
    the reference's TypeError and the standing fact; the Session itself
    builds."""
    from repro.launch import spec as jax_spec
    from repro_torch.launch.session import Session
    for name in ("dryrun_sparse_pod", "quant4_multipod_zero"):
        d = shipped(name)
        assert pt_spec.RunSpec.from_dict(d).spec_hash() == \
            jax_spec.RunSpec.from_dict(d).spec_hash()
    spec = pt_spec.RunSpec.from_dict(dict(
        shipped("quant4_multipod_zero"), smoke=True, seq_len=32,
        global_batch=8))
    _on_four_ranks(monkeypatch, (2, 2, 1))
    sess = Session(spec, device="cpu")
    with pytest.raises(ValueError) as err:
        sess.step_once()
    msg = str(err.value)
    assert "state_sharding='zero'" in msg
    assert "client_granularity='pod'" in msg
    assert "TypeError: add got incompatible shapes" in msg
    assert "ROADMAP Queue 3" in msg and sess._tr is None


@pytest.mark.parametrize("arch", ["smollm-360m", "olmoe-1b-7b",
                                  "falcon-mamba-7b", "zamba2-1.2b"])
def test_session_refuses_a_model_axis(monkeypatch, arch):
    """On a mesh whose 'model' axis exceeds 1 the Session builds the
    tensor-parallel pass of every family (the SSM families' d_inner split
    among them) and refuses what it cannot split: a Mamba2 whose d_inner
    splits and whose heads do not, by name."""
    from repro_torch.launch import session as pt_session
    monkeypatch.setattr(
        mesh_lib, "make_production_mesh",
        lambda multi_pod=False: mesh_lib.Mesh((2, 2), ("data", "model")))
    spec = pt_spec.RunSpec(smoke=True, mesh="pod", arch=arch)
    sess = pt_session.Session(spec, device="cpu")
    assert sess.tp is not None and sess.tp.axes.size == 2
    assert sess.pspecs["embed"] == ("model", None)
    assert sess.tp.d_inner == (arch in ("falcon-mamba-7b", "zamba2-1.2b"))
    if arch == "zamba2-1.2b":
        monkeypatch.setattr(
            mesh_lib, "make_production_mesh",
            lambda multi_pod=False: mesh_lib.Mesh((1, 16),
                                                  ("data", "model")))
        with pytest.raises(ValueError, match="'model' axis") as err:
            pt_session.Session(spec, device="cpu")
        assert "by whole heads" in str(err.value)


def test_train_cli_needs_all_three_process_flags():
    from repro_torch.launch import train
    with pytest.raises(SystemExit):
        train.main(["--coordinator", "localhost:1", "--smoke",
                    "--device", "cpu"])


# ---------------------------------------------------------------------------
# the fabric: 2 processes through the CLI
# ---------------------------------------------------------------------------

def _free_port():
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def test_multiproc_cli_prints_distributed_ok_on_two_processes():
    port = _free_port()
    env = dict(os.environ, PYTHONPATH=SRC, OMP_NUM_THREADS="1")
    procs = [subprocess.Popen(
        [sys.executable, "-m", "repro_torch.launch.multiproc",
         "--coordinator", f"localhost:{port}", "--num-processes", "2",
         "--process-id", str(i), "--backend", "gloo"],
        env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for i in range(2)]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=120)[0])
    finally:
        for p in procs:
            p.kill()
    for i, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, out
        assert f"DISTRIBUTED_OK process {i}/2 roster=[0, 1]" in out, out


# ---------------------------------------------------------------------------
# the 4-rank Session
# ---------------------------------------------------------------------------

def _rank_sessions(rank, ref_ckpt, workdir):
    """This rank's runs (module doc); returns what the tests compare."""
    from repro_torch.launch.session import Session
    out = {}
    key = next(iter(multiproc._INITIALIZED))
    out["init_again"] = multiproc.distributed_init(*key)
    try:
        multiproc.distributed_init("tcp://localhost:1", *key[1:])
        out["init_other"] = None
    except ValueError as e:
        out["init_other"] = str(e)

    sess = Session(pt_spec.RunSpec.from_dict(SESSION), device="cpu",
                   dtype="float32")
    out["mesh"], out["n"] = dict(sess.mesh.shape), sess.n_clients
    sess.restore_from(ref_ckpt, allow_spec_mismatch=True)
    out["trajectory"], out["digests"] = [], []
    for _ in range(STEPS):
        m = sess.step_once()
        out["trajectory"].append((float(m["loss"]), float(m["g_norm"])))
        out["digests"].append(sh.replicated_digest(sess.params,
                                                   sess.ef_state))
    out["serve_params"] = {k: v.numpy().copy()
                           for k, v in sess.params.items()}
    out["serve"] = _rank_serve(sess)
    padded = Session(pt_spec.RunSpec.from_dict(dict(SESSION, tp_pad_heads=2)),
                     device="cpu")
    try:
        padded.serve(batch=4, prompt_len=8, decode_steps=1)
        out["padded"] = None
    except ValueError as e:
        out["padded"] = str(e)
    out["publish"] = _rank_publish(workdir)

    spec = pt_spec.RunSpec.from_dict(RESUME)
    unint = Session(spec, device="cpu")
    unint.train(4, log_every=1)
    ckpt_dir = os.path.join(workdir, "ckpt")
    cut = Session(dataclasses.replace(spec, ckpt_dir=ckpt_dir), device="cpu")
    cut.train(2, log_every=0)
    del cut                                     # "kill" the process
    resumed = Session.resume(ckpt_dir, device="cpu")
    out["resumed"] = (resumed.step, resumed.spec.overlap,
                      resumed.spec.spec_hash())
    resumed.train(4, log_every=0)
    from repro_torch.core.ef import flatten
    a = flatten({"params": unint.params, "ef_state": unint.ef_state})
    b = flatten({"params": resumed.params, "ef_state": resumed.ef_state})
    out["resume_equal"] = sorted(a) == sorted(b) and all(
        torch.equal(a[k], b[k]) for k in a)
    out["resume_loss"] = [r["loss"] for r in unint.history]
    # last: the CLI leaves the world when it ends
    from repro_torch.launch import train
    train.main(["--spec", os.path.join(SPECS, "fused_quant8_overlap.json"),
                "--smoke", "--seq", "32", "--device", "cpu", "--steps",
                str(CLI_STEPS), "--log-every", "1", "--downlink-carrier",
                "fused_quant4", "--publish-stream",
                os.path.join(workdir, "cli_wire"), "--bootstrap-every", "1",
                "--coordinator", key[0], "--num-processes", str(N),
                "--process-id", str(rank)])
    return out


def _rank_serve(sess):
    """Each serving case on the 4 ranks, then each planted fault on the
    dividing case: the tokens, or what the fault raised."""
    from repro_torch.launch import session as pt_session
    out = {}
    vocab = sess.cfg.vocab_size
    for name, (B, lens) in SERVE_CASES.items():
        r = sess.serve(tokens=torch.tensor(serve_prompts(vocab, B)),
                       prompt_lens=lens, decode_steps=SERVE_STEPS)
        out[name] = {k: r[k] for k in ("tokens", "cache_bytes",
                                       "local_cache_bytes")}
    saved = pt_session.sh.local_rows, pt_session.sh.gather_rows
    faults = {"rows-unsplit": (lambda x, rows: x, saved[1]),
              "rows-reordered": (saved[0], lambda rows, x: saved[1](
                  rows, x).flip(0) if rows is not None else x)}
    B, _ = SERVE_CASES["dividing"]
    for name in SERVE_FAULTS:
        pt_session.sh.local_rows, pt_session.sh.gather_rows = faults[name]
        try:
            out[name] = sess.serve(
                tokens=torch.tensor(serve_prompts(vocab, B)),
                decode_steps=SERVE_STEPS)["tokens"]
        except Exception as e:
            out[name] = f"{type(e).__name__}: {e}"
        finally:
            pt_session.sh.local_rows, pt_session.sh.gather_rows = saved
    return out


def _rank_publish(workdir):
    """PUBLISH on the 4 ranks: publish_to, PUBLISH_STEPS steps; the params
    after them."""
    from repro_torch.launch.session import Session
    sess = Session(pt_spec.RunSpec.from_dict(PUBLISH), device="cpu")
    sess.publish_to(os.path.join(workdir, "wire"))
    for _ in range(PUBLISH_STEPS):
        sess.step_once()
    return {k: v.numpy().copy() for k, v in sess.params.items()}


@pytest.fixture(scope="module")
def sessions(tmp_path_factory):
    """The reference's smoke Session (f32, clients 4) saves its initial
    state and trains; then the 4 ranks run (``_rank_sessions``)."""
    from repro.launch import session as jax_session
    from repro.launch import spec as jax_spec
    tmp = tmp_path_factory.mktemp("sessions")
    jsess = jax_session.Session(jax_spec.RunSpec.from_dict(
        dict(SESSION, mesh="smoke", clients=N)))
    jsess.cfg = dataclasses.replace(jsess.cfg, dtype="float32")
    ckpt = jsess.save(str(tmp / "step_0.npz"))
    want = jsess.train(STEPS, log_every=1)
    ranks = multiproc.spawn(_rank_sessions, N, str(tmp / "mp"),
                            args=(ckpt, str(tmp)), timeout_s=360)
    return want, ranks, tmp


def test_distributed_init_is_idempotent_and_refuses_other_coordinates(
        sessions):
    _, ranks, _ = sessions
    for r in ranks:
        assert r["init_again"] is False
        assert "one world a process" in r["init_other"]


def test_four_rank_session_tracks_the_reference_session(sessions):
    want, ranks, _ = sessions
    for r in ranks:
        assert r["mesh"] == {"data": N, "model": 1} and r["n"] == N
        got = np.array(r["trajectory"])
        for i, key in enumerate(("loss", "g_norm")):
            np.testing.assert_allclose(got[:, i], [w[key] for w in want],
                                       rtol=1e-4, err_msg=key)
        # every rank reports the same all-reduced loss, bit for bit
        assert r["trajectory"] == ranks[0]["trajectory"]


def test_replicated_state_is_bit_identical_on_every_rank_every_step(
        sessions):
    _, ranks, _ = sessions
    for step in range(STEPS):
        assert len({r["digests"][step] for r in ranks}) == 1, step
    assert len(set(ranks[0]["digests"])) == STEPS      # the state moved


def test_serving_and_publishing_are_refused_on_several_ranks(sessions):
    """Neither is refused on 4 ranks any more: every rank served every
    case and published; what every rank refuses is the padded config's
    serve, by name (the reference's serve fails there on (data 4, model
    1) too)."""
    _, ranks, _ = sessions
    for r in ranks:
        assert sorted(r["serve"]) == sorted([*SERVE_CASES, *SERVE_FAULTS])
        assert r["publish"]
        assert "TypeError: dynamic_update_slice" in r["padded"]
        assert "later slice" not in r["padded"]


def _single_serve(params, B, lens):
    from repro_torch.launch.session import Session
    one = Session(pt_spec.RunSpec.from_dict(dict(SESSION, mesh="smoke",
                                                 clients=N)), device="cpu",
                  dtype="float32")
    one.set_serve_params({k: torch.tensor(v) for k, v in params.items()})
    return one.serve(tokens=torch.tensor(serve_prompts(one.cfg.vocab_size,
                                                       B)),
                     prompt_lens=lens, decode_steps=SERVE_STEPS)


@pytest.mark.parametrize("case", sorted(SERVE_CASES))
def test_four_rank_serve_equals_the_single_device_serve(sessions, case):
    """The trained 4-rank Session serves (data 4, model 1): B 8 gives each
    rank its 2 rows (their cache 2 rows), B 3 every rank all rows with a
    quarter of the cache's slots (the sequence split over 'data', the
    reference's layout: the decode merges the ranks' softmax sums), and
    ``prompt_lens`` travel with each rank's rows. Every rank returns the
    port's single-device serve of the same params and prompts, token for
    token, and its global cache_bytes; each rank holds a quarter of it."""
    _, ranks, _ = sessions
    B, lens = SERVE_CASES[case]
    want = _single_serve(ranks[0]["serve_params"], B, lens)
    for r in ranks:
        got = r["serve"][case]
        np.testing.assert_array_equal(got["tokens"], want["tokens"])
        assert got["cache_bytes"] == want["cache_bytes"]
        assert got["local_cache_bytes"] * N == want["cache_bytes"]


@pytest.mark.parametrize("fault", SERVE_FAULTS)
def test_four_rank_serve_planted_faults_are_caught(sessions, fault):
    """Planted: every rank serving all rows into a cache of its block's
    size fails, and rows gathered out of rank order differ from the
    single-device serve, so the test above catches each."""
    _, ranks, _ = sessions
    B, _ = SERVE_CASES["dividing"]
    want = _single_serve(ranks[0]["serve_params"], B, None)["tokens"]
    for r in ranks:
        got = r["serve"][fault]
        assert isinstance(got, str) or not np.array_equal(got, want), fault


def test_four_rank_stream_joins_a_single_device_replica_bit_for_bit(
        sessions):
    """fused_quant8 up and fused_quant4 down on the 4 ranks, published:
    the first rank wrote the step-0 bootstrap in the single-device layout
    and one record a step; a replica of one device (launch/fleet.py)
    joins from the stream and, synced, holds the trainer's params bit for
    bit."""
    from repro_torch.launch import fleet
    _, ranks, tmp = sessions
    wire = str(tmp / "wire")
    assert sorted(os.listdir(os.path.join(wire, "bootstrap"))) == \
        ["step_00000000.npz"]
    assert len(os.listdir(os.path.join(wire, "records"))) == PUBLISH_STEPS
    rep = fleet.ServeReplica(wire, device="cpu")
    rep.sync()
    assert rep.step == PUBLISH_STEPS
    want = ranks[0]["publish"]
    assert sorted(rep.params) == sorted(want)
    for k, v in rep.params.items():
        np.testing.assert_array_equal(v.numpy(), want[k], err_msg=k)
    for r in ranks[1:]:
        assert all(np.array_equal(r["publish"][k], want[k]) for k in want)


def test_train_cli_publishes_with_a_coordinator(sessions):
    """``python -m repro_torch.launch.train --coordinator … --publish-stream
    DIR --bootstrap-every 1`` on the 4 ranks: a bootstrap every step and
    one record a step, written once; a replica joins and syncs to the
    last step."""
    from repro_torch.launch import fleet
    _, _, tmp = sessions
    wire = str(tmp / "cli_wire")
    assert sorted(os.listdir(os.path.join(wire, "bootstrap"))) == \
        [f"step_{i:08d}.npz" for i in range(CLI_STEPS + 1)]
    assert len(os.listdir(os.path.join(wire, "records"))) == CLI_STEPS
    rep = fleet.ServeReplica(wire, device="cpu")
    rep.sync()
    assert rep.step == CLI_STEPS
    assert all(bool(torch.isfinite(v).all()) for v in rep.params.values())


def test_kill_and_resume_under_overlap_is_bit_for_bit(sessions):
    _, ranks, _ = sessions
    spec = pt_spec.RunSpec.from_dict(RESUME)
    for r in ranks:
        assert r["resumed"] == (2, True, spec.spec_hash())
        assert r["resume_equal"]


def test_sharded_checkpoint_has_the_single_device_layout(sessions, tmp_path):
    """The 4-rank run's checkpoint (written once, by rank 0) against a
    one-process Session of the same spec (mesh pod on one process: the
    single-device runtime with its 4 clients): keys, shapes, dtypes and
    spec_hash equal; its loss trajectory within rtol 1e-4."""
    from repro_torch.checkpoint import checkpoint as ckpt_lib
    from repro_torch.launch.session import Session
    _, ranks, tmp = sessions
    path = ckpt_lib.latest(str(tmp / "ckpt"))
    assert sorted(os.listdir(tmp / "ckpt")) == ["step_00000002.npz",
                                                "step_00000004.npz"]
    spec = pt_spec.RunSpec.from_dict(RESUME)
    one = Session(spec, device="cpu")
    assert not one.sharded and one.n_clients == N
    one.train(4, log_every=1)
    mine = one.save(str(tmp_path / "one.npz"))
    with np.load(path) as a, np.load(mine) as b:
        assert sorted(a.files) == sorted(b.files)
        for k in set(a.files) - {"__meta__"}:
            assert (a[k].shape, a[k].dtype) == (b[k].shape, b[k].dtype), k
    assert ckpt_lib.read_meta(path)["spec_hash"] == \
        ckpt_lib.read_meta(mine)["spec_hash"] == spec.spec_hash()
    np.testing.assert_allclose(ranks[0]["resume_loss"],
                               [r["loss"] for r in one.history], rtol=1e-4)
