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
- ``serve`` and ``publish_to`` refused on more than one rank.
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
    """Client granularity 'pod' and state sharding 'zero' were refused at
    construction until their slice; the spec now takes them, and what
    stays refused on more than one rank, ``serve`` and ``publish_to``,
    names the slice that brings it (ROADMAP Queue 1 item 3)."""
    from repro_torch.launch.session import Session
    spec = pt_spec.RunSpec(**dict(fields, mesh="multi_pod", smoke=True,
                                  global_batch=32, seq_len=32))
    _on_four_ranks(monkeypatch, (2, 2, 1))
    sess = Session(spec, device="cpu")
    assert sess.sharded and sess.n_clients == \
        (2 if spec.client_granularity == "pod" else 4)
    with pytest.raises(ValueError, match="ROADMAP Queue 1 item 3"):
        if needs == "serve":
            sess.serve(batch=2, prompt_len=8, decode_steps=1)
        else:
            sess.publish_to(str(tmp_path / "wire"))


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
    for what, fn in (("serve", lambda: sess.serve(batch=1, prompt_len=4,
                                                  decode_steps=1)),
                     ("publish_to", lambda: sess.publish_to(
                         os.path.join(workdir, "wire")))):
        try:
            fn()
            out[what] = None
        except ValueError as e:
            out[what] = str(e)

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
    return out


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
                            args=(ckpt, str(tmp)), timeout_s=240)
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
    _, ranks, _ = sessions
    for r in ranks:
        for what in ("serve", "publish_to"):
            assert r[what] is not None and "later slice" in r[what]


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
