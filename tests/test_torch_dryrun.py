"""The production-mesh dry run (``Session.lower``,
``launch/dryrun.py``, ``launch/trace_analysis.py``) against the reference.

- Per-rank bytes at full width on both production meshes: ONE reference
  subprocess (512 forced host devices; ``build_step``'s ShapeDtypeStructs
  and each leaf's ``NamedSharding.shard_shape``, nothing compiled) against
  the arguments the port's ``Session.lower`` traces (``build.build_step``
  at rank 0 of a fake world of 256 or 512 ranks) for all 10 archs x 4
  shapes: params, optimizer state, EF state, batch and cache equal leaf by
  leaf (by '/'-joined path) in shape, dtype and bytes. Two differences are
  stated and held exactly: a serving tree's matrices are the activation
  dtype (the port serves the tree ``model.cast_matrices`` casts once; the
  reference casts inside its jit), and a hybrid's conv state holds
  d_inner/n + 2N columns (its split in ``ssm.mamba2_apply``'s order) where
  the reference's holds (d_inner + 2N)/n. ``long_500k`` on the LONG_SKIP
  archs is SKIP. The reference's scalars ``rng``, ``step`` and ``pos``
  are host integers in the port.
- The cells that could not fit a card with whole slots, traced whole: ``dryrun_sparse_pod.json``'s
  rank (params 4,623,603,712 B, EF state 13,870,811,136 B, batch 524,288
  B), internvl2-76b ``decode_32k``'s cache 5,410,652,160 B and gemma2-9b
  ``long_500k``'s 355,074,048 B, ``quant4_multipod_zero``'s FAIL naming the
  reference's error.
- Collectives and launches: a traced step's collectives by kind (calls,
  operand bytes, group sizes) and its kernel launches equal a real 4-rank
  gloo run's of the same smoke spec at (data 2, model 2), rank by rank
  (on the CPU the wrappers run their plain versions, so the real run
  counts wrapper calls).
- FLOPs: a traced smoke train step on 4 ranks against the reference's
  ``hlo_analysis.analyze`` (dot + conv) of its compiled step on 4 forced
  devices, within FLOP_RTOL.
- The trace analysis itself: the counterparts of tests/test_hlo_analysis.py.
"""
import contextlib
import os
import pickle
import subprocess
import sys

import numpy as np
import pytest
import torch

from repro_torch.configs import base as cb
from repro_torch.core import comm
from repro_torch.kernels import ops
from repro_torch.launch import build as pt_build
from repro_torch.launch import dryrun
from repro_torch.launch import mesh as mesh_lib
from repro_torch.launch import multiproc
from repro_torch.launch import spec as pt_spec
from repro_torch.launch import trace_analysis as ta

from test_torch_schedule import one_torch_thread  # noqa: F401 (autouse)

HERE = os.path.dirname(os.path.abspath(__file__))
SRC = os.path.join(HERE, "..", "src")
SPECS = os.path.join(HERE, "..", "results", "specs")
MESHES = ("pod", "multi_pod")
CELLS = [(a, s) for a in sorted(cb.ARCH_ALIASES) for s in cb.INPUT_SHAPES
         if not (s == "long_500k" and cb.ARCH_ALIASES[a] in dryrun.LONG_SKIP)]
# the smoke specs held against the reference's compiled step
FLOP_ARCHS = ("smollm-360m", "olmoe-1b-7b", "zamba2-1.2b")
# the trace counts every dot of the step as PyTorch runs it, recompute
# included; the reference's analyzer counts the dots of the compiled HLO
# (the gaps each run reads are printed; PERF.md keeps them)
FLOP_RTOL = 0.05
# the production mesh shrunk onto 4 ranks, as both packages shrink it
FLOP_GEOM = {"data": 4, "model": 1}
# the collectives' smoke spec: the main path's carriers at (data 2, model 2)
COLL_SPEC = {"version": 5, "smoke": True, "seq_len": 32, "global_batch": 4,
             "mesh": "pod", "eta": 0.2, "carrier": "fused_quant8",
             "downlink_carrier": "fused_quant4",
             "compressor_kw": {"block": 32, "k_per_block": 4}}


# the spec's own training geometry must divide over the mesh's clients
# (32 on multi_pod; the default global batch 16 does not, and both
# packages refuse such a spec), so the specs give it the train shape's 256
SPEC_KW = {"compressor": "block_topk", "ratio": 0.01, "global_batch": 256}


def _spec(arch, shape, mesh):
    return pt_spec.RunSpec(arch=arch, shape=shape, mesh=mesh, **SPEC_KW)


# ---------------------------------------------------------------------------
# the reference, in one subprocess on 512 forced host devices
# ---------------------------------------------------------------------------

def _reference_main(out_path):
    """Run in the subprocess (XLA_FLAGS set before jax loads)."""
    import jax
    from jax.sharding import NamedSharding
    from repro.configs import base as jax_cb
    from repro.launch import build as jax_build
    from repro.launch import hlo_analysis
    from repro.launch import session as jax_session
    from repro.launch import spec as jax_spec

    def leaves(tree, mesh):
        out = {}
        for path, x in jax.tree_util.tree_flatten_with_path(tree)[0]:
            key = "/".join(str(getattr(p, "key", getattr(p, "idx", p)))
                           for p in path)
            shape = tuple(x.sharding.shard_shape(x.shape))
            out[key] = (shape, str(x.dtype),
                        int(np.prod(shape)) * x.dtype.itemsize)
        return out

    out = {"bytes": {}, "flops": {}}
    for mesh_name in MESHES:
        for arch, shape_name in CELLS:
            spec = jax_spec.RunSpec(arch=arch, shape=shape_name,
                                    mesh=mesh_name, **SPEC_KW)
            sess = jax_session.Session(spec)
            shape = jax_cb.INPUT_SHAPES[shape_name]
            with sess.mesh_context():
                if shape.kind == "train":
                    efc = jax_session.ef_config(spec, sess.mesh, sess.plan)
                    _, a = jax_build.build_step(
                        sess.cfg, shape, sess.mesh, sess.plan, efc,
                        optimizer_name=spec.optimizer, lr=spec.lr)
                    groups = dict(zip(("params", "opt_state", "ef_state",
                                       "batch"), a[:4]))
                elif shape.kind == "prefill":
                    _, a = jax_build.build_step(sess.cfg, shape, sess.mesh,
                                                sess.plan)
                    groups = dict(zip(("params", "batch", "cache"), a))
                else:
                    _, a = jax_build.build_step(sess.cfg, shape, sess.mesh,
                                                sess.plan)
                    groups = {"params": a[0], "cache": a[1],
                              "batch": {"tokens": a[2]}}
            out["bytes"][(mesh_name, arch, shape_name)] = {
                name: leaves(tree, sess.mesh) for name, tree in
                groups.items()}
    # the smoke train step on 4 of the devices, (data 4, model 1) as the
    # production mesh shrinks onto 4, compiled: dot + conv FLOPs
    from jax.sharding import Mesh
    mesh4 = Mesh(np.array(jax.devices()[:4]).reshape(4, 1), ("data", "model"))
    jax_spec.MESH_GEOM["pod"] = dict(FLOP_GEOM)
    for arch in FLOP_ARCHS:
        spec = jax_spec.RunSpec(arch=arch, smoke=True, seq_len=64,
                                global_batch=8, mesh="pod")
        sess = jax_session.Session(spec)
        sess.mesh = mesh4
        with sess.mesh_context():
            compiled = sess.lower(None).compile()
        hlo = hlo_analysis.analyze(compiled.as_text(), sess.mesh.size)
        out["flops"][arch] = {"flops": hlo["dot_flops"] + hlo["conv_flops"],
                              "mesh": dict(sess.mesh.shape)}
    with open(out_path, "wb") as f:
        pickle.dump(out, f)


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("dryrun")
    out = str(tmp / "reference.pkl")
    env = dict(os.environ, XLA_FLAGS="--xla_force_host_platform_device_count"
               "=512", JAX_PLATFORMS="cpu", OMP_NUM_THREADS="2",
               PYTHONPATH=os.pathsep.join([SRC, HERE]))
    proc = subprocess.run(
        [sys.executable, "-c", "import test_torch_dryrun as t; "
         f"t._reference_main({out!r})"], env=env, capture_output=True,
        text=True, timeout=900)
    assert proc.returncode == 0, (proc.stdout + proc.stderr)[-4000:]
    with open(out, "rb") as f:
        return pickle.load(f)


def _port_leaves(arch, shape_name, mesh):
    """The leaves the port's ``Session.lower`` traces at rank 0 of a fake
    world of the production mesh's size: ``build.build_step``'s
    arguments."""
    from repro_torch.launch.session import Session
    with dryrun.fake_world(dryrun.MESH_SIZE[mesh]):
        sess = Session(_spec(arch, shape_name, mesh), device="cpu")
        shape = cb.INPUT_SHAPES[shape_name]
        _, args, order = pt_build.build_step(sess, shape)
        return {name: ta.leaf_bytes(args[name]) for name in order}, \
            sess.cfg


@pytest.mark.parametrize("mesh", MESHES)
@pytest.mark.parametrize("arch", sorted(cb.ARCH_ALIASES))
def test_per_rank_bytes_are_the_reference_shards(reference, arch, mesh):
    """Every shape of ``arch`` on ``mesh``: each argument leaf of rank 0
    equal to the reference's per-device shard, by path (module doc for
    the two stated differences)."""
    shapes = [s for a, s in CELLS if a == arch]
    for shape_name in shapes:
        want = reference["bytes"][(mesh, arch, shape_name)]
        got, cfg = _port_leaves(arch, shape_name, mesh)
        kind = cb.INPUT_SHAPES[shape_name].kind
        assert sorted(got) == sorted(want), (shape_name, sorted(got))
        for group in got:
            g, w = got[group], want[group]
            if group == "opt_state":
                assert not g and not w
                continue
            assert sorted(g) == sorted(w), (shape_name, group)
            for path in g:
                gs, gd, gb = g[path]
                ws, wd, wb = w[path]
                where = (shape_name, group, path)
                if group == "cache" and path == "conv" \
                        and cfg.family == "hybrid":
                    tp = 16
                    di, two_n = cfg.d_inner, 2 * cfg.ssm_state
                    assert ws[-1] == (di + two_n) // tp, where
                    assert gs == (*ws[:-1], di // tp + two_n), where
                    continue
                assert gs == ws, where
                if group == "params" and kind != "train" and gd != wd:
                    # the served tree: matrices cast to the activation dtype
                    assert (wd, gd) == ("float32", cfg.dtype), where
                    assert gb * 4 == wb * 2, where
                    continue
                assert (gd, gb) == (wd, wb), where


def test_dryrun_sparse_pod_prints_ok_with_the_reference_figures(capsys):
    """``python -m repro_torch.launch.dryrun --arch gemma2-9b --shape
    train_4k --carrier sparse --compressor topk --ratio 0.01`` (the spec
    of results/specs/dryrun_sparse_pod.json) on (data 16, model 16)."""
    with pytest.raises(SystemExit) as done:
        dryrun.main(["--arch", "gemma2-9b", "--shape", "train_4k",
                     "--carrier", "sparse", "--compressor", "topk",
                     "--ratio", "0.01"])
    assert done.value.code == 0
    line = capsys.readouterr().out
    assert line.startswith("[OK  ] gemma2_9b")
    with open(os.path.join(SPECS, "dryrun_sparse_pod.json")) as f:
        spec = pt_spec.RunSpec.from_json(f.read())
    rec = dryrun.run_one("gemma2-9b", "train_4k", carrier="sparse",
                         compressor="topk", ratio=0.01)
    assert rec["spec_hash"] == spec.spec_hash()
    assert rec["status"] == "OK" and rec["n_devices"] == 256
    assert rec["arguments"] == {"params": 4_623_603_712, "opt_state": 0,
                                "ef_state": 13_870_811_136,
                                "batch": 524_288}
    assert rec["memory"]["argument_bytes"] == sum(rec["arguments"].values())
    assert rec["flops"] > 0 and rec["memory"]["temp_bytes"] > 0
    # the sparse wire gathers each client's (values, indices) over 'data'
    assert rec["collective_counts"]["all-gather"] > 0
    assert rec["kernel_launches"] == {}


@pytest.mark.parametrize("arch,shape,cache", [
    ("internvl2-76b", "decode_32k", 5_410_652_160),
    ("gemma2-9b", "long_500k", 355_074_048)])
def test_sequence_split_caches_are_the_reference_shards(arch, shape, cache):
    """The two cells a rank could not hold with whole slots (86.6 and 90.9
    GB): the cache's sequence splits over 'model' (internvl2's 8 kv heads
    on 16 ranks) or, at B 1, over every rank with the kv heads split
    (gemma2: 'data' alone)."""
    rec = dryrun.run_one(arch, shape)
    assert rec["status"] == "OK", rec.get("error")
    assert rec["arguments"]["cache"] == cache
    # a decode step merges the ranks' softmax partials: 3 all-reduces a
    # layer over the sequence axes
    assert rec["collective_counts"]["all-reduce"] >= 3


def test_long_500k_skips_and_the_zero_spec_fails_as_the_reference():
    for mod in sorted(dryrun.LONG_SKIP):
        arch = next(a for a, m in cb.ARCH_ALIASES.items() if m == mod)
        rec = dryrun.run_one(arch, "long_500k")
        assert rec["status"] == "SKIP"
        assert rec["reason"] == dryrun.LONG_SKIP[mod]
    with open(os.path.join(SPECS, "quant4_multipod_zero.json")) as f:
        spec = pt_spec.RunSpec.from_json(f.read())
    kw = dict(mesh=spec.mesh, carrier=spec.carrier,
              compressor=spec.compressor, ratio=spec.ratio,
              granularity=spec.client_granularity,
              state_sharding=spec.state_sharding,
              ef_state_dtype=spec.ef_state_dtype)
    rec = dryrun.run_one(spec.arch, spec.shape, **kw)
    assert rec["spec_hash"] == spec.spec_hash()
    assert rec["status"] == "FAIL" and rec["multi_pod"]
    assert rec["error"].startswith("ValueError")
    assert "TypeError: add got incompatible shapes for broadcasting" \
        in rec["error"]
    # serving the same spec is not refused
    rec = dryrun.run_one(spec.arch, "decode_32k", **kw)
    assert rec["status"] == "OK", rec.get("error")


def test_the_world_is_left_as_it_was():
    import torch.distributed as dist
    assert not dist.is_initialized()
    with dryrun.fake_world(8, 3):
        assert dist.get_world_size() == 8 and dist.get_rank() == 3
        with pytest.raises(RuntimeError, match="already initialized"):
            with dryrun.fake_world(8):
                pass
    assert not dist.is_initialized()


def test_cli_all_writes_every_cell(tmp_path, monkeypatch):
    """``--all --out``: one record a cell, OK or SKIP (traced here at
    smoke-free full width would take minutes: the cells run through a
    stand-in that keeps the CLI's loop, lines and file)."""
    seen = []

    def one(arch, shape, **kw):
        seen.append((arch, shape))
        return {"arch": arch, "shape": shape, "status": "SKIP",
                "reason": "stand-in"}
    monkeypatch.setattr(dryrun, "run_one", one)
    out = tmp_path / "all.json"
    with pytest.raises(SystemExit) as done:
        dryrun.main(["--all", "--out", str(out)])
    assert done.value.code == 0
    assert seen == [(a, s) for a in cb.ARCH_ALIASES for s in cb.INPUT_SHAPES]
    import json
    assert len(json.loads(out.read_text())) == 40


# ---------------------------------------------------------------------------
# collectives and launches: a traced step against a real 4-rank run
# ---------------------------------------------------------------------------

@contextlib.contextmanager
def _narrowed(geom=(("data", 2), ("model", 2))):
    """The production geometry narrowed to ``geom`` (by default (data 2,
    model 2), as tests/test_torch_tensor_parallel.py narrows it); put back
    after."""
    geom = dict(geom)
    old = mesh_lib.PROD_DATA, dict(pt_spec.MESH_GEOM["pod"])
    mesh_lib.PROD_DATA = geom["data"]
    pt_spec.MESH_GEOM["pod"] = geom
    try:
        yield
    finally:
        mesh_lib.PROD_DATA = old[0]
        pt_spec.MESH_GEOM["pod"] = old[1]


WRAPPERS = tuple(ops.launches)


@contextlib.contextmanager
def _calls():
    """Count each kernel wrapper's calls (on the CPU the wrappers run
    their plain versions, which ``ops.launches`` does not count)."""
    count = dict.fromkeys(WRAPPERS, 0)
    orig = {n: getattr(ops, n) for n in WRAPPERS}

    def counted(name):
        def run(*a, **k):
            count[name] += 1
            return orig[name](*a, **k)
        return run
    for n in WRAPPERS:
        setattr(ops, n, counted(n))
    try:
        yield count
    finally:
        for n in WRAPPERS:
            setattr(ops, n, orig[n])


def _kinds():
    return {k: {"calls": v["calls"], "bytes": v["bytes"],
                "groups": dict(v["groups"])} for k, v in comm.KINDS.items()}


def _rank_real(rank):
    """One real step of COLL_SPEC on this gloo rank (after the batch-0
    pass that builds the EF state): its collectives and wrapper calls."""
    from repro_torch.launch.session import Session
    with _narrowed():
        sess = Session(pt_spec.RunSpec.from_dict(COLL_SPEC), device="cpu")
        sess._ensure_train()
        comm.reset_stats()
        with _calls() as calls:
            sess.step_once()
        return {"kinds": _kinds(), "calls": {k: v for k, v in calls.items()
                                             if v},
                "coord": sess.mesh.coordinate()}


@pytest.fixture(scope="module")
def real_world(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("coll")
    return multiproc.spawn(_rank_real, 4, str(tmp / "mp"), timeout_s=300)


def _traced(rank):
    from repro_torch.launch.session import Session
    with _narrowed(), dryrun.fake_world(4, rank):
        sess = Session(pt_spec.RunSpec.from_dict(COLL_SPEC), device="cpu")
        return sess.lower(None), sess.mesh.coordinate()


@pytest.mark.parametrize("rank", range(4))
def test_traced_collectives_and_launches_equal_a_real_run(real_world, rank):
    got, coord = _traced(rank)
    real = real_world[rank]
    assert coord == real["coord"]
    kinds = {k: {"calls": got["collective_counts"][k],
                 "bytes": got["collectives"][k],
                 "groups": got["collective_groups"][k]}
             for k in got["collectives"]}
    assert kinds == real["kinds"]
    assert got["collective_bytes"] == sum(v["bytes"]
                                          for v in real["kinds"].values())
    assert got["kernel_launches"] == real["calls"]
    # the main path's kernels: K3 up, K4 down, K6 decoding the gathered wire
    assert {"ef21_sgdm_topk_quant", "dequant_add"} <= set(real["calls"])


# ---------------------------------------------------------------------------
# FLOPs against the reference's analyzer
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", FLOP_ARCHS)
def test_flops_match_the_reference_analyzer(reference, arch):
    from repro_torch.launch.session import Session
    want = reference["flops"][arch]
    with _narrowed(FLOP_GEOM.items()), dryrun.fake_world(4):
        spec = pt_spec.RunSpec(arch=arch, smoke=True, seq_len=64,
                               global_batch=8, mesh="pod")
        sess = Session(spec, device="cpu")
        assert dict(sess.mesh.shape) == want["mesh"]
        got = sess.lower(None)
    print(f"{arch}: traced {got['flops']:.0f} FLOPs a rank, the "
          f"reference's analyzer {want['flops']:.0f} "
          f"({got['flops'] / want['flops'] - 1:+.4f})")
    assert got["flops"] == pytest.approx(want["flops"], rel=FLOP_RTOL)


# ---------------------------------------------------------------------------
# the trace analysis (tests/test_hlo_analysis.py's cases)
# ---------------------------------------------------------------------------

def _analyze(fn, **args):
    return ta.analyze(fn, args, 1, tuple(args))


def _meta(*shape, dtype=torch.float32):
    return torch.empty(shape, dtype=dtype, device="meta")


def test_loop_free_matmul_flops():
    r = _analyze(lambda a, b: a @ b, a=_meta(256, 512), b=_meta(512, 128))
    assert r["flops"] == 2 * 256 * 512 * 128


def test_loop_bodies_count_every_trip():
    def f(x):
        for _ in range(10):
            x = x @ x
        return x
    assert _analyze(f, x=_meta(128, 128))["flops"] == 10 * 2 * 128 ** 3


def test_nested_loops():
    def f(x):
        for _ in range(4):
            for _ in range(3):
                x = x @ x
        return x
    assert _analyze(f, x=_meta(64, 64))["flops"] == 12 * 2 * 64 ** 3


def test_batched_dot_flops():
    r = _analyze(lambda a, b: torch.einsum("bij,bjk->bik", a, b),
                 a=_meta(8, 64, 32), b=_meta(8, 32, 16))
    assert r["flops"] == 2 * 8 * 64 * 32 * 16


def test_leaf_bytes():
    tree = {"a": _meta(2, 3), "b": {"c": _meta(10, dtype=torch.bfloat16),
                                    "d": _meta(4, dtype=torch.int8)}}
    assert ta.leaf_bytes(tree) == {"a": ((2, 3), "float32", 24),
                                   "b/c": ((10,), "bfloat16", 20),
                                   "b/d": ((4,), "int8", 4)}


def test_memory_counts_storages_not_tensors():
    """A view allocates nothing, a freed temporary leaves the peak, an
    in-place write to an argument is an alias, a new result an output."""
    def f(x, state):
        t = x * 2                     # 4 KB, freed below
        v = t[:10]                    # a view: nothing
        del t, v
        u = x + 1                     # 4 KB, returned
        state.add_(1.0)               # in place: an alias of the argument
        return u, state
    r = _analyze(f, x=_meta(1024), state=_meta(256))
    mem = r["memory"]
    assert mem["argument_bytes"] == 4096 + 1024
    assert mem["temp_bytes"] == 4096          # t, then u: one at a time
    assert mem["output_bytes"] == 4096
    assert mem["alias_bytes"] == 1024
    assert r["arguments"] == {"x": 4096, "state": 1024}


def test_traced_kernels_allocate_the_card_outputs_and_count():
    """A meta input takes each wrapper's traced branch: the card's output
    shapes, one traced launch counted (in ``ops.traced_launches``, never
    in ``ops.launches``, which counts the card's alone), no plain version
    run (K7's FLOPs added); real CPU tensors still run the plain version,
    uncounted."""
    before = dict(ops.launches)
    grad, v, g = _meta(6, 32), _meta(6, 32), _meta(6, 32)

    def f(grad, v, g):
        return ops.ef21_sgdm_topk_quant(grad, v, g, eta=0.2, k=4, bits=4)
    r = _analyze(f, grad=grad, v=v, g=g)
    assert r["kernel_launches"] == {"ef21_sgdm_topk_quant": 1}
    # v', g' (6 x 32 f32 each), q (6 x 16 uint8), scales (6 f32)
    assert r["memory"]["output_bytes"] == 2 * 768 + 96 + 24
    q = _meta(2, 16, 4, 64, dtype=torch.bfloat16)
    k = _meta(2, 16, 2, 64, dtype=torch.bfloat16)
    r = _analyze(lambda q, k: ops.flash_attention(q, k, k), q=q, k=k)
    assert r["kernel_launches"] == {"flash_attention": 1}
    assert r["flops"] == 4 * 2 * 4 * 64 * (16 * 17 // 2)
    assert ops.traced_launches["flash_attention"] == 1
    x = torch.randn(64)
    ops.block_topk(x, block=32, k=4)
    assert ops.traced_launches["block_topk"] == 0
    assert ops.launches == before
