"""The port's sharded round (repro_torch.core.distributed.ef_round_sharded:
one client a rank, every aggregation a torch.distributed collective) on 4
gloo CPU ranks, against the port's single-device round (``ef_round``, the
clients emulated on one device) and the reference's vmap round
(repro.core.distributed.ef_round, jitted), on the same numpy inputs.

The ranks are spawned once for the module (``multiproc.spawn``: a
``file://`` store, one torch thread a rank, a timeout of its own) and run
every case; the tests read their results. Bars: floats within the
reference's own bar for its sharded round against its vmap one (rtol 1e-5,
atol 1e-7; the all-reduce sums in another order than the vmap round's
mean), the clients' EF state bit for bit against the port's single-device
round (a client's update reads only its own rows), integer wire outputs
(mantissas, scales, indices) exactly. ``overlap`` (the ring) is bit for
bit the blocking gather. Cases mirror tests/test_multidevice.py: the seven
carriers with ef21_sgdm and BlockTopK, HardThreshold on the quantized
wires, the downlink grid, the Abs method's message on the dense plan, plus
a two-group schedule, sampled participation (the frozen clients bit for
bit), hops on (pod 2, data 2) with a trivial and a quant4 cross hop, and
RandK on the dense plan with EF21-SGDM and with NEOLITHIC's rounds (client
i draws the single-device round's stream of client i). The rounds run at η = 0.5,
where both packages' momentum products are exact.
"""
import dataclasses

import numpy as np
import pytest
import torch

from repro_torch.core import comm
from repro_torch.core import distributed as pt_dist
from repro_torch.core import ef as pt_ef
from repro_torch.core import rng as rng_lib
from repro_torch.launch import build as pt_build
from repro_torch.launch import mesh as mesh_lib
from repro_torch.launch import multiproc
from repro_torch.launch import spec as pt_spec

N = 4
SHAPES = {"embed": (32, 8), "layers/w": (2, 16, 8), "norm": (8,)}
BTK = {"compressor": "block_topk",
       "compressor_kw": {"block": 8, "k_per_block": 2}}
HT = {"compressor": "hard_threshold", "compressor_kw": {"lam": 0.05}}
BASE = {"version": 5, "smoke": True, "seq_len": 32, "eta": 0.5,
        "mesh": "pod", **BTK}
RTOL, ATOL = 1e-5, 1e-7


def _case(steps=1, **fields):
    return {"spec": dict(BASE, **fields), "steps": steps}


CASES = {
    **{f"carrier-{c}": _case(carrier=c)
       for c in ("dense", "sparse", "fused", "quant8", "quant4",
                 "fused_quant8", "fused_quant4")},
    **{f"ht-{c}": _case(carrier=c, **HT) for c in ("quant8", "quant4")},
    # the reference's downlink grid (tests/test_multidevice.py)
    "down-ef21_sgdm-dense-quant4": _case(carrier="dense",
                                         downlink_carrier="quant4"),
    "down-ef21_sgdm-sparse-quant8": _case(carrier="sparse",
                                          downlink_carrier="quant8"),
    "down-ef21_sgdm-quant4-sparse": _case(carrier="quant4",
                                          downlink_carrier="sparse"),
    "down-ef21_sgd-fused-quant4": _case(method="ef21_sgd", carrier="fused",
                                        downlink_carrier="quant4"),
    "down-ef14_sgd-dense-sparse": _case(method="ef14_sgd", carrier="dense",
                                        downlink_carrier="sparse"),
    "groups": _case(groups=[
        {"pattern": "norm", "carrier": "dense"},
        {"pattern": "embed", "carrier": "sparse",
         "downlink_carrier": "quant8"},
        {"pattern": "*", "carrier": "fused_quant8"}]),
    **{f"sampled-{c}": _case(steps=2, carrier=c, participation={
        "mode": "sampled", "fraction": 0.5, "seed": 7})
       for c in ("dense", "fused", "quant8")},
    "hops-trivial": _case(mesh="multi_pod", global_batch=32,
                          carrier="quant8", hops={"pods": 2}),
    "hops-quant4": _case(mesh="multi_pod", global_batch=32, carrier="quant8",
                         hops={"pods": 2, "cross_carrier": "quant4",
                               "cross_ratio": 0.25}),
    "randk-dense": _case(carrier="dense", compressor="randk",
                         compressor_kw={}, ratio=0.25),
    # the dense plan runs method.update: a method that ships a transform
    # of c (Abs: γ·c) and one of R rounds, each on its own stream
    "abs-ht-dense": _case(method="ef21_sgdm_abs", carrier="dense",
                          method_kw={"gamma": 0.1},
                          compressor="hard_threshold",
                          compressor_kw={"lam": 1e-3}),
    "neolithic-randk": _case(method="neolithic", carrier="dense",
                             compressor="randk", compressor_kw={},
                             ratio=0.25),
}
# the gather-wire carriers run again under overlap: the ring's bits
OVERLAP = ["carrier-sparse", "carrier-quant8", "carrier-quant4", "groups",
           "sampled-quant8", "hops-quant4"]
# wires checked exactly, gathered against the single-device encode
WIRES = {"sparse": BTK, "quant8": BTK, "quant4": BTK, "fused_quant8": BTK,
         "quant8-ht": HT}


def numpy_inputs(seed):
    rng = np.random.RandomState(seed)

    def tree(lead=()):
        return {k: rng.randn(*lead, *s).astype(np.float32)
                for k, s in SHAPES.items()}
    return tree(), tree((N,)), [tree((N,)) for _ in range(2)]


def _seed(name):
    return sum(map(ord, name)) % 1000


def _tensors(tree, rows=None):
    return {k: torch.tensor(v if rows is None else v[rows])
            for k, v in tree.items()}


def _flat(tree):
    return {k: v.float().numpy().copy() for k, v in pt_ef.flatten(tree).items()}


def _vmap_spec(d):
    return dict(d, mesh="smoke", clients=N)


_MESHES = {}


def _mesh(name):
    """One mesh a geometry for the rank's whole run (a DeviceMesh builds
    its groups collectively)."""
    if name not in _MESHES:
        _MESHES[name] = mesh_lib.make_production_mesh(
            multi_pod=name == "multi_pod")
    return _MESHES[name]


def _run_sharded(rank, name, overlap):
    """One case on this rank: its client's rows of the inputs, the initial
    state, then the round ``steps`` times; each record flattened."""
    case = CASES[name]
    spec = pt_spec.RunSpec.from_dict(dict(case["spec"], overlap=overlap))
    mesh = _mesh(spec.mesh)
    efc = pt_build.ef_config(spec, N, client_axes=mesh.client_axes())
    client = mesh.axes(mesh.client_axes()).index
    params, g0, grads = numpy_inputs(_seed(name))
    state = pt_dist.init_ef_state_sharded(
        efc, _tensors(params), mesh,
        init_grads=_tensors(g0, slice(client, client + 1)))
    out = [{p: _flat(v) for p, v in state.items()}]
    for step in range(case["steps"]):
        est, state = pt_dist.ef_round_sharded(
            efc, _tensors(grads[step], slice(client, client + 1)), state,
            mesh, step=step, rng=rng_lib.round_generator(3, step),
            overlap=spec.overlap)
        out.append({"g_est": _flat(est),
                    **{p: _flat(v) for p, v in state.items()}})
    return out


def _wires(rank):
    """Each wire carrier's encode of this rank's row, gathered (the
    blocking gather and the ring): the clients' stacked wires."""
    from repro_torch.core import carriers as carrier_lib
    axes = _mesh("pod").axes(("data",))
    _, g0, _ = numpy_inputs(11)
    x = torch.tensor(g0["embed"][rank].reshape(1, -1))
    out = {}
    for name, comp_kw in WIRES.items():
        comp = pt_build._build_compressor(comp_kw["compressor"],
                                          comp_kw["compressor_kw"], 0.05)
        car = carrier_lib.make(name.split("-")[0])
        wire = car.encode(comp, x)
        for overlap in (False, True):
            got = dataclasses.replace(car, overlap=overlap)._gather(
                tuple(wire), axes)
            out[(name, overlap)] = [t.numpy().copy() for t in got]
    return out


def _rank_work(rank):
    """Everything this rank computes for the module."""
    res = {name: _run_sharded(rank, name, False) for name in CASES}
    for name in OVERLAP:
        res[name + "/overlap"] = _run_sharded(rank, name, True)
    res["wires"] = _wires(rank)
    axes = _mesh("pod").axes(("data",))
    comm.reset_stats()
    x = torch.arange(6, dtype=torch.float32) + rank
    res["ring"] = [t.numpy() for t in comm.ring_all_gather(
        axes, (x, x.to(torch.int16)), lambda c: (c[0] * 2, c[1]))]
    res["sum"] = comm.all_reduce_sum(axes, x).numpy()
    res["stats"] = dict(comm.STATS)
    return res


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    return multiproc.spawn(_rank_work, N, str(tmp_path_factory.mktemp("mp")),
                           timeout_s=240)


def _vmap(name, overlap=False):
    """The port's single-device round on the same inputs."""
    case = CASES[name]
    spec = pt_spec.RunSpec.from_dict(_vmap_spec(case["spec"]))
    efc = pt_build.ef_config(spec)
    params, g0, grads = numpy_inputs(_seed(name))
    state = pt_dist.init_ef_state(efc, _tensors(params), N,
                                  init_grads=_tensors(g0))
    out = [{p: _flat(v) for p, v in state.items()}]
    for step in range(case["steps"]):
        est, state = pt_dist.ef_round(efc, _tensors(grads[step]), state,
                                      step=step,
                                      rng=rng_lib.round_generator(3, step))
        out.append({"g_est": _flat(est),
                    **{p: _flat(v) for p, v in state.items()}})
    return out


def _assemble(ranks, key):
    """The ranks' results as the single-device layout: client leaves
    stacked in rank order, each pod's slot from its first rank, the
    replicated parts from rank 0 (checked equal on every rank)."""
    steps = []
    for s in range(len(ranks[0][key])):
        per = [r[key][s] for r in ranks]
        out = {}
        for part in per[0]:
            if part == "clients":
                out[part] = {k: np.concatenate([p[part][k] for p in per])
                             for k in per[0][part]}
            elif part == "pods":
                pods = [per[i][part] for i in range(0, N, N // 2)]
                out[part] = {k: np.concatenate([p[k] for p in pods])
                             for k in per[0][part]}
            else:
                for p in per[1:]:
                    for k in per[0][part]:
                        np.testing.assert_array_equal(
                            p[part][k], per[0][part][k],
                            err_msg=f"{key} step {s} {part}/{k} replicated")
                out[part] = per[0][part]
        steps.append(out)
    return steps


def _close(got, want, what):
    assert sorted(got) == sorted(want), what
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=RTOL, atol=ATOL,
                                   err_msg=f"{what}/{k}")


def _equal(got, want, what):
    assert sorted(got) == sorted(want), what
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=f"{what}/{k}")


@pytest.mark.parametrize("name", sorted(CASES))
def test_sharded_round_matches_the_single_device_round(ranks, name):
    """From the initial state on: replicated parts equal on every rank;
    the clients' state bit for bit; g_est, server, h and pods within the
    bar."""
    got, want = _assemble(ranks, name), _vmap(name)
    assert len(got) == len(want) == CASES[name]["steps"] + 1
    for s, (g, w) in enumerate(zip(got, want)):
        assert sorted(g) == sorted(w)
        _equal(g["clients"], w["clients"], f"{name} step {s} clients")
        for part in w:
            if part != "clients":
                _close(g[part], w[part], f"{name} step {s} {part}")


# the reference's threefry streams do not port: its rng cases are held to
# the port's single-device round only
REFERENCE_CASES = [n for n in sorted(CASES)
                   if "randk" not in n]


@pytest.mark.parametrize("name", REFERENCE_CASES)
def test_sharded_round_matches_the_reference(ranks, name):
    """Against the reference's jitted vmap ef_round on the same numpy
    inputs (its deterministic compressors draw nothing)."""
    import jax
    import jax.numpy as jnp
    from repro.core import distributed as jax_dist
    from test_torch_ef_round import _nest
    from test_torch_schedule import configs, flat
    case = CASES[name]
    j_efc, _ = configs(_vmap_spec(case["spec"]))
    params, g0, grads = numpy_inputs(_seed(name))
    to_j = lambda t: jax.tree_util.tree_map(jnp.asarray, _nest(t))  # noqa
    state = jax_dist.init_ef_state(j_efc, to_j(params), N,
                                   init_grads=to_j(g0))
    fn = jax.jit(lambda g, s, st: jax_dist.ef_round(j_efc, g, s, None,
                                                    step=st))
    got = _assemble(ranks, name)
    for s in range(case["steps"]):
        est, state = fn(to_j(grads[s]), state, jnp.int32(s))
        want = {"g_est": flat(est), **{p: flat(v) for p, v in state.items()}}
        assert sorted(got[s + 1]) == sorted(want)
        for part in want:
            _close(got[s + 1][part], want[part], f"{name} step {s} {part}")


@pytest.mark.parametrize("name", OVERLAP)
def test_overlap_ring_is_bit_identical_to_the_blocking_gather(ranks, name):
    for r in ranks:
        for blocking, ring in zip(r[name], r[name + "/overlap"]):
            for part in blocking:
                _equal(ring[part], blocking[part], f"{name} {part}")


@pytest.mark.parametrize("name", ["sampled-dense", "sampled-fused",
                                  "sampled-quant8"])
def test_sampled_rounds_freeze_the_other_clients_bit_for_bit(ranks, name):
    """A client outside a step's cohort keeps its whole EF state, bit for
    bit, through that step (its rank runs no kernel on it)."""
    from repro_torch.core import participation as part_lib
    part = pt_build.make_participation(
        pt_spec.RunSpec.from_dict(_vmap_spec(CASES[name]["spec"])))
    got = _assemble(ranks, name)
    for s in range(CASES[name]["steps"]):
        mask = part_lib.cohort_mask_np(part, N, s)
        assert 0 < mask.sum() < N
        for key, leaves in got[s + 1]["clients"].items():
            for i in np.flatnonzero(mask == 0):
                np.testing.assert_array_equal(leaves[i],
                                              got[s]["clients"][key][i])


@pytest.mark.parametrize("name", sorted(WIRES))
def test_gathered_wire_is_the_single_device_encode(ranks, name):
    """Mantissas, scales and indices of every client's wire, gathered
    (blocking and ring), equal the single-device encode of the stacked
    rows exactly."""
    from repro_torch.core import carriers as carrier_lib
    comp_kw = WIRES[name]
    comp = pt_build._build_compressor(comp_kw["compressor"],
                                      comp_kw["compressor_kw"], 0.05)
    _, g0, _ = numpy_inputs(11)
    x = torch.tensor(g0["embed"].reshape(N, -1))
    want = carrier_lib.make(name.split("-")[0]).encode(comp, x)
    for overlap in (False, True):
        for r in ranks:
            got = r["wires"][(name, overlap)]
            assert len(got) == len(want)
            for g, w in zip(got, want):
                np.testing.assert_array_equal(g.reshape(w.shape), w.numpy())


def test_ring_and_all_reduce_helpers(ranks):
    """comm.ring_all_gather stacks every rank's chunk in rank order with
    ``fn`` applied (int16 travels as bytes); all_reduce_sum gives every
    rank the same sum; the counters count the calls (a ring hop is one)."""
    base = np.arange(6, dtype=np.float32)
    for r in ranks:
        vals, ints = r["ring"]
        np.testing.assert_array_equal(
            vals, np.stack([(base + i) * 2 for i in range(N)]))
        np.testing.assert_array_equal(
            ints, np.stack([(base + i).astype(np.int16) for i in range(N)]))
        np.testing.assert_array_equal(r["sum"], sum(base + i
                                                    for i in range(N)))
        assert r["stats"]["collectives"] == 2 * (N - 1) + 1
        assert r["stats"]["staged_bytes"] == 0           # CPU tensors


@pytest.mark.parametrize("base", ["randk", "natural"])
@pytest.mark.parametrize("row", [0, 2, 3])
def test_client_row_draws_its_row_of_the_batched_stream(base, row):
    """ClientRow on one client's row is bit for bit that client's row of
    the base compressor's batched call on all N clients from the same
    generator state, and leaves the generator where that call does."""
    from repro_torch.core import compressors as comp_lib
    comp = {"randk": comp_lib.RandK(ratio=0.25),
            "natural": comp_lib.NaturalCompression()}[base]
    x = torch.tensor(np.random.default_rng(5).standard_normal((N, 40)),
                     dtype=torch.float32)
    want_gen = torch.Generator().manual_seed(11)
    want = comp.batched(x, want_gen)
    gen = torch.Generator().manual_seed(11)
    got = comp_lib.ClientRow(comp, N, row).batched(x[row:row + 1], gen)
    assert torch.equal(got, want[row:row + 1])
    assert torch.equal(torch.rand(3, generator=gen),
                       torch.rand(3, generator=want_gen))
