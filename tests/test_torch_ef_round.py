"""One EF round of the port (repro_torch.core.distributed.ef_round) against
the reference's vmap runtime (repro.core.distributed.ef_round, jitted as
its train step runs it), on the same per-client grads and EF state made
with numpy at the smoke smollm-360m leaf shapes: the fused plans, the dense
plan, and cells of the unfused sparse and quantized wires (the whole grid
runs on a small problem in test_torch_wire_round.py).

The new client v and g, the server g, the downlink memory h and the
estimate g_est must agree to rtol 1e-6 (atol: four ulps at the scale of
the values, for elements where the sum cancels — XLA contracts a*b + c to
one fused multiply-add where the port rounds twice; see
test_torch_kernels.py). The round runs at η = 0.5, where both momentum
products are exact, so v' and with it every selection, mantissa and scale
is the same in both packages; at other η the contraction can move a
mantissa by one grid step (bounded in test_torch_kernels.py), which no
rtol of 1e-6 covers. Wire words per leaf must match exactly.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import carriers as jax_carriers
from repro.core import compressors as jax_comp
from repro.core import distributed as jax_dist
from repro.core import ef as jax_ef
from repro_torch.configs import base as cb
from repro_torch.core import carriers as pt_carriers
from repro_torch.core import compressors as pt_comp
from repro_torch.core import distributed as pt_dist
from repro_torch.core import ef as pt_ef
from repro_torch.models import model as pt_model

DP, ETA = 8, 0.5
UP_KW = {"ratio": 0.05, "block": 1024, "k_per_block": 16}
DOWN_KW = {"ratio": 0.05, "block": 1024}


def _shapes():
    cfg = cb.get_smoke("smollm-360m")
    params = pt_model.init_params(cfg, torch.Generator().manual_seed(0))
    return {k: tuple(v.shape) for k, v in params.items()}


def _nest(flat):
    out = {}
    for path, x in flat.items():
        node = out
        *heads, leaf = path.split("/")
        for h in heads:
            node = node.setdefault(h, {})
        node[leaf] = x
    return out


def _numpy_state(seed, downlink, method="ef21_sgdm"):
    rng = np.random.RandomState(seed)
    shapes = _shapes()

    def tree(lead=()):
        return {k: rng.randn(*lead, *s).astype(np.float32)
                for k, s in shapes.items()}
    grads = tree((DP,))
    names = {"ef21_sgdm": ("g", "v"), "ef21_sgd": ("g",),
             "ef14_sgd": ("e",)}[method]
    state = {"clients": {n: tree((DP,)) for n in names}, "server": tree()}
    if downlink:
        state["h"] = tree()
    return grads, state


def _to_jax(x):
    if isinstance(x, dict) and all(isinstance(v, np.ndarray) for v in x.values()):
        return jax.tree_util.tree_map(jnp.asarray, _nest(x))
    return {k: _to_jax(v) for k, v in x.items()}


def _to_torch(x):
    if isinstance(x, np.ndarray):
        return torch.tensor(x)
    return {k: _to_torch(v) for k, v in x.items()}


def _flat_np(tree):
    return {k: np.asarray(v) for k, v in pt_ef.flatten(tree).items()}


def _close(got, want, what):
    assert sorted(got) == sorted(want), what
    for k in want:
        g, w = np.asarray(got[k]), np.asarray(want[k])
        atol = 4 * np.spacing(np.float32(np.abs(w).max()))
        np.testing.assert_allclose(g, w, rtol=1e-6, atol=atol,
                                   err_msg=f"{what}/{k}")


CELLS = [
    pytest.param("ef21_sgdm", "fused", "dense", id="fused"),
    pytest.param("ef21_sgdm", "fused_quant8", "fused_quant4",
                 id="fused_quant8-down4"),
    pytest.param("ef21_sgdm", "dense", "dense", id="dense"),
    pytest.param("ef21_sgd", "fused", "dense", id="ef21_sgd-fused"),
    pytest.param("ef21_sgd", "fused_quant4", "fused_quant8",
                 id="ef21_sgd-fused_quant4-down8"),
    pytest.param("ef21_sgdm", "quant8", "quant4", id="quant8-down4"),
    pytest.param("ef21_sgd", "sparse", "quant8", id="ef21_sgd-sparse-down8"),
    pytest.param("ef14_sgd", "quant4", "dense", id="ef14_sgd-quant4"),
]


def _methods(name):
    if name == "ef21_sgdm":
        return (jax_ef.EF21SGDM(compressor=jax_comp.BlockTopK(**UP_KW), eta=ETA),
                pt_ef.EF21SGDM(compressor=pt_comp.BlockTopK(**UP_KW), eta=ETA))
    if name == "ef14_sgd":
        return (jax_ef.EF14SGD(compressor=jax_comp.BlockTopK(**UP_KW)),
                pt_ef.EF14SGD(compressor=pt_comp.BlockTopK(**UP_KW)))
    return (jax_ef.EF21SGD(compressor=jax_comp.BlockTopK(**UP_KW)),
            pt_ef.EF21SGD(compressor=pt_comp.BlockTopK(**UP_KW)))


@pytest.mark.parametrize("method,carrier,down", CELLS)
def test_ef_round_matches_reference(method, carrier, down):
    downlink = down != "dense"
    grads, state = _numpy_state(7, downlink, method)
    j_method, p_method = _methods(method)
    j_efc = jax_dist.EFConfig(
        method=j_method, carrier=carrier, down_carrier=down,
        down_compressor=jax_comp.BlockTopK(**DOWN_KW) if downlink else None)
    j_est, j_state = jax.jit(
        lambda g, s: jax_dist.ef_round(j_efc, g, s, None))(
        _to_jax(grads), _to_jax(state))

    p_efc = pt_dist.EFConfig(
        method=p_method, carrier=carrier, down_carrier=down,
        down_compressor=pt_comp.BlockTopK(**DOWN_KW) if downlink else None)
    p_est, p_state = pt_dist.ef_round(p_efc, _to_torch(grads),
                                      _to_torch(state))

    _close(p_est, _flat_np(j_est), "g_est")
    _close(p_state["server"], _flat_np(j_state["server"]), "server")
    for name in state["clients"]:
        _close(p_state["clients"][name],
               _flat_np(j_state["clients"][name]), f"clients/{name}")
    if downlink:
        _close(p_state["h"], _flat_np(j_state["h"]), "h")
        assert p_est is p_state["h"]


@pytest.mark.parametrize("carrier", ["dense", "fused", "fused_quant8",
                                     "fused_quant4", "sparse", "quant8",
                                     "quant4"])
def test_wire_words_per_leaf_match_reference(carrier):
    for kw in (UP_KW, DOWN_KW):
        j_car, p_car = jax_carriers.make(carrier), pt_carriers.make(carrier)
        j_c, p_c = jax_comp.BlockTopK(**kw), pt_comp.BlockTopK(**kw)
        for leaf, shape in _shapes().items():
            d = int(np.prod(shape))
            assert p_car.wire_words(p_c, d) == j_car.wire_words(j_c, d), leaf
            assert pt_carriers.downlink_words(p_car, p_c, d) == \
                jax_carriers.downlink_words(j_car, j_c, d), leaf
        for d in (1, 100, 960, 1023, 1025, 47_185_920):
            assert p_car.wire_words(p_c, d) == j_car.wire_words(j_c, d), d


@pytest.mark.parametrize("bits", [8, 4])
@pytest.mark.parametrize("d", [100, 960, 5 * 1024 + 17])
def test_fused_quant_wire_matches_reference(bits, d):
    """The downlink payload: encode (BlockTopK threshold mask, quantized at
    the lane-rounded launch geometry), decode and decode_add (K4's plain
    version on the CPU), against the reference under jit."""
    rng = np.random.RandomState(d + bits)
    delta = rng.randn(d).astype(np.float32)
    base = rng.randn(d).astype(np.float32)
    name = f"fused_quant{bits}"
    jc, pc = jax_comp.BlockTopK(**DOWN_KW), pt_comp.BlockTopK(**DOWN_KW)
    j_car = jax_carriers.FusedQuantCarrier(name=name, bits=bits,
                                           interpret=True)
    p_car = pt_carriers.make(name)
    jq, js = jax.jit(lambda x: j_car.encode(jc, x))(jnp.asarray(delta))
    pq, ps = p_car.encode(pc, torch.tensor(delta))
    np.testing.assert_array_equal(pq.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(ps.numpy(), np.asarray(js))
    np.testing.assert_array_equal(
        p_car.decode(pc, (pq, ps), d=d, dtype=torch.float32).numpy(),
        np.asarray(j_car.decode(jc, (jq, js), d=d, dtype=jnp.float32)))
    j_out = j_car.decode_add(jc, (jq, js), jnp.asarray(base), d=d,
                             dtype=jnp.float32)
    p_out = p_car.decode_add(pc, (pq, ps), torch.tensor(base), d=d,
                             dtype=torch.float32)
    _close({"h": p_out.numpy()}, {"h": np.asarray(j_out)}, "decode_add")


@pytest.mark.parametrize("d", [1, 50, 960, 1024, 3000, 4097])
def test_block_topk_matches_reference(d):
    """geom, the threshold mask (ties kept) and the stable sparse order."""
    rng = np.random.RandomState(d)
    x = rng.randint(-6, 7, size=d).astype(np.float32)       # many ties
    for kw in (UP_KW, DOWN_KW, {"ratio": 0.3, "block": 64}):
        jc, pc = jax_comp.BlockTopK(**kw), pt_comp.BlockTopK(**kw)
        assert pc.geom(d) == jc.geom(d)
        assert pc.alpha(d) == jc.alpha(d)
        np.testing.assert_array_equal(pc(torch.tensor(x)).numpy(),
                                      np.asarray(jc(jnp.asarray(x))))
        for got, want in zip(pc.sparse(torch.tensor(x)),
                             jc.sparse(jnp.asarray(x))):
            np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_fused_update_writes_client_state_in_place():
    grads, state = _numpy_state(3, False)
    efc = pt_dist.EFConfig(method=_methods("ef21_sgdm")[1],
                           carrier="fused_quant8")
    st = _to_torch(state)
    before = {k: v.data_ptr() for k, v in st["clients"]["g"].items()}
    _, new = pt_dist.ef_round(efc, _to_torch(grads), st)
    assert new["clients"] is st["clients"]
    assert {k: v.data_ptr() for k, v in new["clients"]["g"].items()} == before
    assert not torch.equal(new["clients"]["g"]["embed"],
                           torch.tensor(state["clients"]["g"]["embed"]))


def test_unported_names_raise_naming_the_later_slice():
    """Once refused as later slices, now ported: the rng compressors build
    and draw, and the paired and R-round methods build with the
    reference's flags."""
    for name in ("randk", "natural"):
        comp = pt_comp.make(name)
        assert comp.needs_rng and type(comp).__name__ == type(
            jax_comp.make(name)).__name__
    for name in ("ef21_storm", "neolithic", "ef21_sgdm_ideal"):
        m, j = pt_ef.make(name), jax_ef.make(name)
        assert (m.name, m.mode, m.needs_paired_grads, m.wire_is_msg) == \
            (j.name, j.mode, j.needs_paired_grads, j.wire_is_msg)


# --------------------------------------------------------------------------
# bfloat16 client state on every plan
# --------------------------------------------------------------------------

BF16_CELLS = [
    pytest.param("ef21_sgdm", "fused", "dense", id="fused"),
    pytest.param("ef21_sgdm", "fused_quant8", "fused_quant4",
                 id="fused_quant8-down4"),
    pytest.param("ef21_sgdm", "dense", "dense", id="dense"),
    pytest.param("ef21_sgdm", "quant8", "quant4", id="quant8-down4"),
    pytest.param("ef21_sgdm", "sparse", "dense", id="sparse"),
    pytest.param("ef14_sgd", "quant4", "dense", id="ef14_sgd-quant4"),
]


def _close_bf16(got, want, what):
    """Within one bf16 ulp of each value: K3's g + q·scale is one fused
    multiply-add in the reference and two roundings in the port before the
    bf16 store (test_torch_kernels.py)."""
    assert sorted(got) == sorted(want), what
    for k in want:
        g, w = np.asarray(got[k].float()), np.asarray(want[k], np.float32)
        tol = np.spacing(np.abs(w).astype(np.float32)) * 2.0 ** 16
        bad = np.abs(g.astype(np.float64) - w) > tol
        assert not bad.any(), f"{what}/{k}: {bad.sum()} values off by > 1 ulp"


@pytest.mark.parametrize("method,carrier,down", BF16_CELLS)
def test_ef_round_bf16_state_matches_reference(method, carrier, down):
    """The reference's ``ef_state_dtype='bfloat16'``: the client state is
    bf16 (the fused kernels read and write it so), the server and h stay
    f32. At η = 0.5 the server estimate, h and g_est agree as in f32; the
    bf16 client state within one bf16 ulp (almost every value equal)."""
    downlink = down != "dense"
    grads, state = _numpy_state(9, downlink, method)
    j_method, p_method = _methods(method)
    j_method = dataclasses.replace(j_method, state_dtype=jnp.bfloat16)
    p_method = dataclasses.replace(p_method, state_dtype=torch.bfloat16)
    j_state, p_state = _to_jax(state), _to_torch(state)
    j_state["clients"] = jax.tree_util.tree_map(
        lambda x: x.astype(jnp.bfloat16), j_state["clients"])
    p_state["clients"] = {n: pt_ef.tree_cast(t, torch.bfloat16)
                          for n, t in p_state["clients"].items()}
    j_efc = jax_dist.EFConfig(
        method=j_method, carrier=carrier, down_carrier=down,
        down_compressor=jax_comp.BlockTopK(**DOWN_KW) if downlink else None)
    j_est, j_new = jax.jit(
        lambda g, s: jax_dist.ef_round(j_efc, g, s, None))(
        _to_jax(grads), j_state)
    p_efc = pt_dist.EFConfig(
        method=p_method, carrier=carrier, down_carrier=down,
        down_compressor=pt_comp.BlockTopK(**DOWN_KW) if downlink else None)
    p_est, p_new = pt_dist.ef_round(p_efc, _to_torch(grads), p_state)

    _close(p_est, _flat_np(jax.tree_util.tree_map(
        lambda x: x.astype(jnp.float32), j_est)), "g_est")
    _close(p_new["server"], _flat_np(j_new["server"]), "server")
    assert all(t.dtype == torch.float32 for t in p_new["server"].values())
    for name in state["clients"]:
        want = jax.tree_util.tree_map(lambda x: x.astype(jnp.float32),
                                      j_new["clients"][name])
        assert all(t.dtype == torch.bfloat16
                   for t in p_new["clients"][name].values())
        _close_bf16(p_new["clients"][name], _flat_np(want),
                    f"clients/{name}")
    if downlink:
        _close(p_new["h"], _flat_np(j_new["h"]), "h")


def test_init_ef_state_casts_the_clients_only():
    """init_ef_state with the batch-0 grads: the clients' v and g are the
    grads rounded to bf16 (each its own tensor), the server the f32 mean."""
    grads, _ = _numpy_state(5, False)
    method = dataclasses.replace(_methods("ef21_sgdm")[1],
                                 state_dtype=torch.bfloat16)
    efc = pt_dist.EFConfig(method=method, carrier="fused_quant8",
                           down_carrier="fused_quant4",
                           down_compressor=pt_comp.BlockTopK(**DOWN_KW))
    g0 = _to_torch(grads)
    params = {k: v[0] for k, v in g0.items()}
    st = pt_dist.init_ef_state(efc, params, DP, init_grads=g0)
    v, g = st["clients"]["v"]["embed"], st["clients"]["g"]["embed"]
    assert v.dtype == g.dtype == torch.bfloat16
    assert v.data_ptr() != g.data_ptr() and torch.equal(v, g)
    assert torch.equal(v, g0["embed"].to(torch.bfloat16))
    assert st["server"]["embed"].dtype == torch.float32
    assert torch.equal(st["h"]["embed"], st["server"]["embed"])
