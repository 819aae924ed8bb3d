"""The sparse and quantized carriers (repro_torch.core.carriers: ``sparse``,
``quant8``, ``quant4``) against the reference's, with both payloads of the
quantized wire — sparse (BlockTopK, TopK) and dense (Identity,
HardThreshold) — on the same numpy inputs, leaf sizes from one value to
several blocks with a ragged tail. The reference runs under jit, as its
runtime runs it; the port runs on the CPU, where K5/K6/K4 are their plain
versions.

Exact: the wires (values, block-local indices, mantissas, scales), the
per-client decodes (``local_c``) and the word counts. ``decode_add`` and
the aggregate within the ``_close`` tolerance of test_torch_ef_round.py:
XLA fuses ``base + q·scale`` into one multiply-add, and the aggregate sums
the clients in an order of its own.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import carriers as jax_car
from repro.core import compressors as jax_comp
from repro_torch.core import carriers as pt_car
from repro_torch.core import compressors as pt_comp

DP = 4
COMPRESSORS = {
    "block_topk": {"ratio": 0.05, "block": 1024},
    "topk": {"ratio": 0.05},
    "identity": {},
    "hard_threshold": {"lam": 3.0},
}
CELLS = [(car, comp) for car in ("sparse", "quant8", "quant4")
         for comp in COMPRESSORS
         if car != "sparse" or comp in ("block_topk", "topk")]


def _close(got, want, what):
    got, want = np.asarray(got), np.asarray(want)
    atol = 4 * np.spacing(np.float32(np.abs(want).max()))
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=atol, err_msg=what)


def _equal(got, want):
    for g, w in zip(jax.tree_util.tree_leaves(got),
                    jax.tree_util.tree_leaves(want)):
        g = g.numpy() if isinstance(g, torch.Tensor) else g
        assert g.dtype == np.asarray(w).dtype, (g.dtype, np.asarray(w).dtype)
        np.testing.assert_array_equal(g, np.asarray(w))


def _deltas(d, seed):
    rng = np.random.RandomState(seed)
    x = rng.randint(-6, 7, size=(DP, d)).astype(np.float32)  # many ties
    x[:, ::7] = rng.randn(DP, x[:, ::7].shape[1]) * 3         # and a tail
    return x


@pytest.mark.parametrize("d", [1, 100, 960, 5 * 1024 + 17])
@pytest.mark.parametrize("carrier,comp", CELLS)
def test_carrier_matches_reference(carrier, comp, d):
    jc = jax_comp.make(comp, **COMPRESSORS[comp])
    pc = pt_comp.make(comp, **COMPRESSORS[comp])
    jcar, pcar = jax_car.make(carrier), pt_car.make(carrier)
    x = _deltas(d, d + len(carrier) + len(comp))
    xt = torch.tensor(x)

    # one client (the downlink's broadcast), encode → decode → decode_add
    jw = jax.jit(lambda v: jcar.encode(jc, v))(jnp.asarray(x[0]))
    pw = pcar.encode(pc, xt[0])
    _equal(pw, jw)
    _equal(pcar.decode(pc, pw, d=d, dtype=torch.float32),
           jax.jit(lambda w: jcar.decode(jc, w, d=d, dtype=jnp.float32))(jw))
    base = x[1] * 0.25
    _close(pcar.decode_add(pc, pw, torch.tensor(base), d=d,
                           dtype=torch.float32),
           jax.jit(lambda w, b: jcar.decode_add(jc, w, b, d=d,
                                                dtype=jnp.float32))(
               jw, jnp.asarray(base)), "decode_add")

    # DP clients folded into rows, as the 'wire' plan runs them
    jbw = jax.jit(jax.vmap(lambda v: jcar.encode(jc, v)))(jnp.asarray(x))
    _equal(pcar.encode(pc, xt), jbw)
    j_c, j_mean = jax.jit(lambda t: jax_car.wire_round_batched(
        jcar, jc, t, DP))({"leaf": jnp.asarray(x)})
    p_c, p_mean = pt_car.wire_round_batched(pcar, pc, {"leaf": xt}, DP)
    _equal(p_c["leaf"], j_c["leaf"])
    _close(p_mean["leaf"], j_mean["leaf"], "aggregate")

    assert pcar.wire_words(pc, d) == jcar.wire_words(jc, d)
    assert pt_car.downlink_words(pcar, pc, d) == \
        jax_car.downlink_words(jcar, jc, d)
    assert pcar.plan_down_with_reason(pc) == jcar.plan_down_with_reason(jc)


@pytest.mark.parametrize("carrier", ["quant8", "quant4"])
def test_quant_error_constants_match_reference(carrier):
    jcar, pcar = jax_car.make(carrier), pt_car.make(carrier)
    for comp, kw in COMPRESSORS.items():
        jc, pc = jax_comp.make(comp, **kw), pt_comp.make(comp, **kw)
        for d in (1, 960, 5 * 1024 + 17):
            assert pcar.quant_eps(pc, d) == jcar.quant_eps(jc, d)
            assert pcar.composed_err_factor(pc, d) == \
                jcar.composed_err_factor(jc, d)


def test_sparse_select_takes_local_indices_in_top_k_order():
    """Ties at the kb-th magnitude resolve to the lower index, and indices
    are local to their block (BlockTopK.sparse's are global)."""
    comp = pt_comp.BlockTopK(block=8, k_per_block=3)
    x = torch.tensor([[1., -5, 5, 2, 5, 0, 0, 0, 3, 3, 3, 3, 0, 0, 0, 0, 7]])
    vals, idx = pt_car.sparse_select(comp, x)
    assert idx.tolist() == [[[1, 2, 4], [0, 1, 2], [0, 1, 2]]]
    assert vals.tolist() == [[[-5., 5, 5], [3, 3, 3], [7, 0, 0]]]
    jvals, jidx = jax_car.sparse_select(
        jax_comp.BlockTopK(block=8, k_per_block=3), jnp.asarray(x[0].numpy()))
    np.testing.assert_array_equal(idx[0].numpy(), np.asarray(jidx))
    np.testing.assert_array_equal(vals[0].numpy(), np.asarray(jvals))


QUANT_CELLS = [(car, comp) for car in ("quant8", "quant4", "fused_quant8",
                                       "fused_quant4")
               for comp in COMPRESSORS]


@pytest.mark.parametrize("carrier,comp", QUANT_CELLS)
def test_wire_round_decodes_each_wire_once(carrier, comp, monkeypatch):
    """The 'wire' plan takes local_c and the mean from one K6 call a leaf;
    they equal the carrier's own decode and aggregate exactly, and the mean
    the reference's aggregate within ``_close``."""
    jc = jax_comp.make(comp, **COMPRESSORS[comp])
    pc = pt_comp.make(comp, **COMPRESSORS[comp])
    jcar, pcar = jax_car.make(carrier), pt_car.make(carrier)
    d = 5 * 1024 + 17
    x = _deltas(d, 11 + len(carrier) + len(comp))
    xt = torch.tensor(x)
    wire = pcar.encode(pc, xt)
    calls, real = [], pt_car.ops.block_dequantize
    monkeypatch.setattr(pt_car.ops, "block_dequantize",
                        lambda *a: calls.append(a) or real(*a))
    c, mean = pcar.local_c_and_mean(pc, xt, wire, DP)
    assert len(calls) == 1
    monkeypatch.undo()
    _equal(c, pcar.decode(pc, wire, d=d, dtype=torch.float32))
    _equal(mean, pcar.aggregate(pc, wire, d=d, dtype=torch.float32, dp=DP))
    jw = jax.jit(jax.vmap(lambda v: jcar.encode(jc, v)))(jnp.asarray(x))
    _close(mean, jax.jit(lambda w: jcar.aggregate(
        jc, w, d=d, dtype=jnp.float32, dp=DP))(jw), "aggregate")
