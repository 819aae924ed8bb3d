"""The port's compressors (repro_torch.core.compressors) against the
reference's (repro.core.compressors), jitted as the reference's runtime
runs them, on the same numpy inputs: integers in [-6, 6] (so many entries
tie in magnitude) and, at the end, a randn tail.

Exact: ``__call__``, ``sparse`` (values and indices, ``lax.top_k``'s order
among ties), ``alpha`` and the base properties. The one exception is
``Rank1``, whose power iteration is two matrix-vector products: XLA and
PyTorch sum them in different orders, so it is held to rtol 1e-5 (f32
reductions over at most a few hundred terms of magnitude <= 6).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import compressors as jax_comp
from repro_torch.core import compressors as pt_comp

CASES = [
    pytest.param("identity", {}, id="identity"),
    pytest.param("topk", {"ratio": 0.05}, id="topk-ratio"),
    pytest.param("topk", {"k": 7}, id="topk-k7"),
    pytest.param("block_topk", {"ratio": 0.1, "block": 64}, id="block_topk"),
    pytest.param("hard_threshold", {"lam": 3.0}, id="hard_threshold"),
    pytest.param("block_quant", {}, id="block_quant8"),
    pytest.param("block_quant", {"bits": 4, "block": 64}, id="block_quant4"),
    pytest.param("rank1", {"rows": 8}, id="rank1"),
]


def _x(d, seed):
    rng = np.random.RandomState(seed)
    x = rng.randint(-6, 7, size=d).astype(np.float32)     # many ties
    tail = min(d // 4, 50)
    x[d - tail:] = rng.randn(tail).astype(np.float32)
    return x


@pytest.mark.parametrize("name,kw", CASES)
@pytest.mark.parametrize("d", [1, 50, 960, 3000])
def test_compressor_matches_reference(name, kw, d):
    jc, pc = jax_comp.make(name, **kw), pt_comp.make(name, **kw)
    x = _x(d, d + len(name))
    want = np.asarray(jax.jit(lambda v: jc(v))(jnp.asarray(x)))
    got = pc(torch.tensor(x)).numpy()
    if name == "rank1":
        np.testing.assert_allclose(got, want, rtol=1e-5,
                                   atol=1e-5 * np.abs(want).max())
    else:
        np.testing.assert_array_equal(got, want)
    assert pc.alpha(d) == jc.alpha(d)
    for prop in ("is_contractive", "has_sparse_carrier", "needs_rng"):
        assert getattr(pc, prop) == getattr(jc, prop), prop
    if hasattr(jc, "sparse"):
        for g, w in zip(pc.sparse(torch.tensor(x)),
                        jax.jit(lambda v: jc.sparse(v))(jnp.asarray(x))):
            np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    rows = np.stack([x, -x[::-1]])
    np.testing.assert_array_equal(
        pc.batched(torch.tensor(rows)).numpy(),
        np.stack([pc(torch.tensor(r)).numpy() for r in rows]))


def test_hard_threshold_delta_and_registry():
    assert pt_comp.HardThreshold(lam=0.5).delta(16) == \
        jax_comp.HardThreshold(lam=0.5).delta(16)
    assert set(pt_comp.REGISTRY) == set(jax_comp.REGISTRY)
    with pytest.raises(ValueError, match="unknown compressor"):
        pt_comp.make("nope")
