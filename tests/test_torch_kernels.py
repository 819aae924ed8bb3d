"""The port's kernels (src/repro_torch/kernels) against the reference's Pallas
kernels run in interpret mode, on the same numpy inputs.

On the CPU each wrapper in ``repro_torch.kernels.ops`` runs its plain
PyTorch version, which repeats the Pallas body step by step; on a card the
same wrappers launch the CUDA kernels, which tests/test_torch_cuda.py holds
against the plain versions.

Tolerances. XLA on the CPU contracts a*b + c into one fused multiply-add
where the port (and its CUDA kernels) round twice: it computes
v' = fma(1-η, v, η·grad) and g' = fma(q, scale, g). So
  * at η = 0.5 both products are exact and v' rounds once either way: the
    selection masks, c, v', the mantissas and the scales must match
    EXACTLY, and g' (and the downlink's base + q·scale) within one ulp;
  * at the main path's η = 0.2, v' may differ by one ulp, and with it
    v' - g: the masks must still match exactly, v' and c within one ulp,
    the scales (absmax of c, times a constant) within two, a mantissa by at
    most one grid step, and g' = g + q·scale within four — q·δscale is at
    most two ulps of the values (q <= qmax, scale = absmax/qmax), plus one
    for the fused multiply-add and one for the final rounding.
An ulp is taken at the scale of the values (rtol 0).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ef_update as jax_ef
from repro.kernels import fused_round as jax_fr
from repro.kernels import ref as jax_ref
from repro.kernels import topk_compress as jax_tk
from repro_torch.core.carriers import FusedPallasCarrier
from repro_torch.core.compressors import BlockTopK
from repro_torch.kernels import ops, ref


def _within_ulp(a, b, n=1):
    """|a - b| <= n ulp at the scale of the values (rtol 0): a fused
    multiply-add rounds once where two roundings happen otherwise, which
    moves the result by up to an ulp of the product term — more than an ulp
    of the result itself where the sum cancels."""
    a, b = np.asarray(a, np.float32), np.asarray(b, np.float32)
    assert a.shape == b.shape
    tol = n * np.spacing(np.float32(max(np.abs(a).max(), np.abs(b).max())))
    bad = np.abs(a.astype(np.float64) - b.astype(np.float64)) > tol
    assert not bad.any(), (f"{bad.sum()} values differ by more than {n} ulp; "
                           f"first at {np.argwhere(bad)[:3].tolist()}")


def _inputs(d, seed, zero_rows=(), block=1024):
    rng = np.random.RandomState(seed)
    grad, v, g = (rng.randn(d).astype(np.float32) for _ in range(3))
    for r in zero_rows:                     # v' - g == 0 on these rows
        for x in (grad, v, g):
            x[r * block:(r + 1) * block] = 0.0
    return grad, v, g


def _rows(x, nb, block):
    t = torch.tensor(x)
    return torch.nn.functional.pad(t, (0, nb * block - t.numel())).reshape(
        nb, block)


def _unrows(t, d):
    return t.reshape(-1)[:d].numpy()


# the geometries of the carrier's launch: odd d padded to whole 1024 rows
# over a few hundred rows with all-zero rows among them, and single-block
# leaves lane-rounded to 128 (a 960-wide norm and a 100-wide leaf)
CASES = [
    pytest.param(300 * 1024 - 517, 1024, 51, (3, 117), id="odd_d_300_rows"),
    pytest.param(960, *FusedPallasCarrier._kernel_geom(BlockTopK(0.05), 960)[1:],
                 (), id="single_block_960"),
    pytest.param(100, *FusedPallasCarrier._kernel_geom(BlockTopK(0.05), 100)[1:],
                 (), id="single_block_100"),
]


def test_single_block_geometry_rounds_to_lanes():
    assert FusedPallasCarrier._kernel_geom(BlockTopK(0.05), 960) == (1, 1024, 48)
    assert FusedPallasCarrier._kernel_geom(BlockTopK(0.05), 100) == (1, 128, 5)
    assert FusedPallasCarrier._kernel_geom(BlockTopK(0.05), 4096) == (4, 1024, 51)


@pytest.mark.parametrize("d,block,k,zero_rows", CASES)
def test_bisect_threshold_matches_pallas_helper(d, block, k, zero_rows):
    grad, _, _ = _inputs(d, 1, zero_rows, block)
    nb = -(-d // block)
    ab = np.abs(_rows(grad, nb, block).numpy())
    want = np.asarray(jax_tk._bisect_threshold(jnp.asarray(ab), k))
    got = ref.bisect_threshold_plain(torch.tensor(ab), k).numpy()
    np.testing.assert_array_equal(got, want)


def _run_k2(d, block, k, zero_rows, eta, seed):
    grad, v, g = _inputs(d, seed, zero_rows, block)
    want = jax_ef.ef21_sgdm_update(
        jnp.asarray(grad), jnp.asarray(v), jnp.asarray(g), eta=eta,
        block=block, k=k, interpret=True)
    nb = -(-d // block)
    got = ops.ef21_sgdm_update(
        _rows(grad, nb, block), _rows(v, nb, block), _rows(g, nb, block),
        eta=eta, k=k)
    return [_unrows(t, d) for t in got], [np.asarray(x) for x in want]


@pytest.mark.parametrize("d,block,k,zero_rows", CASES)
def test_ef21_sgdm_update_matches_pallas(d, block, k, zero_rows):
    (vt, gt, ct), (vj, gj, cj) = _run_k2(d, block, k, zero_rows, 0.5, 2)
    np.testing.assert_array_equal(ct, cj)
    np.testing.assert_array_equal(vt, vj)
    _within_ulp(gt, gj)
    for r in zero_rows:
        assert not ct[r * block:(r + 1) * block].any()


@pytest.mark.parametrize("d,block,k,zero_rows", CASES)
def test_ef21_sgdm_update_at_main_path_eta(d, block, k, zero_rows):
    (vt, gt, ct), (vj, gj, cj) = _run_k2(d, block, k, zero_rows, 0.2, 4)
    np.testing.assert_array_equal(ct != 0, cj != 0)
    _within_ulp(vt, vj)
    _within_ulp(ct, cj)
    _within_ulp(gt, gj, 2)                  # g + c, c carrying v''s ulp


def _run_k3(d, block, k, zero_rows, eta, seed, bits):
    grad, v, g = _inputs(d, seed, zero_rows, block)
    want = jax_fr.ef21_sgdm_topk_quant(
        jnp.asarray(grad), jnp.asarray(v), jnp.asarray(g), eta=eta,
        block=block, k=k, bits=bits, interpret=True)
    nb = -(-d // block)
    vt, gt, qt, st = ops.ef21_sgdm_topk_quant(
        _rows(grad, nb, block), _rows(v, nb, block), _rows(g, nb, block),
        eta=eta, k=k, bits=bits)
    return (_unrows(vt, d), _unrows(gt, d), qt, st), \
        [np.asarray(x) for x in want]


def _decode(q, s, bits, block):
    q, s = (torch.from_numpy(np.array(x)) if isinstance(x, np.ndarray) else x
            for x in (q, s))
    return ref.block_dequantize_plain(q, s, bits=bits, cols=block).numpy()


@pytest.mark.parametrize("bits", [8, 4])
@pytest.mark.parametrize("d,block,k,zero_rows", CASES)
def test_ef21_sgdm_topk_quant_matches_pallas(d, block, k, zero_rows, bits):
    (vt, gt, qt, st), (vj, gj, qj, sj) = _run_k3(d, block, k, zero_rows, 0.5,
                                                 3 + bits, bits)
    np.testing.assert_array_equal(qt.numpy(), qj)
    np.testing.assert_array_equal(st.numpy(), sj)
    np.testing.assert_array_equal(vt, vj)
    _within_ulp(gt, gj)
    for r in zero_rows:                     # scale 0, decodes to exact zeros
        assert st[r] == 0
        assert not _decode(qt[r:r + 1], st[r:r + 1], bits, block).any()


@pytest.mark.parametrize("bits", [8, 4])
@pytest.mark.parametrize("d,block,k,zero_rows", CASES)
def test_ef21_sgdm_topk_quant_at_main_path_eta(d, block, k, zero_rows, bits):
    (vt, gt, qt, st), (vj, gj, qj, sj) = _run_k3(d, block, k, zero_rows, 0.2,
                                                 5 + bits, bits)
    mt, mj = _decode(qt, st, bits, block), _decode(qj, sj, bits, block)
    ones = np.ones_like(st.numpy())
    steps = np.abs(_decode(qt, ones, bits, block)
                   - _decode(qj, ones, bits, block))
    np.testing.assert_array_equal(mt != 0, mj != 0)
    assert steps.max() <= 1.0
    _within_ulp(vt, vj)
    _within_ulp(st.numpy(), sj, 2)
    _within_ulp(gt, gj, 4)


def test_topk_quant_writes_state_in_place():
    """v_out/g_out = v/g: the wrapper's in-place form equals the out-of-place
    one (the carriers update the client EF state this way)."""
    grad, v, g = (_rows(x, 8, 256) for x in _inputs(2048, 9, (), 256))
    want = ops.ef21_sgdm_topk_quant(grad, v, g, eta=0.3, k=13, bits=4)
    v2, g2 = v.clone(), g.clone()
    got = ops.ef21_sgdm_topk_quant(grad, v2, g2, eta=0.3, k=13, bits=4,
                                   v_out=v2, g_out=g2)
    assert got[0] is v2 and got[1] is g2
    for a, b in zip(got, want):
        assert torch.equal(a, b)


@pytest.mark.parametrize("alpha", [1.0, -0.5])
@pytest.mark.parametrize("bits", [8, 4])
def test_dequant_add_matches_pallas(bits, alpha):
    block, nb = 1024, 37
    d = nb * block - 301
    rng = np.random.RandomState(bits)
    if bits == 8:
        q = rng.randint(-127, 128, size=(nb, block)).astype(np.int8)
    else:
        q = rng.randint(0, 256, size=(nb, block // 2)).astype(np.uint8)
    scales = (rng.rand(nb) * 1e-2).astype(np.float32)
    scales[5] = 0.0
    base = rng.randn(d).astype(np.float32)
    want = jax_fr.dequant_add(jnp.asarray(q), jnp.asarray(scales),
                              jnp.asarray(base), d=d, block=block, bits=bits,
                              alpha=alpha, interpret=True)
    got = ops.dequant_add(torch.tensor(q), torch.tensor(scales),
                          torch.tensor(base), block=block, bits=bits,
                          alpha=alpha)
    _within_ulp(got.numpy(), want)


@pytest.mark.parametrize("bits", [8, 4])
def test_codec_oracles_match_reference(bits):
    rng = np.random.RandomState(11 + bits)
    x = rng.randn(40, 255).astype(np.float32)
    x[3] = 0.0
    x[7, 9] = np.inf
    x[8, 1] = np.nan
    # under jit, as the reference's runtime runs it (see ref.qmax_recip)
    qj, sj = jax.jit(jax_ref.block_quantize_ref, static_argnums=1)(
        jnp.asarray(x), bits)
    qt, st = ref.block_quantize_plain(torch.tensor(x), bits)
    np.testing.assert_array_equal(qt.numpy(), np.asarray(qj))
    np.testing.assert_array_equal(st.numpy(), np.asarray(sj))
    dj = jax_ref.block_dequantize_ref(qj, sj, bits=bits, cols=255)
    dt = ref.block_dequantize_plain(qt, st, bits=bits, cols=255)
    np.testing.assert_array_equal(dt.numpy(), np.asarray(dj))


def test_wrappers_reject_what_the_kernels_do_not_take():
    x = torch.zeros(4, 64)
    with pytest.raises(ValueError, match="dtype"):
        ops.ef21_sgdm_update(x.double(), x, x, eta=0.1, k=3)
    with pytest.raises(ValueError, match="contiguous"):
        ops.ef21_sgdm_update(x.t().contiguous().t(), x, x, eta=0.1, k=3)
    with pytest.raises(ValueError, match="k="):
        ops.ef21_sgdm_topk_quant(x, x, x, eta=0.1, k=65, bits=8)
    with pytest.raises(ValueError, match="even"):
        ops.ef21_sgdm_topk_quant(torch.zeros(4, 63), torch.zeros(4, 63),
                                 torch.zeros(4, 63), eta=0.1, k=3, bits=4)
    with pytest.raises(ValueError, match="rows"):
        ops.dequant_add(torch.zeros(2, 64, dtype=torch.int8), torch.zeros(2),
                        torch.zeros(200), block=64, bits=8)


def test_plain_runs_do_not_count_as_launches():
    ops.reset_launches()
    x = torch.zeros(4, 64)
    ops.ef21_sgdm_update(x, x, x, eta=0.1, k=3)
    ops.ef21_sgdm_topk_quant(x, x, x, eta=0.1, k=3, bits=8)
    ops.block_dequantize(*ops.block_quantize(x, 4), 4, 64)
    assert ops.launches == {"ef21_sgdm_update": 0, "ef21_sgdm_topk_quant": 0,
                            "dequant_add": 0, "block_quantize": 0,
                            "block_dequantize": 0}
