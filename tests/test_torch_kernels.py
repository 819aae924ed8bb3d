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
from repro.kernels import ops as jax_ops
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
    # blocks wider than 1024 (the card's wide route, csrc/wide.cuh), a few
    # rows each, a ragged d and an all-zero row among them
    pytest.param(3 * 2048 - 77, 2048, 32, (1,), id="wide_2048"),
    pytest.param(2 * 3000 - 5, 3000, 47, (), id="wide_3000"),
    pytest.param(2 * 4096, 4096, 64, (0,), id="wide_4096"),
]
# an odd wide block: K2 and K3 at 8 bits (uint4 packing needs an even block)
ODD_CASES = [pytest.param(3 * 1025 - 11, 1025, 16, (2,), id="wide_odd_1025")]


def _with_bits(cases, bits):
    """(d, block, k, zero_rows, bits) cells, named case-bits."""
    return [pytest.param(*c.values, b, id=f"{c.id}-{b}") for c in cases
            for b in bits]


# K3's cells: every case at 8 and 4 bits, the odd block at 8
K3_CASES = _with_bits(CASES, (8, 4)) + _with_bits(ODD_CASES, (8,))


def test_single_block_geometry_rounds_to_lanes():
    assert FusedPallasCarrier._kernel_geom(BlockTopK(0.05), 960) == (1, 1024, 48)
    assert FusedPallasCarrier._kernel_geom(BlockTopK(0.05), 100) == (1, 128, 5)
    assert FusedPallasCarrier._kernel_geom(BlockTopK(0.05), 4096) == (4, 1024, 51)


@pytest.mark.parametrize("d,block,k,zero_rows", CASES + ODD_CASES)
def test_bisect_threshold_matches_pallas_helper(d, block, k, zero_rows):
    grad, _, _ = _inputs(d, 1, zero_rows, block)
    nb = -(-d // block)
    ab = np.abs(_rows(grad, nb, block).numpy())
    want = np.asarray(jax_tk._bisect_threshold(jnp.asarray(ab), k))
    got = ref.bisect_threshold_plain(torch.tensor(ab), k).numpy()
    np.testing.assert_array_equal(got, want)


def _odd_rows(block=256):
    """Rows of |v' - g| that the early exit and the max must get right: a
    NaN, an inf, both, ties across the k-th value, an all-zero row, and
    fewer than k nonzero values."""
    rng = np.random.RandomState(5)
    ab = np.abs(rng.randn(6, block)).astype(np.float32)
    ab[0, 7] = np.nan
    ab[1, 3] = np.inf
    ab[2, 3], ab[2, 9] = np.inf, np.nan
    ab[3, :] = 0.0
    ab[3, :20] = 2.5                        # 20 tied values across k = 16
    ab[4, :] = 0.0
    ab[5, :] = 0.0
    ab[5, :5] = 1.0                         # 5 nonzero, fewer than k
    return ab


def test_bisect_threshold_matches_pallas_helper_on_odd_rows():
    """A NaN makes the row's max NaN in the reference (jnp.max), so no mid
    keeps k values and the threshold stays 0: every value but the NaN is
    kept. The plain version, and the kernels' NaN-propagating max
    (csrc/bisect.cuh), do the same; ties, an inf, an all-zero row and rows
    with fewer than k nonzeros take all 26 steps."""
    ab = _odd_rows()
    want = np.asarray(jax_tk._bisect_threshold(jnp.asarray(ab), 16))
    got = ref.bisect_threshold_plain(torch.tensor(ab), 16).numpy()
    np.testing.assert_array_equal(got, want)
    assert got[0] == 0.0 and got[2] == 0.0           # the NaN rows keep all
    assert (ab[3] >= got[3]).sum() == 20              # the tie is kept whole


def test_ef21_sgdm_update_matches_pallas_on_odd_rows():
    """K2's plain version against the Pallas kernel on rows holding a NaN,
    an inf, ties, zeros: the same selection and v' (NaN where the
    reference has NaN), at eta 0.5 where both round v' once."""
    ab = _odd_rows()
    rng = np.random.RandomState(6)
    g = rng.randn(*ab.shape).astype(np.float32)
    grad = (2.0 * ab + g).astype(np.float32)     # v' - g = |.|-valued rows
    v = np.zeros_like(g)
    want = jax_ef.ef21_sgdm_update(
        jnp.asarray(grad.reshape(-1)), jnp.asarray(v.reshape(-1)),
        jnp.asarray(g.reshape(-1)), eta=0.5, block=ab.shape[1], k=16,
        interpret=True)
    got = ops.ef21_sgdm_update(torch.tensor(grad), torch.tensor(v),
                               torch.tensor(g), eta=0.5, k=16)
    vj, gj, cj = (np.asarray(x).reshape(ab.shape) for x in want)
    vt, gt, ct = (t.numpy() for t in got)
    np.testing.assert_array_equal(ct, cj)
    np.testing.assert_array_equal(vt, vj)
    np.testing.assert_array_equal(np.isnan(gt), np.isnan(gj))
    assert (ct[0] != 0).sum() == ab.shape[1] - 1      # all but the NaN


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


@pytest.mark.parametrize("d,block,k,zero_rows", CASES + ODD_CASES)
def test_ef21_sgdm_update_matches_pallas(d, block, k, zero_rows):
    (vt, gt, ct), (vj, gj, cj) = _run_k2(d, block, k, zero_rows, 0.5, 2)
    np.testing.assert_array_equal(ct, cj)
    np.testing.assert_array_equal(vt, vj)
    _within_ulp(gt, gj)
    for r in zero_rows:
        assert not ct[r * block:(r + 1) * block].any()


@pytest.mark.parametrize("d,block,k,zero_rows", CASES + ODD_CASES)
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


@pytest.mark.parametrize("d,block,k,zero_rows,bits", K3_CASES)
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


@pytest.mark.parametrize("d,block,k,zero_rows,bits", K3_CASES)
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
    ops.block_topk(x, block=64, k=3)
    ops.ef21_sgdm_update(x, x, x, eta=0.1, k=3)
    ops.ef21_sgdm_topk_quant(x, x, x, eta=0.1, k=3, bits=8)
    ops.block_dequantize(*ops.block_quantize(x, 4), 4, 64)
    q = torch.zeros(1, 8, 2, 64)
    ops.flash_attention(q, q, q)
    assert ops.launches == {"block_topk": 0, "ef21_sgdm_update": 0,
                            "ef21_sgdm_topk_quant": 0, "dequant_add": 0,
                            "block_quantize": 0, "block_dequantize": 0,
                            "flash_attention": 0}


# --------------------------------------------------------------------------
# K1, the standalone Block-TopK, and its three tie rules
# --------------------------------------------------------------------------

def _topk_input(shape, block, seed, dtype=np.float32):
    """Random values with an all-zero block, a run of ties and a ragged
    tail (the flat length need not be a multiple of the block)."""
    rng = np.random.RandomState(seed)
    x = rng.randn(int(np.prod(shape))).astype(np.float32)
    x[:block] = 0.0
    x[2 * block:2 * block + 7] = 9.0    # 7 ties above every other value
    return x.reshape(shape).astype(dtype)


TOPK_CASES = [
    pytest.param((300 * 1024 - 517,), 1024, 51, np.float32, id="ragged_1024"),
    pytest.param((8, 3, 1000), 1024, 5, np.float32, id="3d_ties_k5"),
    pytest.param((999,), 13, 3, np.float32, id="narrow_odd_13"),
    pytest.param((40, 51), 51, 3, np.float32, id="block_51"),
    pytest.param((4129,), 256, 5, jnp.bfloat16, id="bf16_256"),
    # wider than 1024 (the card's wide route): ragged last rows, odd widths
    pytest.param((3 * 1025 - 9,), 1025, 16, np.float32, id="wide_1025"),
    pytest.param((5, 1000), 2048, 32, np.float32, id="wide_2048"),
    pytest.param((2 * 3000 + 7,), 3000, 47, jnp.bfloat16, id="wide_3000"),
    pytest.param((3, 4096), 4096, 64, np.float32, id="wide_4096"),
    pytest.param((3 * 4097 - 100,), 4097, 64, np.float32, id="wide_4097"),
]


@pytest.mark.parametrize("shape,block,k,dtype", TOPK_CASES)
def test_block_topk_matches_pallas(shape, block, k, dtype):
    """K1's plain version against the reference's public ops.block_topk
    (the Pallas kernel in interpret mode): bit for bit, ties kept."""
    x = _topk_input(shape, block, 20 + k, dtype)
    want = np.asarray(jax_ops.block_topk(jnp.asarray(x), block=block, k=k)
                      .astype(jnp.float32))
    xt = torch.tensor(np.asarray(x, np.float32)).to(
        torch.bfloat16 if dtype == jnp.bfloat16 else torch.float32)
    got = ops.block_topk(xt, block=block, k=k)
    assert got.shape == xt.shape and got.dtype == xt.dtype
    np.testing.assert_array_equal(got.float().numpy(), want)
    if k < 7:                            # the 7 ties at 9.0 are all kept
        assert (got.reshape(-1)[2 * block:2 * block + 7] != 0).all()


@pytest.mark.parametrize("shape,block,k,dtype", TOPK_CASES[:4])
def test_block_topk_ref_matches_reference(shape, block, k, dtype):
    """The sort-based oracle: exactly k a block, the earliest index winning
    ties, as the reference's kernels/ref.py::block_topk_ref."""
    x = _topk_input(shape, block, 40 + k, dtype)
    want = np.asarray(jax_ref.block_topk_ref(jnp.asarray(x), block, k))
    got = ref.block_topk_ref(torch.tensor(x), block, k).numpy()
    np.testing.assert_array_equal(got, want)
    kept = (got.reshape(-1) != 0)
    nb = -(-x.size // block)
    per_block = np.pad(kept, (0, nb * block - x.size)).reshape(nb, block)
    assert (per_block[1:-1].sum(1) == k).all()   # the zero block keeps 0s


# --------------------------------------------------------------------------
# K2/K3 with bfloat16 EF state
# --------------------------------------------------------------------------

def _within_bf16_ulp(a, b, n=1):
    """|a - b| <= n bf16 ulps at the scale of the values (rtol 0)."""
    a, b = np.asarray(a, np.float32), np.asarray(b, np.float32)
    assert a.shape == b.shape
    top = np.float32(max(np.abs(a).max(), np.abs(b).max()))
    tol = n * np.spacing(top) * 2.0 ** 16      # 7 mantissa bits, not 23
    bad = np.abs(a.astype(np.float64) - b.astype(np.float64)) > tol
    assert not bad.any(), (f"{bad.sum()} values differ by more than {n} "
                           f"bf16 ulp; first at {np.argwhere(bad)[:3].tolist()}")


def _bf16_rows(x, nb, block):
    return _rows(x, nb, block).to(torch.bfloat16)


def _bf16_np(x):
    return np.asarray(jnp.asarray(x).astype(jnp.bfloat16))


def _run_bf16(kernel, d, block, k, zero_rows, eta, seed, **kw):
    """One K2 (kernel 'k2') or K3 launch on f32 grad and bf16 v, g in both
    packages; returns (port outputs, reference outputs) as f32 numpy."""
    grad, v, g = _inputs(d, seed, zero_rows, block)
    v, g = _bf16_np(v), _bf16_np(g)
    fn = jax_ef.ef21_sgdm_update if kernel == "k2" else \
        jax_fr.ef21_sgdm_topk_quant
    want = fn(jnp.asarray(grad), jnp.asarray(v), jnp.asarray(g), eta=eta,
              block=block, k=k, interpret=True, **kw)
    nb = -(-d // block)
    pfn = ops.ef21_sgdm_update if kernel == "k2" else \
        ops.ef21_sgdm_topk_quant
    got = pfn(_rows(grad, nb, block),
              _bf16_rows(v.astype(np.float32), nb, block),
              _bf16_rows(g.astype(np.float32), nb, block), eta=eta, k=k, **kw)
    n_state = 3 if kernel == "k2" else 2     # v', g' (and K2's c) are bf16
    for t, w in zip(got[:n_state], want[:n_state]):
        assert t.dtype == torch.bfloat16 and w.dtype == jnp.bfloat16
    out = [_unrows(t.float(), d) for t in got[:n_state]] + list(got[n_state:])
    return out, [np.asarray(jnp.asarray(x).astype(jnp.float32))
                 if i < n_state else np.asarray(x) for i, x in enumerate(want)]


@pytest.mark.parametrize("d,block,k,zero_rows", CASES + ODD_CASES)
def test_ef21_sgdm_update_bf16_state_matches_pallas(d, block, k, zero_rows):
    """η = 0.5: every product exact, one f32 rounding of each sum in both
    packages, then one bf16 rounding: v', g' and c equal bit for bit."""
    (vt, gt, ct), (vj, gj, cj) = _run_bf16("k2", d, block, k, zero_rows,
                                           0.5, 12)
    np.testing.assert_array_equal(ct, cj)
    np.testing.assert_array_equal(vt, vj)
    np.testing.assert_array_equal(gt, gj)


@pytest.mark.parametrize("d,block,k,zero_rows", CASES + ODD_CASES)
def test_ef21_sgdm_update_bf16_state_at_main_path_eta(d, block, k,
                                                      zero_rows):
    """η = 0.2: the reference's fused multiply-add moves the f32 v' by up to
    an ulp, which the bf16 store almost always absorbs: within one bf16
    ulp, the masks equal."""
    (vt, gt, ct), (vj, gj, cj) = _run_bf16("k2", d, block, k, zero_rows,
                                           0.2, 14)
    np.testing.assert_array_equal(ct != 0, cj != 0)
    _within_bf16_ulp(vt, vj)
    _within_bf16_ulp(ct, cj)
    _within_bf16_ulp(gt, gj)


@pytest.mark.parametrize("eta", [0.5, 0.2])
@pytest.mark.parametrize("d,block,k,zero_rows,bits", K3_CASES)
def test_ef21_sgdm_topk_quant_bf16_state_matches_pallas(d, block, k,
                                                        zero_rows, bits,
                                                        eta):
    """K3 with bf16 state. η = 0.5: mantissas, scales and v' equal, g'
    (where the reference fuses g + q·scale into one rounding) within one
    bf16 ulp. η = 0.2: v' within one bf16 ulp, the masks equal, a mantissa
    by at most one grid step, the scales within two f32 ulps, g' within one
    bf16 ulp."""
    (vt, gt, qt, st), (vj, gj, qj, sj) = _run_bf16(
        "k3", d, block, k, zero_rows, eta, 16 + bits, bits=bits)
    if eta == 0.5:
        np.testing.assert_array_equal(qt.numpy(), qj)
        np.testing.assert_array_equal(st.numpy(), sj)
        np.testing.assert_array_equal(vt, vj)
    else:
        mt, mj = _decode(qt, st, bits, block), _decode(qj, sj, bits, block)
        ones = np.ones_like(st.numpy())
        steps = np.abs(_decode(qt, ones, bits, block)
                       - _decode(qj, ones, bits, block))
        np.testing.assert_array_equal(mt != 0, mj != 0)
        assert steps.max() <= 1.0
        _within_bf16_ulp(vt, vj)
        _within_ulp(st.numpy(), sj, 2)
    _within_bf16_ulp(gt, gj)


# ---------------------------------------------------------------------------
# the bisection's early exit (kernels/csrc/bisect.cuh)
# ---------------------------------------------------------------------------

def _early_exit_kept(ab: torch.Tensor, k: int):
    """An emulation, row by row, of bisect.cuh's loop: the 26-step
    bisection that stops once count(|x| >= lo) == k or count(|x| >= lo) ==
    count(|x| >= hi) (hi's count unknown until hi first moves, lo's taken
    as the row's present count until lo first moves). ``ab`` holds the
    present |values| of each row. Returns the kept masks {ab >= lo} and the
    passes each row took."""
    rows, width = ab.shape
    hi = ab.amax(dim=1)
    lo = torch.zeros_like(hi)
    cnt_lo = torch.full((rows,), width, dtype=torch.int64)
    cnt_hi = torch.full((rows,), -1, dtype=torch.int64)
    done = torch.zeros(rows, dtype=torch.bool)
    passes = torch.zeros(rows, dtype=torch.int64)
    for _ in range(ref.BISECT_ITERS):
        live = ~done
        if not bool(live.any()):
            break
        mid = 0.5 * (lo + hi)
        cnt = (ab >= mid[:, None]).sum(dim=1)
        up, down = live & (cnt >= k), live & (cnt < k)
        lo, cnt_lo = torch.where(up, mid, lo), torch.where(up, cnt, cnt_lo)
        hi, cnt_hi = (torch.where(down, mid, hi),
                      torch.where(down, cnt, cnt_hi))
        passes += live
        done = done | (cnt_lo == k) | (cnt_lo == cnt_hi)
    return ab >= lo[:, None], passes


def _adversarial_rows(case: str, k: int) -> torch.Tensor:
    """(rows, width) f32 values of one adversarial family."""
    rng = np.random.RandomState(k + len(case))
    x = rng.randn(64, 1024).astype(np.float32)
    if case == "gaussian":
        pass
    elif case == "all_zero":
        x[::2] = 0.0
    elif case == "ties_at_max":                       # k and k+4 ties
        x[0, :k] = 9.0
        x[1, 5:5 + k + 4] = -9.0
        x[2, :k] = 9.0
        x[2, k:k + 3] = -9.0
    elif case == "k_above_width":                     # a ragged 12-wide row
        x = x[:, :12]
    elif case == "zeros_and_subnormals":
        x[:, ::3] = 0.0
        x[:, 1::3] = -0.0
        x[:, 2::6] = np.float32(1e-40) * rng.randint(1, 100, (64, 171))
        x[::2, : 3 * k] = np.float32(-1e-42)
        x[1::4, :] = np.where(rng.rand(16, 1024) < 0.5, np.float32(1e-45),
                              np.float32(-0.0))
    elif case == "near_kth":                          # the k-th and (k+1)-th
        mx = np.float32(3.0)                          # within 2^-26 * max
        x = np.clip(x, -2.0, 2.0)
        x[:, 0] = mx
        x[:, 1:k] = 2.5
        x[:, k] = np.float32(2.5) - np.float32(2.0 ** -26) * mx * \
            rng.rand(64).astype(np.float32)
    elif case == "ragged_1000":                       # K2/K3's 1000-wide rows
        x = x[:, :1000]
    elif case == "padded_last_row":                   # K1: a leaf padded
        flat = x.reshape(-1)[:64 * 1024 - 617]        # with counted zeros
        x = ref._flat_rows(torch.tensor(flat), 1024).numpy()
    elif case == "wide_4097":                         # the wide route's rows
        x = rng.randn(16, 4097).astype(np.float32)    # (a CTA a row), ties
        x[0, :k + 3] = 7.0                            # across k, a zero row
        x[1] = 0.0
    return torch.tensor(x)


@pytest.mark.parametrize("k", [16, 51])
@pytest.mark.parametrize("case", [
    "gaussian", "all_zero", "ties_at_max", "k_above_width",
    "zeros_and_subnormals", "near_kth", "ragged_1000", "padded_last_row",
    "wide_4097"])
def test_bisect_early_exit_keeps_the_26_step_set(case, k):
    """The early exit keeps, mask for mask, the set that the full 26-step
    bisection keeps (ref.bisect_threshold_plain, as block_topk_plain and
    the EF kernels' plain versions use it), and never takes more than 26
    passes; on Gaussian rows it stops after about 8-10. The rule is a row's
    own: a warp decides it for its row, and on rows wider than 1024 a CTA
    decides it for its row on the CTA's summed counts (csrc/wide.cuh), so
    this emulation holds both."""
    x = _adversarial_rows(case, k)
    ab = x.abs()
    want = ab >= ref.bisect_threshold_plain(ab, k)[:, None]
    got, passes = _early_exit_kept(ab, k)
    assert torch.equal(got, want)
    assert int(passes.max()) <= ref.BISECT_ITERS
    if x.shape[1] == 1024:                  # block_topk_plain's kept set
        kept = ref.block_topk_plain(x, block=1024, k=k)
        assert torch.equal(kept, torch.where(want, x, torch.zeros_like(x)))
    if case == "gaussian":
        assert float(passes.float().mean()) <= 12
    if case == "all_zero":                  # nothing to decide: 26 passes
        assert bool((passes[::2] == ref.BISECT_ITERS).all())
