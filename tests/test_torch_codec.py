"""The wire codec of the quantized carriers — K5 block_quantize and K6
block_dequantize (src/repro_torch/kernels/csrc/codec.cu) — on the CPU, where
their wrappers run the plain versions, against the reference's Pallas
kernels (src/repro/kernels/quantize.py) in interpret mode, jitted as the
reference's runtime runs them, on the same numpy inputs.

Exact: mantissas, scales and decodes. Under jit, XLA turns the reference's
``absmax / qmax`` into a multiply by the f32 reciprocal of qmax, which is
what the port computes (kernels/ref.py::qmax_recip). The Pallas kernel takes
even blocks only at 4 bits; odd widths, which the downlink's sparse payload
has (51 values a block), exist only in the reference's oracle
(kernels/ref.py::block_quantize_ref, a zero mantissa padding the last
byte), and are held against it.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import quantize as jax_qz
from repro.kernels import ref as jax_ref
from repro_torch.kernels import ops


def _x(rows, cols, seed):
    """Rows at three magnitudes, an all-zero row, ±inf and NaN, and a row
    on the half-grid (values that round to even)."""
    rng = np.random.RandomState(seed)
    mag = rng.choice([1e-3, 1.0, 50.0], size=(rows, 1))
    x = (rng.randn(rows, cols) * mag).astype(np.float32)
    x[1] = 0.0
    x[2, 0] = np.inf
    x[2, cols // 2] = np.nan
    x[3, -1] = -np.inf
    x[4] = (np.arange(cols) % 15 - 7) * 0.5
    return x


@pytest.mark.parametrize("cols", [16, 64, 256, 1024])
@pytest.mark.parametrize("bits", [8, 4])
def test_codec_matches_pallas(bits, cols):
    rows = 24
    x = _x(rows, cols, cols + bits)
    qj, sj = jax.jit(functools.partial(
        jax_qz.block_quantize, block=cols, bits=bits, interpret=True))(
        jnp.asarray(x))
    qt, st = ops.block_quantize(torch.tensor(x), bits)
    np.testing.assert_array_equal(qt.numpy(), np.asarray(qj))
    np.testing.assert_array_equal(st.numpy(), np.asarray(sj))
    assert st[1] == 0 and np.isfinite(st.numpy()).all()
    dj = jax.jit(functools.partial(
        jax_qz.block_dequantize, d=rows * cols, block=cols, bits=bits,
        interpret=True))(qj, sj)
    dt = ops.block_dequantize(qt, st, bits, cols)
    np.testing.assert_array_equal(dt.numpy().reshape(-1), np.asarray(dj))
    assert not dt[1].any() and not dt[2, 0] and not dt[3, -1]


@pytest.mark.parametrize("cols", [1, 17, 51, 255])
@pytest.mark.parametrize("bits", [8, 4])
def test_odd_widths_match_the_oracle(bits, cols):
    rows = 9
    x = _x(rows, max(cols, 5), 100 + cols + bits)[:, :cols].copy()
    qj, sj = jax.jit(jax_ref.block_quantize_ref, static_argnums=1)(
        jnp.asarray(x), bits)
    qt, st = ops.block_quantize(torch.tensor(x), bits)
    assert qt.shape == ((rows, cols) if bits == 8 else (rows, (cols + 1) // 2))
    np.testing.assert_array_equal(qt.numpy(), np.asarray(qj))
    np.testing.assert_array_equal(st.numpy(), np.asarray(sj))
    dj = jax.jit(functools.partial(jax_ref.block_dequantize_ref, bits=bits,
                                   cols=cols))(qj, sj)
    np.testing.assert_array_equal(
        ops.block_dequantize(qt, st, bits, cols).numpy(), np.asarray(dj))


def test_codec_wrappers_reject_what_the_kernels_do_not_take():
    x = torch.zeros(4, 6)
    with pytest.raises(ValueError, match="bits"):
        ops.block_quantize(x, 2)
    with pytest.raises(ValueError, match="dtype"):
        ops.block_quantize(x.double(), 8)
    with pytest.raises(ValueError, match="contiguous"):
        ops.block_quantize(torch.zeros(6, 4).t(), 8)
    with pytest.raises(ValueError, match="rows, cols"):
        ops.block_quantize(torch.zeros(24), 8)
    q, s = ops.block_quantize(x, 4)
    assert q.shape == (4, 3) and q.dtype == torch.uint8
    with pytest.raises(ValueError, match="shape"):
        ops.block_dequantize(q, s, 4, 8)              # 8 values need 4 bytes
    with pytest.raises(ValueError, match="dtype"):
        ops.block_dequantize(q, s, 8, 3)              # 8 bits are int8
    with pytest.raises(ValueError, match="scales"):
        ops.block_dequantize(q, s[:2], 4, 6)


@pytest.mark.cuda
@pytest.mark.parametrize("cols,offset,want", [
    (16, 0, "vector"), (32, 0, "vector"), (256, 0, "vector"),
    (1024, 0, "vector"), (16, 1, "scalar"), (256, 3, "scalar"),
    (51, 0, "scalar"), (17, 0, "scalar"), (1, 0, "scalar"),
    (1026, 0, "wide"), (2_359_296, 0, "wide")])
def test_codec_mapping_follows_shape_and_alignment(cols, offset, want):
    """The mapping the card's K5/K6 run (csrc/codec.cu, asked of the built
    library), chosen from the shape and the base addresses alone: vector
    for widths that are a multiple of 4, up to 1024, with input and output
    on 16-byte boundaries; wide above 1024; scalar otherwise. ``offset``
    elements into a buffer move the input's base."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the rule lives in the built library")
    buf = torch.zeros(offset + 2 * cols, device="cuda")
    t = buf[offset:].view(2, cols)
    assert t.is_contiguous() and (t.data_ptr() % 16 == 0) == (offset == 0)
    out = torch.empty(2, cols, dtype=torch.int8, device="cuda")
    assert ops.codec_mapping(t, out, cols) == want
    assert ops.codec_mapping(out, t, cols) == want
