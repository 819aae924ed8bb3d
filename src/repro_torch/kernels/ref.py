"""Plain PyTorch versions of the hand kernels.

Each ``*_plain`` function repeats its Pallas body step by step — the same
f32 operations in the same order, the 26-step threshold bisection included —
so it is bit-for-bit what the CUDA kernel in ``csrc/`` computes. They are
what the kernel wrappers (``kernels/ops.py``) run on CPU tensors and what
``chip_smoke.py`` holds each kernel against on the card. They are NOT the
sort-based ``block_topk_ref`` of the reference, which keeps exactly k with
the earliest index winning ties (a different tie rule).

Every function takes the row view the kernels take: ``(rows, block)``
tensors, one selection/quantization block per row.
"""
from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

BISECT_ITERS = 26


def _coeffs(eta: float) -> Tuple[float, float]:
    # the f32 constants the Pallas body multiplies by: (1 - eta) is taken in
    # double precision by the caller and rounded to f32 once, like eta
    return float(np.float32(1.0 - eta)), float(np.float32(eta))


def qmax_recip(bits: int) -> float:
    """f32(1/qmax). The reference writes ``absmax / qmax``; XLA compiles a
    division by a constant into a multiply by its f32 reciprocal (inside jit
    and in the Pallas interpreter alike), so the scale on the reference's
    wire is ``absmax * f32(1/qmax)``, and so is the port's."""
    return float(np.float32(1.0) / np.float32(2 ** (bits - 1) - 1))


def bisect_threshold_plain(ab: torch.Tensor, k: int) -> torch.Tensor:
    """Per row of ``ab`` (|values|, (rows, block) f32): the largest t found by
    exactly ``BISECT_ITERS`` halvings of [0, max|x|] such that
    count(ab >= t) >= k (kernels/topk_compress.py::_bisect_threshold)."""
    hi = ab.amax(dim=1)
    lo = torch.zeros_like(hi)
    for _ in range(BISECT_ITERS):
        mid = 0.5 * (lo + hi)
        ok = (ab >= mid[:, None]).sum(dim=1) >= k
        lo = torch.where(ok, mid, lo)
        hi = torch.where(ok, hi, mid)
    return lo


def _momentum_select(grad, v, g, eta: float, k: int):
    c1, c2 = _coeffs(eta)
    v_new = c1 * v + c2 * grad
    delta = v_new - g
    ab = delta.abs()
    t = bisect_threshold_plain(ab, k)
    c = torch.where(ab >= t[:, None], delta, torch.zeros_like(delta))
    return v_new, c


def ef21_sgdm_update_plain(grad: torch.Tensor, v: torch.Tensor,
                           g: torch.Tensor, *, eta: float, k: int
                           ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """kernels/ef_update.py::_ef_kernel — v' = (1-eta)v + eta*grad;
    c = keep (v' - g) where |v' - g| >= the bisection threshold; g' = g + c.
    Returns (v', g', c)."""
    v_new, c = _momentum_select(grad, v, g, eta, k)
    return v_new, g + c, c


def ef21_sgdm_topk_quant_plain(grad: torch.Tensor, v: torch.Tensor,
                               g: torch.Tensor, *, eta: float, k: int,
                               bits: int):
    """kernels/fused_round.py::_fused_uplink_kernel — the K2 chain, then per
    row absmax quantization of c (scale = absmax * f32(1/qmax), round half
    to even, non-finite -> 0) and g' = g + q*scale (the EF invariant).
    Returns (v', g', q, scales): q int8
    (rows, block) for bits=8, packed uint4 (rows, block/2) for bits=4 (+8
    offset, high nibble first), scales f32 (rows,)."""
    v_new, c = _momentum_select(grad, v, g, eta, k)
    c = torch.where(torch.isfinite(c), c, torch.zeros_like(c))
    qmax = float(2 ** (bits - 1) - 1)
    scale = c.abs().amax(dim=1) * qmax_recip(bits)
    safe = torch.where(scale > 0, scale, torch.ones_like(scale))
    q = torch.clamp(torch.round(c / safe[:, None]), -qmax, qmax)
    g_new = g + q * scale[:, None]
    return v_new, g_new, _pack(q, bits), scale


def dequant_add_plain(q: torch.Tensor, scales: torch.Tensor,
                      base: torch.Tensor, *, block: int, bits: int,
                      alpha: float = 1.0) -> torch.Tensor:
    """kernels/fused_round.py::_dequant_add_kernel — base + alpha*(q*scale).
    ``base`` holds the first d of the nb*block decoded slots (flat layout);
    the result has base's shape and dtype."""
    nb, d = q.shape[0], base.numel()
    dec = block_dequantize_plain(q, scales, bits=bits, cols=block)
    if alpha != 1.0:
        dec = alpha * dec
    bb = torch.nn.functional.pad(base.reshape(-1).float(),
                                 (0, nb * block - d)).reshape(nb, block)
    return (bb + dec).to(base.dtype).reshape(-1)[:d].reshape(base.shape)


# ---------------------------------------------------------------------------
# wire codec (kernels/quantize.py::block_quantize / block_dequantize, K5/K6)
# ---------------------------------------------------------------------------

def _pack(q: torch.Tensor, bits: int) -> torch.Tensor:
    if bits == 8:
        return q.to(torch.int8)
    if q.shape[1] % 2:
        q = torch.nn.functional.pad(q, (0, 1))
    u = (q + 8.0).to(torch.uint8).reshape(q.shape[0], -1, 2)
    return (u[:, :, 0] << 4) | u[:, :, 1]


def block_quantize_plain(x: torch.Tensor, bits: int
                         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """kernels/quantize.py::_quant_kernel (and the oracle
    kernels/ref.py::block_quantize_ref) — per-row absmax quantization of a
    (rows, cols) array: scale = absmax * f32(1/qmax) with
    qmax = 2^(bits-1)-1 (``qmax_recip``), q = round(x/scale) in
    [-qmax, qmax]; non-finite inputs count as 0 and an all-zero row gets
    scale 0. Returns (q, scales) in the layout of ``_pack`` (an odd row is
    padded with one zero mantissa at 4 bits)."""
    x = x.float()
    x = torch.where(torch.isfinite(x), x, torch.zeros_like(x))
    qmax = float(2 ** (bits - 1) - 1)
    scale = x.abs().amax(dim=1) * qmax_recip(bits)
    safe = torch.where(scale > 0, scale, torch.ones_like(scale))
    q = torch.clamp(torch.round(x / safe[:, None]), -qmax, qmax)
    return _pack(q, bits), scale


def block_dequantize_plain(q: torch.Tensor, scales: torch.Tensor, *,
                           bits: int, cols: int) -> torch.Tensor:
    """kernels/quantize.py::_dequant_kernel — the inverse of
    :func:`block_quantize_plain`: q*scale per row, f32 (rows, cols)."""
    if bits == 8:
        vals = q.float()
    else:
        hi = (q >> 4).float() - 8.0
        lo = (q & 0xF).float() - 8.0
        vals = torch.stack([hi, lo], dim=-1).reshape(q.shape[0], -1)[:, :cols]
    return vals * scales.float()[:, None]
