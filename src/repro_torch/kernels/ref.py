"""Plain PyTorch versions of the hand kernels.

They are what the kernel wrappers (``kernels/ops.py``) run on CPU tensors
and what ``chip_smoke.py`` holds each kernel against on the card.

The Block-TopK, EF and codec functions (K1-K6) repeat their Pallas bodies
step by step — the same f32 operations in the same order, the 26-step
threshold bisection included — so each is bit-for-bit what its CUDA kernel
in ``csrc/`` computes. K2-K6 take the row view the kernels take: ``(rows,
block)`` tensors, one selection/quantization block per row; K1 takes any
shape, as the reference's ``block_topk`` does. The EF state (v, g) of K2
and K3 is f32 or bfloat16: it is widened to f32, the arithmetic is f32, and
the state's outputs are rounded back to its dtype.

Three tie rules for Block-TopK live side by side and are never compared
with one another: the bisection (``block_topk_plain`` and the EF kernels)
keeps every value at or above its 26-step threshold; ``block_topk_ref``,
the reference's sort-based oracle, keeps exactly k with the earliest index
winning ties; ``BlockTopK.__call__`` (core/compressors.py) keeps everything
at or above the k-th largest magnitude.

``flash_attention_plain`` (K7) is the reference's materialised-softmax
oracle (P in f32); with ``round_p=True`` it makes the roundings of K7's
bf16 tensor-core route (P rounded to bf16 for P.V). The kernels' online
softmax sums in another order, so each agrees with it within a tolerance,
not bit for bit.
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


def _flat_rows(x: torch.Tensor, block: int) -> torch.Tensor:
    """The (nb, block) row view of x flattened and zero-padded."""
    d = x.numel()
    nb = -(-d // block)
    return torch.nn.functional.pad(x.reshape(-1), (0, nb * block - d)) \
        .reshape(nb, block)


def block_topk_plain(x: torch.Tensor, *, block: int = 1024,
                     k: int = 16) -> torch.Tensor:
    """kernels/topk_compress.py::block_topk — x (any shape) flattened and
    zero-padded to rows of ``block``; per row the 26-step bisection
    threshold t on |x| in f32, and x kept where |x| >= t (ties kept). The
    result has x's shape and dtype."""
    xb = _flat_rows(x, block)
    xf = xb.float()
    ab = xf.abs()
    t = bisect_threshold_plain(ab, k)
    out = torch.where(ab >= t[:, None], xf, torch.zeros_like(xf)).to(x.dtype)
    return out.reshape(-1)[:x.numel()].reshape(x.shape)


def block_topk_ref(x: torch.Tensor, block: int, k: int) -> torch.Tensor:
    """kernels/ref.py::block_topk_ref of the reference, the sort-based
    Block-TopK: within each zero-padded block keep exactly the k largest
    |x|, the earliest index winning ties (a stable sort), zero elsewhere."""
    xb = _flat_rows(x, block)
    order = torch.argsort(-xb.abs(), dim=1, stable=True)
    ranks = torch.argsort(order, dim=1, stable=True)
    out = torch.where(ranks < k, xb, torch.zeros_like(xb))
    return out.reshape(-1)[:x.numel()].reshape(x.shape)


def _momentum_select(grad, v, g, eta: float, k: int):
    """v' and the selected c in f32, from the state widened to f32."""
    c1, c2 = _coeffs(eta)
    v_new = c1 * v.float() + c2 * grad.float()
    delta = v_new - g.float()
    ab = delta.abs()
    t = bisect_threshold_plain(ab, k)
    c = torch.where(ab >= t[:, None], delta, torch.zeros_like(delta))
    return v_new, c


def ef21_sgdm_update_plain(grad: torch.Tensor, v: torch.Tensor,
                           g: torch.Tensor, *, eta: float, k: int
                           ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """kernels/ef_update.py::_ef_kernel — v' = (1-eta)v + eta*grad;
    c = keep (v' - g) where |v' - g| >= the bisection threshold; g' = g + c,
    all in f32. Returns (v', g', c), each rounded to the state's dtype (c has
    g's dtype)."""
    v_new, c = _momentum_select(grad, v, g, eta, k)
    return v_new.to(v.dtype), (g.float() + c).to(g.dtype), c.to(g.dtype)


def ef21_sgdm_topk_quant_plain(grad: torch.Tensor, v: torch.Tensor,
                               g: torch.Tensor, *, eta: float, k: int,
                               bits: int):
    """kernels/fused_round.py::_fused_uplink_kernel — the K2 chain, then per
    row absmax quantization of c (scale = absmax * f32(1/qmax), round half
    to even, non-finite -> 0) and g' = g + q*scale (the EF invariant).
    Returns (v', g', q, scales): q int8
    (rows, block) for bits=8, packed uint4 (rows, block/2) for bits=4 (+8
    offset, high nibble first), scales f32 (rows,); v' and g' in the state's
    dtype."""
    v_new, c = _momentum_select(grad, v, g, eta, k)
    c = torch.where(torch.isfinite(c), c, torch.zeros_like(c))
    qmax = float(2 ** (bits - 1) - 1)
    scale = c.abs().amax(dim=1) * qmax_recip(bits)
    safe = torch.where(scale > 0, scale, torch.ones_like(scale))
    q = torch.clamp(torch.round(c / safe[:, None]), -qmax, qmax)
    g_new = g.float() + q * scale[:, None]
    return v_new.to(v.dtype), g_new.to(g.dtype), _pack(q, bits), scale


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


# ---------------------------------------------------------------------------
# attention (kernels/flash_attention.py::flash_attention, K7)
# ---------------------------------------------------------------------------

def flash_attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          *, causal: bool = True,
                          round_p: bool = False) -> torch.Tensor:
    """kernels/ref.py::flash_attention_ref of the reference, with GQA: q
    (B,S,H,hd), k and v (B,S,KV,hd). The kv heads are expanded with
    ``repeat_interleave`` (what ``jnp.repeat`` does), the softmax is
    materialised in f32, P.V is taken in f32 (P is not rounded to v's
    dtype), and the result is cast to q's dtype. Not bit-identical to the
    kernel, which sums in another order with an online softmax.

    ``round_p=True`` makes the roundings of K7's tensor-core (bf16) route:
    the scores are multiplied by f32(hd^-0.5) after the product, P =
    exp(s - rowmax) is rounded to bf16 for P.V while its row sum l is taken
    from the f32 P, and the output is (P_bf16 . V) / l. The kernel rounds P
    against its running max instead of the final one, so the two still
    differ by the order of the sums and by where P's one rounding falls."""
    B, S, H, hd = q.shape
    G = H // k.shape[2]
    kf = k.float().repeat_interleave(G, dim=2)
    vf = v.float().repeat_interleave(G, dim=2)
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), kf)
    s = s * float(np.float32(hd ** -0.5)) if round_p else s / (hd ** 0.5)
    if causal:
        mask = torch.ones(S, S, dtype=torch.bool, device=q.device).tril()
        s = s.masked_fill(~mask, float("-inf"))
    if not round_p:
        p = torch.softmax(s, dim=-1)
        return torch.einsum("bhqk,bkhd->bqhd", p, vf).to(q.dtype)
    p = torch.exp(s - s.amax(dim=-1, keepdim=True))
    l = p.sum(dim=-1, keepdim=True)
    o = torch.einsum("bhqk,bkhd->bhqd", p.to(torch.bfloat16).float(), vf) / l
    return o.transpose(1, 2).to(q.dtype)
