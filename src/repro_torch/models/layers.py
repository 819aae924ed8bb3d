"""Transformer building blocks of the dense family (counterpart of
src/repro/models/layers.py): RMSNorm, split-half RoPE (its cos and sin
read from tables cached per head dim, theta, device and length), causal
GQA attention (chunked, and decode against a KV cache) and the SwiGLU MLP.

Training runs ``chunked_attention``, plain PyTorch as it is plain JAX in the
reference; its large products go to ``torch.einsum``. Serving's prefill
runs the hand flash-attention kernel K7 (``kernels/ops.flash_attention``)
where the reference runs ``chunked_attention``: the same causal softmax
attention. In bf16, K7 (on the tensor cores) rounds P to bf16 for P.V as
chunked attention rounds it to v's dtype, but unnormalised, against its
running max, with l summed from the f32 P; in f32 neither rounds P. K7 has
no backward, so training keeps chunked attention. Decode is plain PyTorch,
as in the reference. Sliding windows and soft caps arrive with the slice
that brings the families using them (gemma2, h2o-danube).
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.kernels import ops

Cache = Tuple[torch.Tensor, torch.Tensor]


def rms_norm(x: torch.Tensor, scale: torch.Tensor, eps: float = 1e-6
             ) -> torch.Tensor:
    """RMSNorm in f32 that scales by (1 + scale), back in x's dtype."""
    dt = x.dtype
    x = x.float()
    x = x * torch.rsqrt(torch.mean(x * x, dim=-1, keepdim=True) + eps)
    return (x * (1.0 + scale.float())).to(dt)


def _rope_freqs(hd: int, theta: float, device) -> torch.Tensor:
    return 1.0 / (theta ** (torch.arange(0, hd, 2, dtype=torch.float32,
                                         device=device) / hd))


def rope(x: torch.Tensor, positions: torch.Tensor, theta: float = 10000.0
         ) -> torch.Tensor:
    """Split-half rotary embedding. x: (..., S, H, hd); positions: (..., S).
    The direct computation; the model reads the same values from
    :func:`rope_tables` (see :func:`rope_at`)."""
    freqs = _rope_freqs(x.shape[-1], theta, x.device)
    ang = positions[..., None].float() * freqs              # (..., S, hd/2)
    return apply_rope(x, torch.cos(ang)[..., None, :],
                      torch.sin(ang)[..., None, :])


def apply_rope(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor
               ) -> torch.Tensor:
    """Rotate x (..., S, H, hd) by cos and sin (..., S, 1, hd/2), in f32."""
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


_ROPE_TABLES: Dict[tuple, Tuple[torch.Tensor, torch.Tensor]] = {}


def rope_tables(hd: int, theta: float, length: int, device
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """cos and sin (L, hd/2) of positions 0 .. L-1, L the power of two at
    or above ``length``, cached per (hd, theta, device, L). Each entry is
    the computation :func:`rope` makes for that position, element by
    element (an exact integer times the same f32 frequencies, then cos and
    sin), so a gathered row equals the direct computation bit for bit."""
    n = 1 << max(int(length) - 1, 0).bit_length()
    key = (hd, float(theta), str(torch.device(device)), n)
    if key not in _ROPE_TABLES:
        ang = torch.arange(n, device=device).float()[:, None] * \
            _rope_freqs(hd, theta, device)
        _ROPE_TABLES[key] = (torch.cos(ang), torch.sin(ang))
    return _ROPE_TABLES[key]


def rope_at(positions: torch.Tensor, hd: int, theta: float, length: int
            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """cos and sin (..., S, 1, hd/2) for :func:`apply_rope` at ``positions``
    (..., S), read from the cached tables; every position must lie below
    ``length``."""
    cos, sin = rope_tables(hd, theta, length, positions.device)
    return cos[positions][..., None, :], sin[positions][..., None, :]


def chunked_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                      chunk: int = 512) -> torch.Tensor:
    """Causal GQA attention, one block of ``chunk`` queries at a time so the
    live score tensor stays (B, KV, G, chunk, S). q: (B,S,H,hd); k, v:
    (B,S,KV,hd). Scores and softmax in f32, probabilities in v's dtype."""
    B, Sq, H, hd = q.shape
    Skv, KV = k.shape[1], k.shape[2]
    G = H // KV
    chunk = min(chunk, Sq)
    kf = k.float()
    kv_pos = torch.arange(Skv, device=q.device)
    outs = []
    for start in range(0, Sq, chunk):
        qi = q[:, start:start + chunk]
        cq = qi.shape[1]
        qi = qi.reshape(B, cq, KV, G, hd).float() / (hd ** 0.5)
        s = torch.einsum("bqngd,bknd->bngqk", qi, kf)
        q_pos = start + torch.arange(cq, device=q.device)
        bias = torch.where(kv_pos[None, :] <= q_pos[:, None], 0.0, -1e30)
        p = torch.softmax(s + bias, dim=-1).to(v.dtype)
        o = torch.einsum("bngqk,bknd->bqngd", p, v)
        outs.append(o.reshape(B, cq, H, hd))
    return torch.cat(outs, dim=1)


def decode_attention(q: torch.Tensor, k_cache: torch.Tensor,
                     v_cache: torch.Tensor, pos: int) -> torch.Tensor:
    """One-token attention against a cache. q: (B,1,H,hd); caches
    (B,S,KV,hd) holding position p at slot p; ``pos`` is the new token's
    position. Scores and softmax in f32 over the slots <= pos, P rounded to
    the cache's dtype before P.V (the reference's ``_gqa_out``)."""
    B, _, H, hd = q.shape
    S, KV = k_cache.shape[1], k_cache.shape[2]
    qg = q.reshape(B, 1, KV, H // KV, hd).float() / (hd ** 0.5)
    s = torch.einsum("bqngd,bknd->bngqk", qg, k_cache.float())
    slot = torch.arange(S, device=q.device)
    bias = torch.where(slot <= pos, 0.0, -1e30)
    p = torch.softmax(s + bias, dim=-1).to(v_cache.dtype)
    o = torch.einsum("bngqk,bknd->bqngd", p, v_cache)
    return o.reshape(B, 1, H, hd)


def attn_apply(p: Dict[str, torch.Tensor], x: torch.Tensor,
               rope_cs: Tuple[torch.Tensor, torch.Tensor], *, eps: float,
               chunk: int, cache: Optional[Cache] = None,
               pos: Optional[int] = None) -> torch.Tensor:
    """Pre-norm attention sub-block; returns the residual delta.
    ``rope_cs``: the cos and sin of x's positions (:func:`rope_at`).

    Modes:
      cache None                → training: chunked attention, no cache;
      cache (k, v), pos None    → prefill of x's S tokens: K7 on the fresh
                                  k and v, then slots [0, S) of the cache
                                  are written in the cache's dtype;
      cache (k, v), pos an int  → decode of one token at position ``pos``:
                                  slot ``pos`` is written, then attention
                                  runs over the cache.
    The cache tensors are written IN PLACE (the reference returns updated
    copies).
    """
    h = rms_norm(x, p["norm"], eps)
    q = torch.einsum("bsd,dnh->bsnh", h, p["wq"].to(h.dtype))
    k = torch.einsum("bsd,dnh->bsnh", h, p["wk"].to(h.dtype))
    v = torch.einsum("bsd,dnh->bsnh", h, p["wv"].to(h.dtype))
    q = apply_rope(q, *rope_cs)
    k = apply_rope(k, *rope_cs)
    if cache is None:
        out = chunked_attention(q, k, v, chunk=chunk)
    elif pos is None:
        out = ops.flash_attention(q.contiguous(), k.contiguous(),
                                  v.contiguous(), causal=True)
        n = min(k.shape[1], cache[0].shape[1])   # as the reference: k[:, :S]
        cache[0][:, :n] = k[:, :n]
        cache[1][:, :n] = v[:, :n]
    else:
        cache[0][:, pos] = k[:, 0]
        cache[1][:, pos] = v[:, 0]
        out = decode_attention(q, cache[0], cache[1], pos)
    return torch.einsum("bsnh,nhd->bsd", out, p["wo"].to(out.dtype))


def mlp_apply(p: Dict[str, torch.Tensor], x: torch.Tensor, eps: float
              ) -> torch.Tensor:
    """Pre-norm SwiGLU MLP; returns the residual delta."""
    h = rms_norm(x, p["norm"], eps)
    g = torch.einsum("bsd,df->bsf", h, p["w_gate"].to(h.dtype))
    u = torch.einsum("bsd,df->bsf", h, p["w_up"].to(h.dtype))
    out = F.silu(g) * u
    return torch.einsum("bsf,fd->bsd", out, p["w_down"].to(out.dtype))
