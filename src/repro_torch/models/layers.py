"""Transformer building blocks of the dense family (counterpart of
src/repro/models/layers.py): RMSNorm, split-half RoPE (its cos and sin
read from tables cached per head dim, theta, device and length), soft
caps, causal GQA attention (chunked, full or banded to a sliding window,
and decode against a KV cache, a ring buffer under a window) and the
SwiGLU MLP.

Training runs ``chunked_attention``, plain PyTorch as it is plain JAX in the
reference; its large products go to ``torch.einsum``. A sliding-window
layer runs the reference's banded schedule: each query chunk attends to a
``window + chunk`` slice of the keys. Serving's prefill runs the hand
flash-attention kernel K7 (``kernels/ops.flash_attention``) where the
reference runs ``chunked_attention`` on the layers K7 computes: no window,
no soft cap, a head dim K7 is built for (``ops.FLASH_HEAD_DIMS``); every
other layer prefills with ``chunked_attention``, as the reference does. In
bf16, K7 (on the tensor cores) rounds P to bf16 for P.V as chunked
attention rounds it to v's dtype, but unnormalised, against its running
max, with l summed from the f32 P; in f32 neither rounds P. K7 has no
backward, so training keeps chunked attention. Decode is plain PyTorch,
as in the reference.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.core import comm
from repro_torch.kernels import ops

Cache = Tuple[torch.Tensor, torch.Tensor]


@dataclasses.dataclass(frozen=True)
class TensorParallel:
    """Which parts of a block the 'model' axis ``axes`` splits (the
    reference's ``param_pspecs`` rules, models/model.py ``tp_plan``): the
    q heads (``wq`` and ``wo``), the kv heads (``wk``, ``wv``), the MLP's
    ``d_ff``, the vocabulary, the experts or, where they do not divide the
    axis, the experts' ``d_ff``; a mamba block's ``d_inner`` (Mamba2's
    heads with it, models/ssm.py). Each rank holds the contiguous block of a
    split dim at its index. Where a tensor every rank holds whole enters a
    split region, ``comm.copy_to`` (f) sums its gradient over the axis;
    where partial sums leave one, ``comm.reduce_from`` (g) sums them. An
    unsplit part runs whole on every rank with no collective, so its
    gradient is whole everywhere too."""

    axes: comm.Axes
    heads: bool = False
    kv: bool = False
    ff: bool = False
    vocab: bool = False
    experts: bool = False
    expert_ff: bool = False
    d_inner: bool = False


def rms_norm(x: torch.Tensor, scale: torch.Tensor, eps: float = 1e-6
             ) -> torch.Tensor:
    """RMSNorm in f32 that scales by (1 + scale), back in x's dtype."""
    dt = x.dtype
    x = x.float()
    x = x * torch.rsqrt(torch.mean(x * x, dim=-1, keepdim=True) + eps)
    return (x * (1.0 + scale.float())).to(dt)


def split_rms_norm(x: torch.Tensor, scale: torch.Tensor, eps: float,
                   axes: comm.Axes, width: int) -> torch.Tensor:
    """:func:`rms_norm` of a tensor whose last dim (``width`` in all) is
    split over ``axes``: x and ``scale`` are this rank's columns. The mean
    square is the local sums of squares summed over the axis (g) and
    divided by ``width``; every rank's columns are normalised by it, so its
    gradient, each rank's share, is summed over the axis too (f)."""
    dt = x.dtype
    x = x.float()
    ms = comm.reduce_to_all(axes, torch.sum(x * x, dim=-1, keepdim=True))
    x = x * torch.rsqrt(ms / width + eps)
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
    sin), so a gathered row equals the direct computation bit for bit.
    Meta tables (a dry run's trace) are built anew each call, so that
    every traced step allocates them as a first step does."""
    n = 1 << max(int(length) - 1, 0).bit_length()
    key = (hd, float(theta), str(torch.device(device)), n)
    if key not in _ROPE_TABLES:
        ang = torch.arange(n, device=device).float()[:, None] * \
            _rope_freqs(hd, theta, device)
        if torch.device(device).type == "meta":
            return torch.cos(ang), torch.sin(ang)
        _ROPE_TABLES[key] = (torch.cos(ang), torch.sin(ang))
    return _ROPE_TABLES[key]


def rope_at(positions: torch.Tensor, hd: int, theta: float, length: int
            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """cos and sin (..., S, 1, hd/2) for :func:`apply_rope` at ``positions``
    (..., S), read from the cached tables; every position must lie below
    ``length``."""
    cos, sin = rope_tables(hd, theta, length, positions.device)
    return cos[positions][..., None, :], sin[positions][..., None, :]


def softcap(x: torch.Tensor, cap: Optional[float]) -> torch.Tensor:
    """cap * tanh(x / cap); x itself without a cap."""
    if cap is None:
        return x
    return cap * torch.tanh(x / cap)


def _gqa_scores(q: torch.Tensor, k: torch.Tensor, cap: Optional[float]
                ) -> torch.Tensor:
    """q (B,Sq,KV,G,hd), k (B,Skv,KV,hd) -> f32 scores (B,KV,G,Sq,Skv),
    soft-capped."""
    s = torch.einsum("bqngd,bknd->bngqk", q.float() / (q.shape[-1] ** 0.5),
                     k.float())
    return softcap(s, cap)


def chunked_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                      chunk: int = 512, window: Optional[int] = None,
                      cap: Optional[float] = None) -> torch.Tensor:
    """Causal GQA attention, one block of ``chunk`` queries at a time so the
    live score tensor stays (B, KV, G, chunk, keys). q: (B,S,H,hd); k, v:
    (B,S,KV,hd). Scores and softmax in f32 (soft-capped by ``cap`` before
    the mask), probabilities in v's dtype.

    ``window`` W: query i sees keys i-W < j <= i, and each query chunk
    reads the reference's band of W + chunk keys, starting at
    clip(end of the chunk - (W + chunk), 0, S - (W + chunk))."""
    B, Sq, H, hd = q.shape
    Skv, KV = k.shape[1], k.shape[2]
    G = H // KV
    chunk = min(chunk, Sq)
    ws = Skv if window is None else min(window + chunk, Skv)
    kf = k.float()
    outs = []
    for start in range(0, Sq, chunk):
        qi = q[:, start:start + chunk]
        cq = qi.shape[1]
        # the band ends with the chunk, as long as a full chunk would be
        k0 = 0 if window is None else min(max(start + chunk - ws, 0),
                                          Skv - ws)
        ks, vs = kf[:, k0:k0 + ws], v[:, k0:k0 + ws]
        s = _gqa_scores(qi.reshape(B, cq, KV, G, hd), ks, cap)
        q_pos = start + torch.arange(cq, device=q.device)[:, None]
        k_pos = k0 + torch.arange(ws, device=q.device)[None, :]
        valid = k_pos <= q_pos
        if window is not None:
            valid = valid & (k_pos > q_pos - window)
        bias = torch.where(valid, 0.0, -1e30)
        p = torch.softmax(s + bias, dim=-1).to(v.dtype)
        o = torch.einsum("bngqk,bknd->bqngd", p, vs)
        outs.append(o.reshape(B, cq, H, hd))
    return torch.cat(outs, dim=1)


def slot_range(slots: int, seq: Optional[comm.Axes]) -> Tuple[int, int]:
    """[lo, hi): the slots of a cache of ``slots`` that this rank holds
    under a sequence split over ``seq`` (its contiguous block, the
    reference's sharding of the sequence dim); all of them without one.
    A split that does not divide the slots raises, as the reference's
    ``NamedSharding.shard_shape`` does."""
    if seq is None or seq.size == 1:
        return 0, slots
    if slots % seq.size:
        raise ValueError(
            f"a cache of {slots} slots splits its sequence over {seq.names}"
            f" ({seq.size} ranks), which does not divide it; the "
            "reference's NamedSharding.shard_shape raises there too "
            "(the tiling factors should evenly divide the shape)")
    n = slots // seq.size
    return seq.index * n, (seq.index + 1) * n


def decode_attention(q: torch.Tensor, k_cache: torch.Tensor,
                     v_cache: torch.Tensor, pos: int, *,
                     window: Optional[int] = None,
                     cap: Optional[float] = None,
                     seq: Optional[comm.Axes] = None) -> torch.Tensor:
    """One-token attention against a cache. q: (B,1,H,hd); caches
    (B,S,KV,hd); ``pos`` is the new token's position. A full cache holds
    position p at slot p and attends to the slots <= pos; a sliding-window
    cache is a ring of S slots holding p at slot p % S, every slot valid
    once pos >= S. Scores and softmax in f32 (soft-capped by ``cap``), P
    rounded to the cache's dtype before P.V (the reference's ``_gqa_out``).

    ``seq``: the caches are this rank's block of a sequence split over
    those axes (:func:`slot_range`), and the softmax runs in two passes
    over the split: the scores' max all-reduced (max), the local sums of
    exp(s − max) all-reduced (sum), P = exp(s − max) / sum rounded to the
    cache's dtype as without a split, and the P·V partials summed in f32
    over the axes. Each P is then the whole cache's up to the order of one
    sum."""
    B, _, H, hd = q.shape
    S, KV = k_cache.shape[1], k_cache.shape[2]
    s = _gqa_scores(q.reshape(B, 1, KV, H // KV, hd), k_cache, cap)
    n = 1 if seq is None else seq.size
    lo = slot_range(S * n, seq)[0]
    slot = lo + torch.arange(S, device=q.device)
    valid = slot <= pos
    if window is not None and pos >= S * n:     # a full ring: every slot
        valid = torch.ones_like(valid)
    bias = torch.where(valid, 0.0, -1e30)
    if n == 1:
        p = torch.softmax(s + bias, dim=-1).to(v_cache.dtype)
        o = torch.einsum("bngqk,bknd->bqngd", p, v_cache)
        return o.reshape(B, 1, H, hd)
    s = s + bias
    m = comm.seq_all_reduce(seq, s.amax(-1, keepdim=True), "max")
    e = torch.exp(s - m)
    total = comm.seq_all_reduce(seq, e.sum(-1, keepdim=True), "sum")
    p = (e / total).to(v_cache.dtype)
    o = torch.einsum("bngqk,bknd->bqngd", p.float(), v_cache.float())
    o = comm.seq_all_reduce(seq, o, "sum").to(v_cache.dtype)
    return o.reshape(B, 1, H, hd)


def prefill_runs_flash(hd: int, window: Optional[int],
                       cap: Optional[float]) -> bool:
    """Whether a layer's prefill runs K7: it computes plain causal attention
    at the head dims it is built for, with no window and no soft cap."""
    return window is None and cap is None and hd in ops.FLASH_HEAD_DIMS


def attn_apply(p: Dict[str, torch.Tensor], x: torch.Tensor,
               rope_cs: Tuple[torch.Tensor, torch.Tensor], *, eps: float,
               chunk: int, window: Optional[int] = None,
               cap: Optional[float] = None, cache: Optional[Cache] = None,
               pos: Optional[int] = None,
               tp: Optional[TensorParallel] = None,
               seq: Optional[comm.Axes] = None) -> torch.Tensor:
    """Pre-norm attention sub-block; returns the residual delta.
    ``rope_cs``: the cos and sin of x's positions (:func:`rope_at`);
    ``window``: the layer's sliding window; ``cap``: its score soft cap.

    Modes:
      cache None                → training: chunked attention, no cache;
      cache (k, v), pos None    → prefill of x's S tokens: K7 where
                                  :func:`prefill_runs_flash`, else chunked
                                  attention; then slots [0, S) of the
                                  cache are written in its dtype, or, when
                                  a windowed cache is shorter than S, its
                                  last slots' keys rolled so position p
                                  sits at slot p % slots;
      cache (k, v), pos an int  → decode of one token at position ``pos``:
                                  slot ``pos`` (``pos % slots`` under a
                                  window) is written, then attention runs
                                  over the cache.
    The cache tensors are written IN PLACE (the reference returns updated
    copies). Under ``tp`` with the heads split, ``p`` holds this rank's
    heads: they run between f on the normed input and g on the output
    projection (Megatron's column- and row-parallel pair). A cache holds
    this rank's kv heads where ``tp.kv`` splits them, else every kv head:
    then all of them are written and the local q heads read theirs.

    ``seq``: the cache holds this rank's block of the slots of a sequence
    split over those axes (``shardings.cache_pspecs``): only the rank
    that owns a slot writes it, and decode merges the ranks' partial
    softmax sums (:func:`decode_attention`). Where the q heads split and
    the kv heads do not, q is gathered over 'model' first: each rank
    computes every head over its slots and keeps its own heads' rows, and
    no rank gathers the cache.
    """
    h = rms_norm(x, p["norm"], eps)
    split = tp is not None and tp.heads
    hs = comm.copy_to(tp.axes, h) if split else h
    q = torch.einsum("bsd,dnh->bsnh", hs, p["wq"].to(h.dtype))
    sel = slice(None)
    if split and not tp.kv:
        k, v, sel = _kv_for_local_heads(tp.axes, h, p, q.shape[2])
    else:
        k = torch.einsum("bsd,dnh->bsnh", hs, p["wk"].to(h.dtype))
        v = torch.einsum("bsd,dnh->bsnh", hs, p["wv"].to(h.dtype))
    q = apply_rope(q, *rope_cs)
    k = apply_rope(k, *rope_cs)
    kl, vl = k[:, :, sel], v[:, :, sel]        # the kv heads q reads
    n = 1 if seq is None else seq.size
    if cache is None:
        out = chunked_attention(q, kl, vl, chunk=chunk, window=window,
                                cap=cap)
    elif pos is None:
        # K7 has no window, no soft cap and only some head dims; the other
        # layers prefill as the reference prefills every layer
        if prefill_runs_flash(q.shape[-1], window, cap):
            out = ops.flash_attention(q.contiguous(), kl.contiguous(),
                                      vl.contiguous(), causal=True)
        else:
            out = chunked_attention(q, kl, vl, chunk=chunk, window=window,
                                    cap=cap)
        S, slots = k.shape[1], cache[0].shape[1] * n
        lo, hi = slot_range(slots, seq)
        if window is not None and S > slots:
            # the last `slots` keys, position p at slot p % slots
            for c, t in zip(cache, (k, v)):
                c.copy_(torch.roll(t[:, -slots:], S % slots,
                                   dims=1)[:, lo:hi])
        elif min(S, slots) > lo:
            m = min(S, slots, hi)      # as the reference: k[:, :slots]
            cache[0][:, :m - lo] = k[:, lo:m]
            cache[1][:, :m - lo] = v[:, lo:m]
    else:
        slots = cache[0].shape[1] * n
        slot = pos if window is None else pos % slots
        lo, hi = slot_range(slots, seq)
        if lo <= slot < hi:
            cache[0][:, slot - lo] = k[:, 0]
            cache[1][:, slot - lo] = v[:, 0]
        if n > 1 and split and not tp.kv:
            # every head over this rank's slots; its own heads' rows kept
            h_local = q.shape[2]
            q_all = comm.gather_last(tp.axes, q.reshape(*q.shape[:2], -1))
            out = decode_attention(
                q_all.reshape(*q.shape[:2], -1, q.shape[-1]), cache[0],
                cache[1], pos, window=window, cap=cap, seq=seq)
            out = out[:, :, tp.axes.index * h_local:
                      (tp.axes.index + 1) * h_local]
        else:
            out = decode_attention(q, cache[0][:, :, sel],
                                   cache[1][:, :, sel], pos, window=window,
                                   cap=cap, seq=seq)
    out = torch.einsum("bsnh,nhd->bsd", out, p["wo"].to(out.dtype))
    return comm.reduce_from(tp.axes, out) if split else out


def _kv_for_local_heads(axes: comm.Axes, h: torch.Tensor,
                        p: Dict[str, torch.Tensor], h_local: int):
    """k and v of a layer whose q heads are split and kv heads are not
    (granite's one kv head, gemma2's 8 on 16 ranks): projected whole, as
    every rank holds ``wk``/``wv`` whole, then f (the local heads' share of
    their gradient summed over the axis, so the replicated weights get
    their whole gradient); and the slice of the kv heads this rank's q
    heads read, grouped as the local heads are."""
    k = torch.einsum("bsd,dnh->bsnh", h, p["wk"].to(h.dtype))
    v = torch.einsum("bsd,dnh->bsnh", h, p["wv"].to(h.dtype))
    k, v = comm.copy_to(axes, k), comm.copy_to(axes, v)
    KV = k.shape[2]
    G = h_local * axes.size // KV          # q heads a kv head
    first = axes.index * h_local // G
    if h_local % G == 0:
        n = h_local // G
    elif G % h_local == 0:
        n = 1
    else:
        raise ValueError(f"{h_local} local q heads do not group over "
                         f"{KV} kv heads of group {G}")
    return k, v, slice(first, first + n)


def mlp_apply(p: Dict[str, torch.Tensor], x: torch.Tensor, eps: float,
              tp: Optional[TensorParallel] = None) -> torch.Tensor:
    """Pre-norm SwiGLU MLP; returns the residual delta. Under ``tp`` with
    ``d_ff`` split, ``w_gate``/``w_up`` are this rank's columns and
    ``w_down`` its rows, between f and g."""
    h = rms_norm(x, p["norm"], eps)
    split = tp is not None and tp.ff
    if split:
        h = comm.copy_to(tp.axes, h)
    g = torch.einsum("bsd,df->bsf", h, p["w_gate"].to(h.dtype))
    u = torch.einsum("bsd,df->bsf", h, p["w_up"].to(h.dtype))
    out = F.silu(g) * u
    out = torch.einsum("bsf,fd->bsd", out, p["w_down"].to(out.dtype))
    return comm.reduce_from(tp.axes, out) if split else out
