"""State-space sequence mixers (counterpart of src/repro/models/ssm.py):
Mamba1's selective scan (falcon-mamba-7b) and Mamba2's SSD, the scalar-A
multihead state space duality (zamba2-1.2b).

Both mixers run the reference's chunked scan: a loop over S / chunk chunks
carries the (B, ..., N) state, and within a chunk Mamba1 runs an
associative scan (:func:`associative_scan`, the odd/even recursion of
``jax.lax.associative_scan``, so the products round in the reference's
order) and Mamba2 the SSD block decomposition, (chunk x chunk) products.
The decode paths are one-token recurrences over the carried (ssm_state,
conv_state). The scans are plain PyTorch, as they are plain JAX in the
reference: no kernel of this module has a TPU counterpart. Everything
runs under the clients' ``torch.func.vmap`` and ``grad``: strided slices,
``torch.cat`` and ``torch.stack``, no in-place write.

Softplus is ``logaddexp(x, 0)``, the reference's ``jax.nn.softplus``
(``F.softplus`` switches to x above its threshold). ``A_log`` and ``D``
are f32 whatever the parameter dtype is, as in the reference.

Training on a 'model' axis (``tp``, models/model.py ``tp_plan``) runs
each block over this rank's shards of the reference's layout
(``param_pspecs``): d_inner and Mamba2's heads split, with f, g and
``comm.resplit`` where a whole tensor enters split work or partial sums
leave it; those collectives run outside the clients' vmap
(core/distributed.py ``client_value_and_grad``).
"""
from __future__ import annotations

from typing import Callable, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F

from repro_torch.core import comm
from repro_torch.models.layers import TensorParallel, rms_norm, \
    split_rms_norm

States = Tuple[torch.Tensor, torch.Tensor]


def softplus(x: torch.Tensor) -> torch.Tensor:
    """log(1 + e^x) as the reference's ``jnp.logaddexp(x, 0)``."""
    return torch.logaddexp(x, x.new_zeros(()))


# ---------------------------------------------------------------------------
# the associative scan and the causal depthwise conv
# ---------------------------------------------------------------------------

def _slice(t: torch.Tensor, dim: int, start: int, stop: Optional[int] = None,
           step: int = 1) -> torch.Tensor:
    idx = [slice(None)] * t.dim()
    idx[dim] = slice(start, stop, step)
    return t[tuple(idx)]


def _interleave(a: torch.Tensor, b: torch.Tensor, dim: int) -> torch.Tensor:
    """a0, b0, a1, b1, ... along ``dim``; a is as long as b or one longer."""
    nb = b.shape[dim]
    out = torch.stack([_slice(a, dim, 0, nb), b], dim=dim + 1
                      ).flatten(dim, dim + 1)
    if a.shape[dim] == nb:
        return out
    return torch.cat([out, _slice(a, dim, nb)], dim=dim)


def associative_scan(combine: Callable, elems: Sequence[torch.Tensor],
                     dim: int) -> Tuple[torch.Tensor, ...]:
    """The inclusive scan of the tuple ``elems`` along ``dim`` under the
    associative ``combine(left, right)`` of two tuples, by
    ``jax.lax.associative_scan``'s recursion: combine adjacent pairs,
    recurse on the result, combine its elements with the even elements,
    put the first element in front and interleave. Each output is the
    reference's product in the reference's order."""
    elems = tuple(elems)
    dim = dim % elems[0].dim()
    n = elems[0].shape[dim]
    if n < 2:
        return elems
    reduced = combine(tuple(_slice(e, dim, 0, -1, 2) for e in elems),
                      tuple(_slice(e, dim, 1, None, 2) for e in elems))
    odd = associative_scan(combine, reduced, dim)
    evens = tuple(_slice(e, dim, 2, None, 2) for e in elems)
    if n % 2 == 0:
        even = combine(tuple(_slice(e, dim, 0, -1) for e in odd), evens)
    else:
        even = combine(odd, evens)
    even = tuple(torch.cat([_slice(e, dim, 0, 1), r], dim=dim)
                 for e, r in zip(elems, even))
    return tuple(_interleave(a, b, dim) for a, b in zip(even, odd))


def _linear_combine(left, right):
    """The first-order recurrence's combine: (a_l a_r, b_l a_r + b_r)."""
    return left[0] * right[0], left[1] * right[0] + right[1]


def causal_conv(x: torch.Tensor, w: torch.Tensor,
                state: Optional[torch.Tensor] = None
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Depthwise causal conv. x: (B, S, D); w: (k, D); ``state``: the last
    k-1 inputs before x (B, k-1, D), zeros when None. Returns (y, the new
    state). The shifts are summed in the reference's order, j = 0..k-1."""
    k = w.shape[0]
    if state is None:
        state = x.new_zeros(x.shape[0], k - 1, x.shape[2])
    xp = torch.cat([state, x], dim=1)                   # (B, S+k-1, D)
    S = x.shape[1]
    y = sum(xp[:, j:j + S] * w[j] for j in range(k))
    return y, xp[:, -(k - 1):]


# ---------------------------------------------------------------------------
# Mamba1: the selective scan
# ---------------------------------------------------------------------------

def mamba1_init(normal, n: int, d: int, d_inner: int, state: int,
                dt_rank: int, conv: int, dtype) -> dict:
    """The stacked leaves of ``n`` Mamba1 blocks under the reference's
    names; ``normal(*shape, std, dtype)`` draws a leaf (from the model's
    generator, or a meta tensor without one). ``A_log`` (log 1..N a row)
    and ``D`` are f32 whatever ``dtype`` is."""
    A = torch.arange(1, state + 1, dtype=torch.float32).repeat(n, d_inner, 1)
    return {
        "in_proj": normal(n, d, 2 * d_inner, std=d ** -0.5, dtype=dtype),
        "conv_w": normal(n, conv, d_inner, std=0.1, dtype=dtype),
        "x_proj": normal(n, d_inner, dt_rank + 2 * state,
                         std=d_inner ** -0.5, dtype=dtype),
        "dt_proj": normal(n, dt_rank, d_inner, std=dt_rank ** -0.5,
                          dtype=dtype),
        "dt_bias": torch.full((n, d_inner), -4.0, dtype=dtype),
        "A_log": torch.log(A),
        "D": torch.ones(n, d_inner, dtype=torch.float32),
        "out_proj": normal(n, d_inner, d, std=d_inner ** -0.5, dtype=dtype),
        "norm": torch.zeros(n, d, dtype=dtype),
    }


def _chunk(S: int, chunk: int) -> int:
    """The scan's chunk, min(chunk, S), which must divide S (the reference
    asserts it)."""
    chunk = min(chunk, S)
    if S % chunk:
        raise ValueError(f"the SSM scan's sequence {S} is not a multiple of "
                         f"its chunk {chunk} (cfg.attn_chunk)")
    return chunk


def _dt(p, dt_in: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """softplus(dt_in · w in f32 + dt_bias), f32."""
    return softplus(torch.einsum("bsr,rd->bsd", dt_in, w.to(dt_in.dtype))
                    .float() + p["dt_bias"].float())


def _x_proj(p, xc: torch.Tensor, dt_rank: int, N: int,
            tp: Optional[TensorParallel] = None):
    """(dt (B, S, Di) f32, B, C (B, S, N)) from xc: x_proj's product, split
    into dt's input, B and C, dt through ``dt_proj``. Under ``tp`` xc and
    x_proj's rows are this rank's d_inner, so the product is a partial sum:
    g sums it, and f follows, since the whole (dt_in, B, C) feeds this
    rank's ``dt_proj`` columns and scan (each rank's share of its gradient
    summed over the axis)."""
    proj = torch.einsum("bsd,de->bse", xc, p["x_proj"].to(xc.dtype))
    if tp is not None:
        proj = comm.reduce_to_all(tp.axes, proj)
    dt_in, Bm, Cm = torch.split(proj, [dt_rank, N, N], dim=-1)
    return _dt(p, dt_in, p["dt_proj"]), Bm, Cm


def _mamba1_core(p, xc: torch.Tensor, dt: torch.Tensor, Bm: torch.Tensor,
                 Cm: torch.Tensor, h0: torch.Tensor, chunk: int
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """xc: (B, S, Di) after the conv and silu; dt, Bm, Cm from
    :func:`_x_proj`; h0: (B, Di, N). The chunked selective scan: (y in xc's
    dtype, the final state)."""
    S = xc.shape[1]
    A = -torch.exp(p["A_log"])                              # (Di, N)
    chunk = _chunk(S, chunk)
    xf, Bf, Cf = xc.float(), Bm.float(), Cm.float()
    h, ys = h0, []
    for s0 in range(0, S, chunk):
        dt_i, x_i = dt[:, s0:s0 + chunk], xf[:, s0:s0 + chunk]
        B_i, C_i = Bf[:, s0:s0 + chunk], Cf[:, s0:s0 + chunk]
        a = torch.exp(dt_i[..., None] * A)                  # (B, ch, Di, N)
        b = (dt_i * x_i)[..., None] * B_i[:, :, None, :]
        Ac, Bc = associative_scan(_linear_combine, (a, b), dim=1)
        hs = Ac * h[:, None] + Bc                           # (B, ch, Di, N)
        ys.append(torch.einsum("bcdn,bcn->bcd", hs, C_i) + p["D"] * x_i)
        h = hs[:, -1]
    return torch.cat(ys, dim=1).to(xc.dtype), h


def mamba1_apply(p: dict, x: torch.Tensor, cfg, *,
                 ssm_state: Optional[torch.Tensor] = None,
                 conv_state: Optional[torch.Tensor] = None,
                 tp: Optional[TensorParallel] = None
                 ) -> Tuple[torch.Tensor, States]:
    """Pre-norm Mamba1 block; returns (the residual delta, (ssm_state,
    conv_state) after x). x: (B, S, d); with states and S = 1, the
    one-token decode recurrence.

    Under ``tp`` with ``d_inner`` split, ``p`` holds this rank's shards:
    ``in_proj`` (d, 2·Di) split contiguously on its last dim (at 2 ranks
    rank 0 holds x's columns and rank 1 z's), the rest on d_inner. The
    normed input enters through f; :func:`comm.resplit` moves the
    in_proj product's blocks so that each rank holds the x and z columns
    of its d_inner block, which its conv, ``dt_proj``, scan and
    ``out_proj`` rows read; x_proj's partial (dt_in, B, C) is made whole
    (:func:`_x_proj`), and g sums ``out_proj``'s partial products."""
    B, S, _ = x.shape
    N = cfg.ssm_state
    split = tp is not None and tp.d_inner
    h = rms_norm(x, p["norm"], cfg.norm_eps)
    if split:
        h = comm.copy_to(tp.axes, h)
    xz = torch.einsum("bsd,de->bse", h, p["in_proj"].to(h.dtype))
    if split:
        xz = comm.resplit(tp.axes, xz, 2)
    xin, z = xz.chunk(2, dim=-1)
    xc, conv_new = causal_conv(xin, p["conv_w"].to(xin.dtype), conv_state)
    xc = F.silu(xc)
    dt, Bm, Cm = _x_proj(p, xc, cfg.dt_rank, N, tp if split else None)
    if ssm_state is not None and S == 1:
        dt = dt[:, 0]                                       # (B, Di)
        A = -torch.exp(p["A_log"])
        x0 = xc.float()[:, 0]
        a = torch.exp(dt[..., None] * A)                    # (B, Di, N)
        b = (dt * x0)[..., None] * Bm.float()[:, 0, None, :]
        h_new = a * ssm_state + b
        y = torch.einsum("bdn,bn->bd", h_new, Cm.float()[:, 0]) + \
            p["D"] * x0
        y = y[:, None].to(xc.dtype)
    else:
        h0 = ssm_state if ssm_state is not None else torch.zeros(
            B, xc.shape[-1], N, dtype=torch.float32, device=x.device)
        y, h_new = _mamba1_core(p, xc, dt, Bm, Cm, h0, cfg.attn_chunk)
    y = y * F.silu(z)
    out = torch.einsum("bsd,de->bse", y, p["out_proj"].to(y.dtype))
    return (comm.reduce_from(tp.axes, out) if split else out,
            (h_new, conv_new))


# ---------------------------------------------------------------------------
# Mamba2: SSD
# ---------------------------------------------------------------------------

def mamba2_init(normal, n: int, d: int, d_inner: int, state: int,
                head_dim: int, conv: int, dtype) -> dict:
    """The stacked leaves of ``n`` Mamba2 blocks under the reference's
    names (see :func:`mamba1_init`); ``A_log`` (zeros) and ``D`` f32."""
    nh = d_inner // head_dim
    return {
        "in_x": normal(n, d, d_inner, std=d ** -0.5, dtype=dtype),
        "in_z": normal(n, d, d_inner, std=d ** -0.5, dtype=dtype),
        "in_B": normal(n, d, state, std=d ** -0.5, dtype=dtype),
        "in_C": normal(n, d, state, std=d ** -0.5, dtype=dtype),
        "in_dt": normal(n, d, nh, std=d ** -0.5, dtype=dtype),
        "dt_bias": torch.full((n, nh), -4.0, dtype=dtype),
        "conv_w": normal(n, conv, d_inner + 2 * state, std=0.1, dtype=dtype),
        "A_log": torch.zeros(n, nh, dtype=torch.float32),
        "D": torch.ones(n, nh, dtype=torch.float32),
        "out_proj": normal(n, d_inner, d, std=d_inner ** -0.5, dtype=dtype),
        "norm": torch.zeros(n, d, dtype=dtype),
        "out_norm": torch.zeros(n, d_inner, dtype=dtype),
    }


def _ssd_chunk_scan(x, dt, Bm, Cm, A, D, h0, chunk):
    """The SSD chunked scan. x: (B, S, H, P) f32; dt: (B, S, H); Bm, Cm:
    (B, S, N); A: (H,) negative; h0: (B, H, P, N). Returns (y (B, S, H,
    P), the final state)."""
    S = x.shape[1]
    chunk = _chunk(S, chunk)
    tri = torch.tril(torch.ones(chunk, chunk, dtype=torch.bool,
                                device=x.device))
    h, ys = h0, []
    for s0 in range(0, S, chunk):
        xi, dti = x[:, s0:s0 + chunk], dt[:, s0:s0 + chunk]
        Bi, Ci = Bm[:, s0:s0 + chunk], Cm[:, s0:s0 + chunk]
        Lc = torch.cumsum(dti * A, dim=1)                   # (B, ch, H)
        # intra-chunk: w[t, s] = (C_t·B_s)·exp(L_t − L_s)·dt_s, s <= t
        cb = torch.einsum("btn,bsn->bts", Ci, Bi)
        dec = torch.exp(torch.clamp(Lc[:, :, None, :] - Lc[:, None, :, :],
                                    -60, 0))
        w = cb[:, :, :, None] * dec * dti[:, None, :, :]
        w = torch.where(tri[None, :, :, None], w, 0.0)      # (B, t, s, H)
        y_intra = torch.einsum("btsh,bshp->bthp", w, xi)
        # inter-chunk: the carried state's contribution
        y_inter = torch.exp(Lc)[..., None] * \
            torch.einsum("bhpn,btn->bthp", h, Ci)
        # h' = exp(ΣA)·h + Σ_s exp(L_end − L_s)·dt_s·x_s B_sᵀ
        wl = torch.exp(torch.clamp(Lc[:, -1:, :] - Lc, min=-60)) * dti
        h = torch.exp(Lc[:, -1])[..., None, None] * h + \
            torch.einsum("bsh,bshp,bsn->bhpn", wl, xi, Bi)
        ys.append(y_intra + y_inter + D[:, None] * xi)
    return torch.cat(ys, dim=1), h


def _conv_w_local(tp: TensorParallel, w: torch.Tensor, Di: int
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Mamba2's conv weights (k, Di + 2N), which every rank holds whole, as
    this rank's depthwise conv reads them under ``tp``: (the x columns of
    its d_inner block, the B and C columns). The x part passes f before
    the slice, so its gradient (each rank's own columns) is summed over
    the axis and comes out whole on every rank; the B and C columns take
    none, as B and C run whole on every rank before their f (a sum there
    would count their gradient once a rank)."""
    n = Di // tp.axes.size
    wx = comm.copy_to(tp.axes, w[:, :Di])
    return wx[:, tp.axes.index * n:(tp.axes.index + 1) * n], w[:, Di:]


def mamba2_apply(p: dict, x: torch.Tensor, cfg, *,
                 ssm_state: Optional[torch.Tensor] = None,
                 conv_state: Optional[torch.Tensor] = None,
                 tp: Optional[TensorParallel] = None
                 ) -> Tuple[torch.Tensor, States]:
    """Pre-norm Mamba2 (SSD) block; returns (the residual delta,
    (ssm_state, conv_state) after x), as :func:`mamba1_apply`. The
    depthwise conv runs x's columns and B/C's apart (the same sums, column
    by column).

    Under ``tp`` with d_inner and the heads split, ``in_x``, ``in_z``,
    ``out_norm`` and ``out_proj``'s rows are this rank's d_inner block,
    ``in_dt``, ``dt_bias``, ``A_log`` and ``D`` its heads; ``in_B``,
    ``in_C`` and ``conv_w`` are whole. The split projections read the
    normed input through f; B and C are computed whole and pass f after
    their conv, since they feed the split scan; ``conv_w`` as
    :func:`_conv_w_local`; the gated norm takes its mean square over the
    whole d_inner (``layers.split_rms_norm``); g sums ``out_proj``'s
    partial products."""
    B, S, _ = x.shape
    Di, N, Pd = cfg.d_inner, cfg.ssm_state, cfg.ssm_head_dim
    split = tp is not None and tp.d_inner
    h = rms_norm(x, p["norm"], cfg.norm_eps)
    hs = comm.copy_to(tp.axes, h) if split else h
    xin = torch.einsum("bsd,de->bse", hs, p["in_x"].to(h.dtype))
    z = torch.einsum("bsd,de->bse", hs, p["in_z"].to(h.dtype))
    Bm = torch.einsum("bsd,dn->bsn", h, p["in_B"].to(h.dtype))
    Cm = torch.einsum("bsd,dn->bsn", h, p["in_C"].to(h.dtype))
    dt = softplus(torch.einsum("bsd,dh->bsh", hs, p["in_dt"].to(h.dtype))
                  .float() + p["dt_bias"].float())
    Dl = xin.shape[-1]                       # this rank's d_inner
    H = Dl // Pd
    w = p["conv_w"].to(xin.dtype)
    wx, wbc = _conv_w_local(tp, w, Di) if split else (w[:, :Di], w[:, Di:])
    sx, sbc = (None, None) if conv_state is None else \
        torch.split(conv_state, [Dl, 2 * N], dim=-1)
    xin, sx = causal_conv(xin, wx, sx)
    bc, sbc = causal_conv(torch.cat([Bm, Cm], dim=-1), wbc, sbc)
    conv_new = torch.cat([sx, sbc], dim=-1)
    xin, bc = F.silu(xin), F.silu(bc)
    if split:
        bc = comm.copy_to(tp.axes, bc)
    Bm, Cm = torch.split(bc, [N, N], dim=-1)
    A = -torch.exp(p["A_log"])                              # (H,)
    xh = xin.float().reshape(B, S, H, Pd)
    if ssm_state is not None and S == 1:
        a = torch.exp(dt[:, 0] * A)                         # (B, H)
        h_new = a[..., None, None] * ssm_state + torch.einsum(
            "bh,bhp,bn->bhpn", dt[:, 0], xh[:, 0], Bm.float()[:, 0])
        y = torch.einsum("bhpn,bn->bhp", h_new, Cm.float()[:, 0]) + \
            p["D"][:, None] * xh[:, 0]
        y = y[:, None]
    else:
        h0 = ssm_state if ssm_state is not None else torch.zeros(
            B, H, Pd, N, dtype=torch.float32, device=x.device)
        y, h_new = _ssd_chunk_scan(xh, dt, Bm.float(), Cm.float(), A,
                                   p["D"], h0, cfg.attn_chunk)
    y = y.reshape(B, S, Dl).to(x.dtype)
    y = y * F.silu(z)
    if split:
        y = split_rms_norm(y, p["out_norm"], cfg.norm_eps, tp.axes, Di)
    else:
        y = rms_norm(y, p["out_norm"], cfg.norm_eps)
    out = torch.einsum("bsd,de->bse", y, p["out_proj"].to(y.dtype))
    return (comm.reduce_from(tp.axes, out) if split else out,
            (h_new, conv_new))
