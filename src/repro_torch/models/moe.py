"""Mixture-of-experts FFN with sort-based capacity routing (counterpart of
src/repro/models/moe.py): GShard-style capacity, without the O(N·E·C)
one-hot dispatch tensor.

Routing, with static shapes and no data-dependent Python branch, so the
clients' one ``torch.func.vmap`` pass runs it:
  1. router logits in f32 -> softmax -> top-k (weights renormalised with a
     1e-9 floor, expert ids) a token;
  2. the N·k assignments flattened and stably sorted by expert id;
  3. each assignment's position within its expert (the expert's first
     sorted slot from the counts' exclusive cumsum); an assignment at or
     past the capacity C = max(1, int(ceil(N·k/E)·cf)) is dropped;
  4. a scatter into an (E, C, d) buffer, the three expert products, the
     gather back, the unsort and the weighted sum over k.

The reference relies on JAX dropping an out-of-bounds scatter update for a
dropped assignment and clamps the gather. torch raises on an out-of-bounds
index, so a dropped assignment adds zero into one spare row past the
buffer (cut off after the scatter) and the gather reads a clamped slot
that the keep mask zeroes. Each slot of the buffer receives at most one
nonzero value, so the scatter gives the same bits in any order of its
adds, atomics on the card included.

Aux values, as the reference's: the Switch-style ``load_balance`` (E ·
Σ mean router probability × share of assignments an expert), the router's
``router_z`` (the mean squared logsumexp of the logits) and
``dropped_frac`` (no gradient).

``moe_apply_dense`` runs every expert on every token and combines them by
the (N, E) routing weights, in token chunks of 2048, with no dispatch at
all (the reference's option for high-activation MoEs).

``split`` (a pod client's data group, ``comm.Axes``): the call holds this
rank's contiguous block of the client's tokens, and the routing stays the
reference's function of the client's whole token set. C comes from the
client's N (the group's size times this call's); an assignment's place in
its expert's queue is offset by the assignments the lower ranks of the
group gave that expert (one all-gather of the E counts, no gradient); ce
comes from the group's counts; ``me``, ``router_z`` and ``dropped_frac``
are this rank's additive shares (its tokens' sums over the client's N),
so the group's sum of the aux values and of the loss is the reference's.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.core import comm
from repro_torch.models.layers import TensorParallel, rms_norm

Aux = Dict[str, torch.Tensor]
AUX_KEYS = ("load_balance", "router_z", "dropped_frac")

# (top_e, probs) of every routed call, in call order, while a list is
# installed (capture_routing); nothing is recorded otherwise
_ROUTING: Optional[list] = None


class capture_routing:
    """``with capture_routing() as seen:`` appends each ``moe_apply`` /
    ``moe_apply_dense`` call's chosen experts (N, k) and router
    probabilities (N, E), detached, to ``seen``: one run's routing held
    against another's before their arithmetic is (a routing flip told
    apart from a rounding, and a flip's router margin read). Outside
    ``torch.func`` transforms only."""

    def __enter__(self) -> list:
        global _ROUTING
        self._prev, _ROUTING = _ROUTING, []
        return _ROUTING

    def __exit__(self, *exc) -> None:
        global _ROUTING
        _ROUTING = self._prev


def moe_init(normal, d: int, ff: int, E: int, n: int, dtype
             ) -> Dict[str, torch.Tensor]:
    """The stacked leaves of ``n`` MoE blocks under the reference's names:
    ``router`` (n, d, E) in f32 whatever ``dtype`` is, ``w_gate`` and
    ``w_up`` (n, E, d, ff), ``w_down`` (n, E, ff, d) and ``norm`` (n, d).
    ``normal(*shape, std, dtype)`` draws a leaf."""
    return {
        "router": normal(n, d, E, std=d ** -0.5, dtype=torch.float32),
        "w_down": normal(n, E, ff, d, std=ff ** -0.5, dtype=dtype),
        "w_gate": normal(n, E, d, ff, std=d ** -0.5, dtype=dtype),
        "w_up": normal(n, E, d, ff, std=d ** -0.5, dtype=dtype),
        "norm": torch.zeros(n, d, dtype=dtype),
    }


def _capacity(N: int, E: int, k: int, cf: float) -> int:
    return max(1, int(-(-N * k // E) * cf))


def _inv(n: int, device) -> torch.Tensor:
    """f32(1/n): XLA-CPU turns the reference's division by a constant (a
    mean's, the histogram's) into a multiply by its f32 reciprocal."""
    return torch.full((), 1.0 / n, dtype=torch.float32, device=device)


def _route(p: Dict[str, torch.Tensor], x: torch.Tensor, k: int, eps: float,
           split: Optional[comm.Axes] = None):
    """The normed tokens h (N, d), the renormalised top-k weights and
    expert ids (N, k), the per-expert assignment counts (E,), the
    assignments the lower ranks of ``split`` gave each expert (E,) (zeros
    without it) and the load-balance and z aux values (``split``: this
    rank's shares of the client's)."""
    B, S, d = x.shape
    N, E = B * S, p["router"].shape[-1]
    n_all = N if split is None else N * split.size
    h = rms_norm(x, p["norm"], eps).reshape(N, d)
    logits = h.float() @ p["router"].float()                # (N, E) f32
    probs = torch.softmax(logits, dim=-1)
    top_w, top_e = torch.topk(probs, k, dim=-1)
    top_w = top_w / torch.clamp(top_w.sum(-1, keepdim=True), min=1e-9)
    if _ROUTING is not None:
        _ROUTING.append((top_e.detach(), probs.detach()))
    # assignments an expert, exact integers (a histogram free of scatters)
    counts = (top_e.reshape(-1, 1) ==
              torch.arange(E, device=x.device)).sum(0)
    below, total = torch.zeros_like(counts), counts
    if split is not None:
        every = comm.gather_plain(split, counts)          # (ranks, E)
        below, total = every[:split.index].sum(0), every.sum(0)
    ce = total.float() * _inv(n_all * k, x.device)
    me = probs.sum(0) * _inv(n_all, x.device)
    lse = torch.logsumexp(logits, dim=-1)
    aux = {"load_balance": E * torch.sum(me * ce),
           "router_z": torch.sum(lse ** 2) * _inv(n_all, x.device)}
    return h, top_w, top_e, counts, below, aux


def _split(tp: Optional[TensorParallel]) -> bool:
    return tp is not None and (tp.experts or tp.expert_ff)


def moe_apply(p: Dict[str, torch.Tensor], x: torch.Tensor, *, k: int,
              cf: float, eps: float, tp: Optional[TensorParallel] = None,
              split: Optional[comm.Axes] = None
              ) -> Tuple[torch.Tensor, Aux]:
    """x (B, S, d) -> (out (B, S, d), aux). Capacity from the N = B·S
    tokens of this call (one client's under the client vmap), or from the
    client's under ``split`` (module docstring).

    Under ``tp`` the routing, the capacity and the aux values are computed
    whole on every rank (the router is replicated). With the experts split
    a rank runs its contiguous block of them on its rows of the dispatch
    buffer and combines only their outputs (the combine weights through
    f); with the experts' ``d_ff`` split every rank runs every expert on
    its columns, and g sums the expert outputs before the combine. g sums
    the partial combine over the axis in the first case."""
    B, S, d = x.shape
    N, E = B * S, p["router"].shape[-1]
    h, top_w, top_e, counts, below, aux = _route(p, x, k, eps, split)
    tp_split = _split(tp)
    if tp_split:
        h = comm.copy_to(tp.axes, h)

    C = _capacity(N if split is None else N * split.size, E, k, cf)
    flat_e = top_e.reshape(-1)                              # (N·k,)
    order = torch.argsort(flat_e, stable=True)
    sorted_e = flat_e[order]
    # an expert's first sorted slot, less the lower ranks' assignments
    first = torch.cumsum(counts, 0) - counts - below
    pos_in_e = torch.arange(N * k, device=x.device) - first[sorted_e]
    keep = pos_in_e < C
    tok = order // k                                        # source token

    # the scatter: a dropped assignment adds zero into the spare row E·C
    slot = torch.where(keep, sorted_e * C + pos_in_e,
                       torch.full_like(pos_in_e, E * C))
    vals = torch.where(keep[:, None], h[tok], torch.zeros((), dtype=h.dtype,
                                                          device=h.device))
    xe = torch.zeros((E * C + 1, d), dtype=h.dtype, device=h.device) \
        .index_put((slot,), vals, accumulate=True)[:E * C].reshape(E, C, d)

    ep = tp_split and tp.experts
    e0, El = 0, E
    if ep:
        El = p["w_gate"].shape[0]
        e0 = tp.axes.index * El
        xe = xe[e0:e0 + El]
    g = torch.einsum("ecd,edf->ecf", xe, p["w_gate"].to(xe.dtype))
    u = torch.einsum("ecd,edf->ecf", xe, p["w_up"].to(xe.dtype))
    y = F.silu(g) * u
    ye = torch.einsum("ecf,efd->ecd", y, p["w_down"].to(y.dtype))
    if tp_split and not ep:
        ye = comm.reduce_from(tp.axes, ye)

    live = keep
    if ep:          # the assignments to this rank's experts
        live = keep & (sorted_e >= e0) & (sorted_e < e0 + El)
    gathered = ye.reshape(El * C, d)[
        torch.clamp(sorted_e - e0, 0, El - 1) * C
        + torch.clamp(pos_in_e, max=C - 1)]
    gathered = torch.where(live[:, None], gathered,
                           torch.zeros((), dtype=gathered.dtype,
                                       device=gathered.device))
    # back to (N, k) order (order is a permutation: its argsort inverts it)
    unsorted = gathered[torch.argsort(order)]
    w = comm.copy_to(tp.axes, top_w) if ep else top_w
    out = (unsorted.reshape(N, k, d) * w[..., None].to(gathered.dtype)
           ).sum(1)
    if ep:
        out = comm.reduce_from(tp.axes, out)
    if split is None:
        aux["dropped_frac"] = 1.0 - keep.float().sum() * _inv(N * k,
                                                               x.device)
    else:
        aux["dropped_frac"] = (N * k - keep.float().sum()) * _inv(
            N * k * split.size, x.device)
    return out.reshape(B, S, d), aux


def moe_apply_dense(p: Dict[str, torch.Tensor], x: torch.Tensor, *, k: int,
                    cf: float, eps: float, chunk: int = 2048,
                    tp: Optional[TensorParallel] = None,
                    split: Optional[comm.Axes] = None
                    ) -> Tuple[torch.Tensor, Aux]:
    """Every expert on every token, combined by the (N, E) top-k routing
    weights: no dispatch scatter or gather, E/k times the active products.
    Tokens go ``chunk`` at a time, bounding the (E, chunk, ff) live
    intermediate. ``cf`` is unused (nothing drops); ``dropped_frac`` is 0.
    Under ``tp`` a rank runs its experts (or its columns of every
    expert's ``d_ff``) on every token, the tokens and the routing weights
    through f, and g sums the combined output. ``split``: the aux values
    are this rank's shares of the client's (module docstring)."""
    B, S, d = x.shape
    N, E = B * S, p["router"].shape[-1]
    h, top_w, top_e, _, _, aux = _route(p, x, k, eps, split)
    w_ne = torch.zeros((N, E), dtype=torch.float32, device=x.device) \
        .scatter(1, top_e, top_w)                           # routing weights
    aux["dropped_frac"] = torch.zeros((), device=x.device)
    tp_split = _split(tp)
    if tp_split:
        h, w_ne = comm.copy_to(tp.axes, h), comm.copy_to(tp.axes, w_ne)
        if tp.experts:
            El = p["w_gate"].shape[0]
            w_ne = w_ne[:, tp.axes.index * El:(tp.axes.index + 1) * El]
    outs = []
    for start in range(0, N, min(chunk, N)):
        hc, wc = h[start:start + chunk], w_ne[start:start + chunk]
        g = torch.einsum("nd,edf->enf", hc, p["w_gate"].to(hc.dtype))
        u = torch.einsum("nd,edf->enf", hc, p["w_up"].to(hc.dtype))
        y = F.silu(g) * u
        ye = torch.einsum("enf,efd->end", y, p["w_down"].to(y.dtype))
        outs.append(torch.einsum("end,ne->nd", ye, wc.to(ye.dtype)))
    out = torch.cat(outs)
    if tp_split:
        out = comm.reduce_from(tp.axes, out)
    return out.reshape(B, S, d), aux


def capacity(cfg, tokens: int) -> int:
    """C of a call on ``tokens`` tokens under ``cfg`` (chip_smoke.py prints
    it beside the drop fraction)."""
    return _capacity(tokens, cfg.num_experts, cfg.num_experts_per_tok,
                     cfg.moe_capacity_factor)

