"""Two-tier hierarchical EF aggregation (counterpart of
src/repro/core/hierarchy.py, the reference's DESIGN.md §13): clients → pod
aggregator → global server, each hop with its own carrier and compressor.

With ``Hops(pods=P, cross_carrier=..., ...)`` a round has two hops:

  1. INTRA: the clients of pod p aggregate their messages as the flat round
     does (same carriers, same plans) into the pod mean u_p.
  2. CROSS: each pod aggregator keeps its own EF memory, a target ``t_p``
     and a broadcast state ``b_p``, and ships only C_cross(t_p' − b_p);
     ``b_p' = b_p + decode(C_cross(t_p' − b_p))`` through the same
     ``ef.downlink_sync`` leg as the server's broadcast.

  delta mode:     t_p' = t_p + u_p        g' = g + mean_p(b_p' − b_p)
  absolute mode:  t_p' = u_p              g' = mean_p(b_p')

A TRIVIAL cross hop (dense carrier, identity compressor) makes the pod
aggregator transparent: b_p' = t_p', the round runs the flat aggregation's
operations, and the pod memories only track the global innovation
(:func:`trivial_bookkeeping`). ``pods=1`` (or no Hops) runs no
hierarchical machinery at all. The port draws no randomness, so the
reference's ``CROSS_FOLD`` rng fold has no stream to fold yet; it is kept
so the rng slice folds the same one.
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Dict, Optional, Tuple

import torch

from repro_torch.core import carriers as carrier_lib
from repro_torch.core import compressors as comp_lib
from repro_torch.core import ef as ef_lib

Tree = Dict[str, torch.Tensor]

# the reference's rng fold of the cross-pod hop (fold_in(fold_in(rng,
# CROSS_FOLD), pod)), distinct from the downlink's 1 << 20
CROSS_FOLD = 1 << 21


@dataclasses.dataclass(frozen=True)
class Hops:
    """The two-hop topology: how many pod aggregators, and the cross-pod
    carrier and compressor. The intra hop runs the round's own carrier or
    schedule, aggregated within each pod."""

    pods: int = 1
    cross_carrier: str = "dense"
    cross_compressor: Optional[comp_lib.Compressor] = None

    def cross_comp(self) -> comp_lib.Compressor:
        return (self.cross_compressor if self.cross_compressor is not None
                else comp_lib.Identity())

    @property
    def trivial_cross(self) -> bool:
        """The cross hop ships the exact pod target (dense, identity): the
        flat-equivalence regime."""
        return (carrier_lib.make(self.cross_carrier).name == "dense"
                and isinstance(self.cross_comp(), comp_lib.Identity))


def effective(hops: Optional[Hops]) -> Optional[Hops]:
    """None when the topology is flat (pods <= 1): callers gate every piece
    of hierarchical machinery on ``effective(hops) is not None``."""
    if hops is None or hops.pods <= 1:
        return None
    return hops


def check_pods(hops: Hops, n: int) -> None:
    if n % hops.pods != 0:
        raise ValueError(
            f"hops.pods={hops.pods} must divide the client count {n}")


def pod_init(params_like: Tree, pods: int) -> Dict[str, Tree]:
    """The pods' EF memories on a leading pods axis: target t and broadcast
    state b, both zeros in the params' dtype (the server increment mean_p(b'
    − b) is exact under any g⁰)."""
    def zeros():
        return {k: torch.zeros((pods, *p.shape), dtype=p.dtype,
                               device=p.device)
                for k, p in params_like.items()}
    return {"t": zeros(), "b": zeros()}


def pod_target(method, t: Tree, u: Tree) -> Tree:
    """Fold the pod's intra-hop mean u into its target with the method's
    server rule (delta accumulates, absolute replaces)."""
    return ef_lib.server_step(method, t, u)


def pod_message(method, b: Tree, b_new: Tree) -> Tree:
    """One pod's contribution to the server update: the cross hop's decode
    increment (delta mode) or the synced target (absolute mode)."""
    if method.mode == "delta":
        return ef_lib.tree_sub(b_new, b)
    return b_new


def cross_sync(hops: Hops, schedule, t_new: Tree, b: Tree) -> Tree:
    """The cross hop for ONE pod: b' = b + decode(C_cross(t' − b)). Under a
    schedule the groups' cross fields rule (``schedule.cross_round_grouped``),
    otherwise the Hops' own."""
    if schedule is not None:
        from repro_torch.core import schedule as sched_lib
        return sched_lib.cross_round_grouped(schedule, t_new, b)
    return ef_lib.downlink_sync(carrier_lib.make(hops.cross_carrier),
                                hops.cross_comp(), t_new, b)[1]


def cross_is_trivial(hops: Hops, schedule) -> bool:
    """Flat equivalence of the whole cross hop: under a schedule EVERY
    group's cross must be trivial."""
    if schedule is None:
        return hops.trivial_cross
    return all(g.trivial_cross for g in schedule.groups)


def round_pods_batched(hops: Hops, schedule, method, u_pods: Tree,
                       pods_st: Dict[str, Tree], g_server: Tree
                       ) -> Tuple[Dict[str, Tree], Tree]:
    """The pod tier: per pod the target update and the cross hop, then the
    server integrates the pods' mean message. ``u_pods`` and ``pods_st``
    carry pods on a leading axis. Returns (new_pods_st, new_server)."""
    t_out, b_out, msgs = [], [], []
    for p in range(hops.pods):
        def take(tree, p=p):
            return {k: x[p] for k, x in tree.items()}
        t_p, b_p = take(pods_st["t"]), take(pods_st["b"])
        t_new = pod_target(method, t_p, take(u_pods))
        b_new = cross_sync(hops, schedule, t_new, b_p)
        t_out.append(t_new)
        b_out.append(b_new)
        msgs.append(pod_message(method, b_p, b_new))

    def stack(trees):
        return {k: torch.stack([t[k] for t in trees]) for k in trees[0]}
    # ((m_0 + m_1) + …) / pods, the reference's sum(ls[1:], ls[0]) / pods
    msg_mean = {k: functools.reduce(torch.add, [m[k] for m in msgs])
                / hops.pods for k in msgs[0]}
    new_server = ef_lib.server_step(method, g_server, msg_mean)
    return {"t": stack(t_out), "b": stack(b_out)}, new_server


def trivial_bookkeeping(method, pods_st: Dict[str, Tree], msg_mean: Tree
                        ) -> Dict[str, Tree]:
    """The pod memories under a TRIVIAL cross hop: the aggregator is
    transparent (b' = t'), the server took the flat global mean, and every
    pod's memory tracks that same global innovation."""
    def up(t, m):
        m = m.expand(t.shape)
        return t + m if method.mode == "delta" else m.contiguous()
    t_new = ef_lib.tree_map(up, pods_st["t"], msg_mean)
    return {"t": t_new, "b": t_new}


def pod_mean_leaf(x: torch.Tensor, pods: int) -> torch.Tensor:
    """(n, ...) → (pods, ...) means of pod-major contiguous client blocks
    (pod p holds clients [p·n/pods, (p+1)·n/pods)), summed in f32 and
    rounded once, as ``jnp.mean`` takes them."""
    m = x.shape[0] // pods
    return (x.float().reshape(pods, m, *x.shape[1:]).sum(1) / m).to(x.dtype)


def pod_mean(tree: Tree, pods: int) -> Tree:
    """:func:`pod_mean_leaf` over a client-leading tree."""
    return ef_lib.tree_map(lambda x: pod_mean_leaf(x, pods), tree)


def wire_words_cross(hops: Hops, schedule, method, tree_or_d) -> float:
    """Cross-pod words a ROUND: each pod ships one compressed innovation,
    counted as a broadcast's message, times pods."""
    if schedule is not None:
        from repro_torch.core import schedule as sched_lib
        _, total = sched_lib.wire_words_tree(schedule, method, tree_or_d,
                                             direction="cross")
        return total * hops.pods
    car = carrier_lib.make(hops.cross_carrier)
    d = tree_or_d if isinstance(tree_or_d, (int, float)) else sum(
        int(x.numel()) for x in tree_or_d.values())
    return carrier_lib.downlink_words(car, hops.cross_comp(), int(d)) \
        * hops.pods
