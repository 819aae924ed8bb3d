"""Per-parameter-group compression schedules (counterpart of
src/repro/core/schedule.py, the reference's DESIGN.md §9).

A :class:`CompressionSchedule` is an ordered tuple of :class:`Group`
entries, each a path pattern with its own compressor, uplink carrier,
downlink carrier and compressor, EF-state dtype and cross-pod carrier and
compressor. Leaves are assigned first-match-wins against the pattern order,
and the last group must be the catch-all ``"*"``. Patterns are
``|``-separated substring tokens matched against the leaf's lower-cased
``/``-joined path.

The grouped engine runs, per group, the same client leg the ungrouped round
runs (:func:`batched_leg`: the 'dense', 'wire', 'fused' and 'fused_wire'
plans) on that group's leaves, and merges the results back by key. The
fused plans write the new client state IN PLACE into the state's own
tensors (a group's sub-dict holds those tensors, not copies), and the wire
and dense plans replace the state's entries leaf by leaf, so a group runs
exactly the operations the ungrouped round runs on the same leaves: a
one-group schedule is bit-identical to the ungrouped round.

:func:`round_local` is the sharded runtime's engine (the reference's
shard_map leg): each group's leg on the ONE client a rank holds
(:func:`local_leg`), one wire and one collective a group. The
round's ``torch.Generator`` (core/rng.py) reaches every group: one group
draws from it untouched (bit-identity with the ungrouped round), several
decorrelate by group index (:func:`_group_rng`). Paired-gradient methods
(STORM, the ideal method) take a tuple of two trees, split per group as
the reference's ``_take_grads`` does.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Tuple

import torch

from repro_torch.core import carriers as carrier_lib
from repro_torch.core import comm
from repro_torch.core import compressors as comp_lib
from repro_torch.core import ef as ef_lib
from repro_torch.core import hierarchy as hier_lib
from repro_torch.core import participation as part_lib
from repro_torch.core import rng as rng_lib

Tree = Dict[str, torch.Tensor]

# characters the flag grammar reserves: a pattern holding one could never
# round-trip through `--schedule "pat=carrier:ratio@comp,…"`
PATTERN_RESERVED = set("=,:@")

# per-group EF-state dtypes ('float32' lets one group keep full precision
# under a bfloat16 spec-level default)
GROUP_STATE_DTYPES = (None, "bfloat16", "float32")


def pattern_token_errors(pattern: str) -> List[str]:
    """An empty ``|`` token matches every leaf; a ``'*'`` token inside a
    composite pattern would shadow every later group."""
    toks = pattern.split("|")
    errs = []
    if any(not t for t in toks):
        errs.append("empty '|' token (matches every leaf)")
    if "*" in toks and pattern != "*":
        errs.append("'*' may only be the standalone catch-all pattern")
    return errs


def pattern_matches(pattern: str, path: str) -> bool:
    """``|``-separated substring tokens, case-insensitive; ``*`` matches
    everything."""
    for tok in pattern.lower().split("|"):
        if tok == "*" or tok in path:
            return True
    return False


def leaf_order(tree: Tree) -> List[str]:
    """The keys of a flat ``/``-keyed tree in the reference's
    ``tree_flatten`` order (nested dicts flatten key by sorted key, level by
    level). The port walks every tree in sorted key order; the two orders
    agree unless a key component sorts before ``/`` against its sibling
    (``a-b`` beside ``a/c``), which is refused."""
    order = sorted(tree, key=lambda k: k.split("/"))
    if order != sorted(tree):
        raise ValueError(f"leaf keys {order} do not sort in the reference's "
                         "tree_flatten order")
    return order


def leaf_paths(tree: Tree) -> Tuple[str, ...]:
    """The lower-cased ``/``-joined path of every leaf, in the reference's
    ``tree_flatten`` order: the strings patterns match against."""
    return tuple(k.lower() for k in leaf_order(tree))


@dataclasses.dataclass(frozen=True)
class Group:
    """One partition cell: a pattern and its whole transport."""

    pattern: str
    compressor: comp_lib.Compressor = comp_lib.Identity()
    carrier: str = "dense"
    down_carrier: str = "dense"
    down_compressor: Optional[comp_lib.Compressor] = None
    state_dtype: Optional[str] = None   # None → the method's
    # the cross-pod hop of this group's leaves under a two-tier topology;
    # dense + identity is the trivial cross (the pod aggregator is
    # transparent)
    cross_carrier: str = "dense"
    cross_compressor: Optional[comp_lib.Compressor] = None

    @property
    def has_downlink(self) -> bool:
        return self.down_carrier != "dense" or self.down_compressor is not None

    def down_comp(self) -> comp_lib.Compressor:
        return (self.down_compressor if self.down_compressor is not None
                else comp_lib.Identity())

    @property
    def trivial_cross(self) -> bool:
        return (self.cross_carrier == "dense"
                and isinstance(self.cross_comp(), comp_lib.Identity))

    def cross_comp(self) -> comp_lib.Compressor:
        return (self.cross_compressor if self.cross_compressor is not None
                else comp_lib.Identity())


@dataclasses.dataclass(frozen=True)
class CompressionSchedule:
    """An ordered, first-match-wins partition of the parameter tree whose
    last group is the catch-all ``"*"``."""

    groups: Tuple[Group, ...] = ()

    def __post_init__(self):
        errs: List[str] = []
        if not self.groups:
            errs.append("a schedule needs at least one group")
        else:
            if self.groups[-1].pattern != "*":
                errs.append("the last group must be the catch-all '*' "
                            f"(got {self.groups[-1].pattern!r}) so every "
                            "leaf lands in exactly one group")
            seen = set()
            for i, g in enumerate(self.groups):
                if not g.pattern:
                    errs.append(f"group {i} has an empty pattern")
                if g.pattern == "*" and i != len(self.groups) - 1:
                    errs.append("the catch-all '*' must be the LAST group "
                                "(first-match-wins would shadow everything "
                                "after it)")
                if g.pattern in seen:
                    errs.append(f"duplicate group pattern {g.pattern!r}")
                seen.add(g.pattern)
                bad = PATTERN_RESERVED & set(g.pattern)
                if bad:
                    errs.append(f"pattern {g.pattern!r} uses reserved "
                                f"characters {sorted(bad)}")
                errs.extend(f"group {g.pattern!r}: {e}"
                            for e in pattern_token_errors(g.pattern))
                if g.carrier not in carrier_lib.REGISTRY:
                    errs.append(f"group {g.pattern!r}: unknown carrier "
                                f"{g.carrier!r}")
                if g.down_carrier not in carrier_lib.REGISTRY \
                        or g.down_carrier == "fused":
                    errs.append(f"group {g.pattern!r}: downlink carrier "
                                f"{g.down_carrier!r} is not a thing (the "
                                "fused kernel is the uplink client update)")
                if g.cross_carrier not in carrier_lib.REGISTRY \
                        or g.cross_carrier == "fused":
                    errs.append(f"group {g.pattern!r}: cross-pod carrier "
                                f"{g.cross_carrier!r} is not a thing (the "
                                "cross hop is one message per pod, under "
                                "the downlink broadcast's rules)")
                if g.state_dtype not in GROUP_STATE_DTYPES:
                    errs.append(f"group {g.pattern!r}: state_dtype "
                                f"{g.state_dtype!r} not in "
                                f"{list(GROUP_STATE_DTYPES)}")
        if errs:
            raise ValueError("invalid CompressionSchedule:\n  - "
                             + "\n  - ".join(errs))

    @classmethod
    def uniform(cls, compressor: comp_lib.Compressor, carrier: str = "dense",
                down_carrier: str = "dense",
                down_compressor: Optional[comp_lib.Compressor] = None,
                state_dtype: Optional[str] = None,
                cross_carrier: str = "dense",
                cross_compressor: Optional[comp_lib.Compressor] = None
                ) -> "CompressionSchedule":
        """The one-group schedule of a single-knob config: bit-identical to
        the ungrouped round."""
        return cls((Group(pattern="*", compressor=compressor, carrier=carrier,
                          down_carrier=down_carrier,
                          down_compressor=down_compressor,
                          state_dtype=state_dtype,
                          cross_carrier=cross_carrier,
                          cross_compressor=cross_compressor),))

    @property
    def has_downlink(self) -> bool:
        return any(g.has_downlink for g in self.groups)

    def match(self, path: str) -> int:
        """First-match-wins group index for one leaf path."""
        for i, g in enumerate(self.groups):
            if pattern_matches(g.pattern, path):
                return i
        raise ValueError(             # unreachable: '*' is mandatory
            f"leaf {path!r} matched no group (no catch-all?)")

    def resolve(self, tree: Tree) -> Tuple[int, ...]:
        """Per-leaf group index in the reference's ``tree_flatten`` order."""
        return tuple(self.match(p) for p in leaf_paths(tree))


def group_method(method: ef_lib.Method, grp: Group) -> ef_lib.Method:
    """The method as one group sees it: the group's compressor and EF-state
    dtype."""
    if grp.state_dtype is None:
        dt = method.state_dtype
    elif grp.state_dtype == "bfloat16":
        dt = torch.bfloat16
    else:
        dt = torch.float32
    return dataclasses.replace(method, compressor=grp.compressor,
                               state_dtype=dt)


def group_keys(schedule: CompressionSchedule, tree: Tree) -> List[List[str]]:
    """The leaf keys of each group, in the reference's leaf order."""
    gids = schedule.resolve(tree)
    keys = leaf_order(tree)
    return [[k for k, g in zip(keys, gids) if g == gi]
            for gi in range(len(schedule.groups))]


def _take(tree: Tree, keys: List[str]) -> Tree:
    return {k: tree[k] for k in keys}


def _take_grads(grads, method, keys: List[str]):
    """One group's grads: a tree, or a pair of trees for paired-gradient
    methods."""
    if method.needs_paired_grads:
        return (_take(grads[0], keys), _take(grads[1], keys))
    return _take(grads, keys)


def base_grads(grads, method) -> Tree:
    """The tree that names the leaves: the first of a pair."""
    return grads[0] if method.needs_paired_grads else grads


def _take_state(state: Dict[str, Tree], keys: List[str]) -> Dict[str, Tree]:
    return {name: _take(tree, keys) for name, tree in state.items()}


def _sorted(tree: Tree) -> Tree:
    return {k: tree[k] for k in sorted(tree)}


def _group_rng(rng, gi: int, n_groups: int):
    """One group → the round's generator untouched (bit-identity with the
    ungrouped round); several → decorrelated by group index."""
    if rng is None or n_groups == 1:
        return rng
    return rng_lib.fold_in(rng, gi)


# ---------------------------------------------------------------------------
# EF state init, grouped
# ---------------------------------------------------------------------------

def init_state_grouped(schedule: CompressionSchedule, method,
                       params_like: Tree,
                       init_grads: Optional[Tree] = None) -> Dict[str, Tree]:
    """``method.init`` per group (with the group's EF-state dtype), merged
    by key. ``params_like`` and ``init_grads`` carry the client axis, as
    ``method.init``'s arguments do in ``init_ef_state``."""
    merged: Dict[str, Tree] = {}
    for grp, keys in zip(schedule.groups,
                         group_keys(schedule, params_like)):
        if not keys:
            continue
        m_g = group_method(method, grp)
        g0 = None if init_grads is None else _take(init_grads, keys)
        for name, part in m_g.init(_take(params_like, keys), g0).items():
            merged.setdefault(name, {}).update(part)
    return {name: _sorted(tree) for name, tree in merged.items()}


# ---------------------------------------------------------------------------
# one client leg: the round of one method and carrier on the leaves given
# ---------------------------------------------------------------------------

def _agg(x: torch.Tensor, pods: int) -> torch.Tensor:
    """The mean over the clients, or per-pod means when ``pods > 1``."""
    return hier_lib.pod_mean_leaf(x, pods) if pods > 1 \
        else ef_lib.client_mean(x)


def _leafwise(method, carrier, plan: str, grads,
              clients: Dict[str, Tree], dp: int, eta, mask,
              pods: int, rng=None, axes: Optional[comm.Axes] = None) -> Tree:
    """The 'wire' and 'dense' plans one leaf at a time: pre_compress, then
    the carrier's encode → local_c → aggregate ('wire'), then
    post_compress; or the method's whole client-stacked step
    (``Method.update(..., batched=True)``: C on each client's flat leaf as
    one row, 'dense'), leaf i drawing from ``fold_in(rng, i)``. Every method
    acts leaf by leaf, so this is the reference's whole-tree round; one
    leaf's temporaries are alive at a time, and each leaf's new client state
    replaces the old entry of ``clients`` IN PLACE. Under a cohort ``mask``
    the non-sampled clients' deltas ('wire') or messages ('dense') are
    zeroed before the aggregate and their state is frozen leaf by leaf (the
    old leaf is alive until its new one is frozen). With ``axes`` the
    leaves are the one client a rank holds and each aggregate is a
    collective over ``axes`` (``carriers.wire_round_local``, or the
    all-reduced mean of the dense plan's message). Returns the aggregated
    message."""
    out: Tree = {}
    for i, key in enumerate(sorted(base_grads(grads, method))):
        old = {name: {key: tree[key]} for name, tree in clients.items()}
        g_leaf = _take_grads(grads, method, [key])
        if plan == "wire":
            delta, ctx = method.pre_compress(g_leaf, old, eta=eta)
            if mask is not None:
                delta = part_lib.apply_mask(mask, delta)
            if axes is None:
                c, mean = carrier_lib.wire_round_batched(
                    carrier, method.compressor, delta, dp)
            else:
                c, mean = carrier_lib.wire_round_local(
                    carrier, method.compressor, delta, axes)
            del delta
            msgs, new = method.post_compress(c, ctx)
        else:
            r = rng_lib.fold_in(rng, i) \
                if method.compressor.needs_rng else None
            msgs, new = method.update(g_leaf, old, r, eta=eta, batched=True)
        if plan == "wire":
            # the carrier's own aggregate, or per-pod means of the decoded
            # client messages (local_c IS the decode of what traveled)
            out[key] = _agg(c[key], pods) if pods > 1 else mean[key]
        else:
            if mask is not None:
                msgs = part_lib.apply_mask(mask, msgs)
            out[key] = _agg(msgs[key], pods) if axes is None \
                else comm.mean(axes, msgs[key][0])
        if mask is not None:
            new = part_lib.freeze_tree(mask, new, old)
        for name in clients:
            clients[name][key] = new[name][key]
    return out


def _fused_cohort(carrier, method, grads: Tree, clients: Dict[str, Tree],
                  eta, mask: torch.Tensor) -> Tree:
    """The 'fused' plan on the cohort's clients only: their grad, v and g
    rows gathered into contiguous stacks, one K2 launch a leaf on those,
    and v', g' written back into the cohort's rows of the state. The
    non-sampled clients' state is never read by a kernel nor written, so it
    stays frozen by construction. Returns the client-stacked c with zeros
    for the non-sampled clients (the reference's masked c)."""
    cohort = torch.nonzero(mask).flatten()
    sub_grads = {k: g.index_select(0, cohort) for k, g in grads.items()}
    sub = {name: {k: t.index_select(0, cohort) for k, t in tree.items()}
           for name, tree in clients.items()}
    c_sub, _ = carrier.fused_update(method, sub_grads, sub, eta=eta)
    c_tree: Tree = {}
    for k in sorted(grads):
        for name, tree in clients.items():
            tree[k].index_copy_(0, cohort, sub[name][k])
        c = c_sub[k]
        c_tree[k] = torch.zeros((grads[k].shape[0], *c.shape[1:]),
                                dtype=c.dtype, device=c.device
                                ).index_copy_(0, cohort, c)
    return c_tree


def batched_leg(method, carrier, plan: str, grads,
                clients: Dict[str, Tree], dp: int, eta=None, mask=None,
                pods: int = 1, rng=None) -> Tuple[Tree, Dict[str, Tree]]:
    """One carrier's round on the client-stacked leaves given, the clients on
    a leading axis: the ungrouped round runs it on the whole tree and
    :func:`round_batched` on each group's leaves. ``mask`` is an optional
    (dp,) cohort mask: the non-sampled clients add nothing to the aggregate
    and their state stays frozen (the rescale for absolute methods stays
    with the caller). ``pods > 1`` returns per-pod means on a leading pods
    axis (pod-major client blocks) instead of the mean over all clients.
    ``rng`` feeds a randomized compressor (the dense plan's). The client
    state is updated in place; returns (msg_mean, clients)."""
    if plan == "fused":
        if mask is None:
            c_tree, _ = carrier.fused_update(method, grads, clients, eta=eta)
        else:
            c_tree = _fused_cohort(carrier, method, grads, clients, eta, mask)
        return ef_lib.tree_map(lambda c: _agg(c, pods), c_tree), clients
    if plan == "fused_wire":
        if mask is not None:
            # unreachable behind the spec/build construction errors
            raise ValueError("sampled participation cannot run the "
                             "fused_wire plan")
        if pods > 1:
            # unreachable behind the spec/build construction errors
            raise ValueError("the fused_wire plan cannot run under a "
                             "hierarchical topology (its wire IS the "
                             "global aggregation)")
        msg_mean, _ = carrier.fused_wire_round(method, grads, clients,
                                               eta=eta)
        return msg_mean, clients
    return _leafwise(method, carrier, plan, grads, clients, dp, eta, mask,
                     pods, rng), clients


def client_method(method, n: int, row: int):
    """The method as client ``row`` of ``n`` runs it on the sharded
    runtime: a compressor that draws is wrapped in ``ClientRow``, so the
    client compresses with the stream the single-device round gives it."""
    if not method.compressor.needs_rng:
        return method
    return dataclasses.replace(method, compressor=comp_lib.ClientRow(
        method.compressor, n, row))


def local_leg(method, carrier, plan: str, grads, clients: Dict[str, Tree],
              axes: comm.Axes, eta=None, mask=None, rng=None
              ) -> Tuple[Tree, Dict[str, Tree]]:
    """:func:`batched_leg` for the ONE client a rank holds (leaves with a
    leading axis of 1), each aggregation an explicit collective over
    ``axes``: 'fused' all-reduces K2's c, 'fused_wire' K3's decoded wire,
    'wire' and 'dense' go leaf by leaf (:func:`_leafwise` with ``axes``).
    ``mask`` is this client's (1,) cohort entry: outside the cohort its
    contribution is zero and its state stays frozen (a fused plan runs no
    kernel on it). The plan is chosen by the caller on the unwrapped
    method; ``method`` here may carry ``client_method``'s wrapper. The
    client state is updated in place; returns (msg_mean, clients)."""
    if plan == "fused":
        if mask is not None and not float(mask[0]):
            c_tree = {k: torch.zeros(g.shape, dtype=clients["g"][k].dtype,
                                     device=g.device)
                      for k, g in grads.items()}
        else:
            c_tree, _ = carrier.fused_update(method, grads, clients, eta=eta)
        return {k: comm.mean(axes, c_tree[k][0]) for k in sorted(c_tree)}, \
            clients
    if plan == "fused_wire":
        if mask is not None:
            # unreachable behind the spec/build construction errors
            raise ValueError("sampled participation cannot run the "
                             "fused_wire plan")
        msg_mean, _ = carrier.fused_wire_round(method, grads, clients,
                                               eta=eta, axes=axes)
        return msg_mean, clients
    return _leafwise(method, carrier, plan, grads, clients, 1, eta, mask, 1,
                     rng, axes), clients


def round_local(schedule: CompressionSchedule, method, grads,
                states: Dict[str, Tree], axes: comm.Axes, eta=None,
                overlap: bool = False, mask=None, rng=None,
                client: Tuple[int, int] = (1, 0)
                ) -> Tuple[Tree, Dict[str, Tree]]:
    """Per-group client legs on the ONE client a rank holds, one wire and
    one collective over ``axes`` a group (the reference's shard_map leg).
    ``overlap`` runs each group carrier's gathers as the ring; ``mask`` is
    this client's (1,) cohort entry (the rescale stays with the caller);
    ``client`` is (n, this client's index) for a compressor that draws.
    Returns (msg_mean, states), the states updated as
    :func:`round_batched` updates them."""
    msg_mean: Tree = {}
    n_groups = len(schedule.groups)
    for gi, (grp, keys) in enumerate(zip(
            schedule.groups,
            group_keys(schedule, base_grads(grads, method)))):
        if not keys:
            continue
        m_g = group_method(method, grp)
        carrier = dataclasses.replace(carrier_lib.make(grp.carrier),
                                      overlap=overlap)
        plan = carrier.plan(m_g, eta)
        sub = _take_state(states, keys)
        agg_g, new_st = local_leg(client_method(m_g, *client), carrier, plan,
                                  _take_grads(grads, method, keys), sub,
                                  axes, eta, mask=mask,
                                  rng=_group_rng(rng, gi, n_groups))
        msg_mean.update(agg_g)
        for name, tree in new_st.items():
            states[name].update(tree)
    return _sorted(msg_mean), states


def round_batched(schedule: CompressionSchedule, method, grads,
                  states: Dict[str, Tree], dp: int, eta=None, mask=None,
                  pods: int = 1, rng=None) -> Tuple[Tree, Dict[str, Tree]]:
    """Per-group client legs, each group on its own carrier's plan, merged
    back by key. A group's sub-dicts hold the state's own tensors, so the
    fused plans' in-place writes land in ``states``; the wire and dense
    plans' new entries are copied back into it. ``mask``, ``pods`` and
    ``rng`` as in :func:`batched_leg` (each group on its
    :func:`_group_rng`). Returns (msg_mean, states)."""
    if pods > 1 and dp % pods:
        raise ValueError(f"pods={pods} must divide the client count {dp}")
    msg_mean: Tree = {}
    n_groups = len(schedule.groups)
    for gi, (grp, keys) in enumerate(zip(
            schedule.groups,
            group_keys(schedule, base_grads(grads, method)))):
        if not keys:
            continue
        m_g = group_method(method, grp)
        carrier = carrier_lib.make(grp.carrier)
        plan = carrier.plan(m_g, eta)
        sub = _take_state(states, keys)
        agg_g, new_st = batched_leg(m_g, carrier, plan,
                                    _take_grads(grads, method, keys), sub,
                                    dp, eta, mask=mask, pods=pods,
                                    rng=_group_rng(rng, gi, n_groups))
        msg_mean.update(agg_g)
        for name, tree in new_st.items():
            states[name].update(tree)
    return _sorted(msg_mean), states


# ---------------------------------------------------------------------------
# grouped downlink (server → client broadcast) and cross-pod hop
# ---------------------------------------------------------------------------

def downlink_round_grouped(schedule: CompressionSchedule, g_server: Tree,
                           h: Tree, rng=None, memory: bool = True
                           ) -> Tuple[Tree, Tree]:
    """Per-group downlink legs: groups with a downlink carrier run
    ``ef.downlink_sync`` on their leaves (``memory=False``: the naive
    broadcast of C(g), h tracking the decode); groups without ship the
    implicit dense broadcast (g_est is g_server and h tracks it). Returns
    (g_est, h_new)."""
    est: Tree = {}
    h_out: Tree = {}
    n_groups = len(schedule.groups)
    for gi, (grp, keys) in enumerate(zip(schedule.groups,
                                         group_keys(schedule, g_server))):
        if not keys:
            continue
        s_g = _take(g_server, keys)
        if not grp.has_downlink:
            est.update(s_g)
            h_out.update(s_g)
            continue
        est_g, h_new_g = ef_lib.downlink_sync(
            carrier_lib.make(grp.down_carrier), grp.down_comp(), s_g,
            _take(h, keys), rng=_group_rng(rng, gi, n_groups), memory=memory)
        est.update(est_g)
        h_out.update(h_new_g if h_new_g is not None else est_g)
    return _sorted(est), _sorted(h_out)


def cross_round_grouped(schedule: CompressionSchedule, t_new: Tree,
                        b: Tree, rng=None) -> Tree:
    """Per-group cross-pod hop for ONE pod aggregator: groups with a
    non-trivial cross carrier ship C_cross(t' − b) and integrate its decode
    (``ef.downlink_sync``); trivial groups are transparent, b' = t'.
    ``rng`` is the pod's cross stream. Returns the new broadcast state
    b'."""
    out: Tree = {}
    n_groups = len(schedule.groups)
    for gi, (grp, keys) in enumerate(zip(schedule.groups,
                                         group_keys(schedule, t_new))):
        if not keys:
            continue
        t_g = _take(t_new, keys)
        if grp.trivial_cross:
            out.update(t_g)
            continue
        _, b_new_g = ef_lib.downlink_sync(
            carrier_lib.make(grp.cross_carrier), grp.cross_comp(), t_g,
            _take(b, keys), rng=_group_rng(rng, gi, n_groups))
        out.update(b_new_g)
    return _sorted(out)


# ---------------------------------------------------------------------------
# accounting — per-group wire words
# ---------------------------------------------------------------------------

def _size(x) -> int:
    return int(x.numel())


def wire_words_tree(schedule: CompressionSchedule, method, tree: Tree,
                    direction: str = "up", eta=None
                    ) -> Tuple[Tuple[float, ...], float]:
    """Per-client wire words of one message over ``tree``, per group and in
    total, on the plan that would run: a group whose carrier degrades to the
    dense plan (or fuses: the fused wire is dense) ships its dense word
    count. ``direction='down'`` counts the broadcast (a group with no
    downlink ships its dense leaves); ``'cross'`` counts ONE pod
    aggregator's cross-pod message (callers multiply by pods)."""
    per: List[float] = []
    for grp, keys in zip(schedule.groups, group_keys(schedule, tree)):
        total = 0.0
        if direction == "down":
            car = carrier_lib.make(grp.down_carrier)
            for k in keys:
                d = _size(tree[k])
                total += (carrier_lib.downlink_words(car, grp.down_comp(), d)
                          if grp.has_downlink else float(d))
        elif direction == "cross":
            car = carrier_lib.make(grp.cross_carrier)
            for k in keys:
                d = _size(tree[k])
                total += (float(d) if grp.trivial_cross
                          else carrier_lib.downlink_words(
                              car, grp.cross_comp(), d))
        else:
            m_g = group_method(method, grp)
            car = carrier_lib.make(grp.carrier)
            plan = car.plan(m_g, eta)
            for k in keys:
                d = _size(tree[k])
                # the fused_wire plan ships the quantized payload, so it
                # counts the carrier's wire words as 'wire' does
                total += (car.wire_words(m_g.compressor, d)
                          if plan in ("wire", "fused_wire") else float(d))
        per.append(total)
    return tuple(per), float(sum(per))


def coords_tree(schedule: CompressionSchedule, method, tree: Tree) -> float:
    """Idealized transmitted-coordinate count (the paper's x-axis), summed
    over groups."""
    total = 0.0
    for grp, keys in zip(schedule.groups, group_keys(schedule, tree)):
        m_g = group_method(method, grp)
        for k in keys:
            total += m_g.coords_per_message(_size(tree[k]))
    return total


def alpha_min(schedule: CompressionSchedule, tree: Tree) -> float:
    """The composed contraction parameter: α = min over the factors of a
    partition."""
    alphas = [grp.compressor.alpha(_size(tree[k]))
              for grp, keys in zip(schedule.groups,
                                   group_keys(schedule, tree))
              for k in keys]
    return min(alphas) if alphas else 1.0


def plan_table(schedule: CompressionSchedule, method, tree: Tree,
               eta=None) -> str:
    """The resolved table, one row per group: leaf and parameter counts,
    transport plan (and its degradation reason), downlink carrier and
    per-message wire words — the reference's layout, character for
    character."""
    idx = group_keys(schedule, tree)
    up_per, up_total = wire_words_tree(schedule, method, tree, "up", eta)
    dn_per, dn_total = wire_words_tree(schedule, method, tree, "down", eta)
    rows = [f"{'group':18s} {'leaves':>6s} {'params':>10s} "
            f"{'compressor':14s} {'carrier':12s} {'plan':10s} "
            f"{'down':8s} {'wire_up':>10s} {'wire_down':>10s}"]
    for gi, grp in enumerate(schedule.groups):
        m_g = group_method(method, grp)
        plan, reason = carrier_lib.make(grp.carrier).plan_with_reason(m_g,
                                                                     eta)
        params = sum(_size(tree[k]) for k in idx[gi])
        rows.append(
            f"{grp.pattern:18s} {len(idx[gi]):6d} {params:10d} "
            f"{type(grp.compressor).__name__:14s} {grp.carrier:12s} "
            f"{plan:10s} {grp.down_carrier:8s} {up_per[gi]:10.0f} "
            f"{dn_per[gi]:10.0f}"
            + (f"  (degraded: {reason})" if reason else ""))
    rows.append(f"{'TOTAL':18s} {len(tree):6d} "
                f"{sum(_size(x) for x in tree.values()):10d} "
                f"{'':14s} {'':12s} {'':10s} {'':8s} {up_total:10.0f} "
                f"{dn_total:10.0f}")
    return "\n".join(rows)
