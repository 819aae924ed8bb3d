"""One EF synchronization round (counterpart of src/repro/core/distributed.py):
on one device (``ef_round``, the vmap runtime) or with one client a rank
over ``torch.distributed`` (``ef_round_sharded``, the shard_map runtime).

On one device the paper's n clients are emulated: per-client gradients carry
a leading client axis, as in the reference's layout, and the carrier folds
the clients into kernel rows. Plans: ``fused`` (K2), ``fused_wire`` (K3 up,
K4 down), ``wire`` (the unfused sparse and quantized wires, K5/K6) and
``dense``. Around them the round runs the reference's axes in its order: a
per-parameter-group schedule (core/schedule.py, every group on its own
plan), sampled participation (core/participation.py, a seeded cohort a
round, the other clients frozen) and the two-tier hierarchy
(core/hierarchy.py, per-pod means and a compressed cross-pod hop), then the
downlink. An optional ``torch.Generator`` feeds the randomized compressors:
the clients' and groups' streams come off it, the downlink's off
``fold_in(rng, DOWNLINK_FOLD)`` and each pod's cross hop off ``CROSS_FOLD``
(core/rng.py), as the reference folds its key.

``ef_round_sharded`` runs the same round with the ONE client a rank holds
(its leaves with a leading axis of 1, on a ``launch/mesh.py`` Mesh whose
client axes are ``EFConfig.client_axes``, pod-major: ('pod', 'data') under
client granularity 'group', ('pod',) or () under 'pod', where every data
rank of a pod holds the pod's client and runs its leg alike on the
gradient its data group summed, :func:`sharded_value_and_grad`) and every
aggregation an explicit collective issued by the carrier (core/comm.py):
the same plans,
the grouped engine (``schedule.round_local``), the cohort mask of the
global cohort, the sharded pod tier and the downlink, which every rank
encodes alike from the replicated server state (that encoding IS the
broadcast). Client i draws exactly the stream the single-device round gives
client i (``schedule.client_method``), so the two runtimes agree client for
client; the means differ only by the all-reduce's summation order. On a
mesh whose 'model' axis exceeds 1 every leaf a rank holds is its block of
the parameter's split (launch/shardings.py) and the round runs on those
shards unchanged: the client axes' group through a rank spans the ranks
of its 'model' coordinate, so a shard's wire meets only that shard's
wires (the reference's per-shard round under shard_map).
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Optional, Tuple

import torch

from repro_torch.core import carriers as carrier_lib
from repro_torch.core import comm
from repro_torch.core import compressors as comp_lib
from repro_torch.core import ef as ef_lib
from repro_torch.core import hierarchy as hier_lib
from repro_torch.core import participation as part_lib
from repro_torch.core import rng as rng_lib
from repro_torch.core import schedule as sched_lib

Tree = Dict[str, torch.Tensor]


@dataclasses.dataclass(frozen=True)
class EFConfig:
    method: ef_lib.Method
    carrier: str = "dense"
    # the downlink leg (the reference's DESIGN.md §8): 'dense' with no
    # compressor runs no downlink machinery at all
    down_carrier: str = "dense"
    down_compressor: Optional[comp_lib.Compressor] = None
    # per-parameter-group compression (the reference's DESIGN.md §9): when
    # set, every leg (uplink, aggregation, downlink, state init) runs per
    # group and the single-knob fields above are ignored. None runs the
    # ungrouped round; a one-group schedule is bit-identical to it.
    schedule: Optional[sched_lib.CompressionSchedule] = None
    # partial participation (§11): mode 'sampled' runs a seeded cohort a
    # round and freezes the other clients' EF state; None or mode 'full'
    # runs every client, and a fraction-1.0 cohort is bit-identical to it
    participation: Optional[part_lib.Participation] = None
    # two-tier aggregation (§13): clients → pod aggregator → server, the
    # pods' EF memory in ef_state['pods'] = {t, b}; None or pods 1 runs no
    # hierarchical machinery
    hops: Optional[hier_lib.Hops] = None
    # the mesh axes the sharded round aggregates over (the reference's
    # ``data_axes``: ``Mesh.client_axes`` of the client granularity,
    # ('pod', 'data') under 'group', ('pod',) or () under 'pod'); the
    # sharded round needs them, the single-device round never reads them
    client_axes: Optional[Tuple[str, ...]] = None

    @property
    def effective_hops(self) -> Optional[hier_lib.Hops]:
        return hier_lib.effective(self.hops)

    @property
    def has_downlink(self) -> bool:
        if self.schedule is not None:
            return self.schedule.has_downlink
        return self.down_carrier != "dense" or self.down_compressor is not None

    def down_comp(self) -> comp_lib.Compressor:
        return self.down_compressor if self.down_compressor is not None \
            else comp_lib.Identity()


def per_client_value_and_grad(loss_fn: Callable, params: Tree,
                              batch: Dict[str, torch.Tensor], dp: int
                              ) -> Tuple[torch.Tensor, Tree, Tree]:
    """loss_fn(params, sub_batch) -> (scalar loss, aux: a dict of scalars).
    Returns (mean loss over the clients, aux averaged over the clients,
    per-client grads with a leading dp axis, contiguous, in the params'
    dtypes).

    The clients run as ONE pass, as the reference's ``jax.vmap`` of
    ``value_and_grad``: ``torch.func.vmap`` of ``grad_and_value`` over the
    batch reshaped to (dp, b/dp, ...), the params shared. Every product of
    the forward sees the whole global batch, each weight is cast to the
    activation dtype once for all clients, and the backward's weight
    products come out with the client axis leading."""
    b = batch["tokens"].shape[0]
    if b % dp:
        raise ValueError(f"global batch {b} not divisible by dp={dp}")
    sub = {n: x.reshape(dp, b // dp, *x.shape[1:]) for n, x in batch.items()}
    grads, (losses, auxs) = torch.func.vmap(
        torch.func.grad_and_value(loss_fn, has_aux=True),
        in_dims=(None, 0))(params, sub)
    return (losses.mean(), {k: a.mean(0) for k, a in auxs.items()},
            {k: g.contiguous() for k, g in grads.items()})


def client_value_and_grad(loss_fn: Callable, params: Tree,
                          batch: Dict[str, torch.Tensor]
                          ) -> Tuple[torch.Tensor, Tree, Tree]:
    """One client's pass without the client vmap: (loss, aux, grads with
    a leading axis of 1). The tensor-parallel pass runs here, since its
    collectives (core/comm.py's f and g) have no batching rule."""
    grads, (loss, aux) = torch.func.grad_and_value(loss_fn, has_aux=True)(
        params, batch)
    return loss, aux, {k: g[None].contiguous() for k, g in grads.items()}


def round_axes(efc: EFConfig) -> Tuple[str, ...]:
    """``efc.client_axes``; a readable error where a sharded round is given
    a config that names none."""
    if efc.client_axes is None:
        raise ValueError("a sharded round aggregates over EFConfig."
                         "client_axes, which is None: pass build.ef_config "
                         "the mesh's client_axes(granularity)")
    return tuple(efc.client_axes)


def sum_shares(axes, grads: Tree) -> Tree:
    """A client's gradient from its data group's shares: each leaf summed
    over ``axes`` in f32 and cast back (one all-reduce a leaf; every member
    gets the same bits). Takes the leaves out of ``grads`` one at a time,
    so a share is freed as its sum arrives."""
    return {k: comm.share_sum(axes, grads.pop(k)) for k in list(grads)}


def sharded_value_and_grad(loss_fn: Callable, params: Tree,
                           batch: Dict[str, torch.Tensor], mesh,
                           c_axes: Tuple[str, ...]
                           ) -> Tuple[torch.Tensor, Tree, Tree]:
    """This rank's client's (loss, aux, grads with a leading axis of 1) on
    a mesh of many ranks, ``batch`` being this rank's rows of the global
    batch (:func:`rank_rows`). The client is this rank's index on
    ``c_axes``. Where its data group (``mesh.split_axes``) holds more than
    one rank, each rank holds its contiguous sub-block of the client's rows
    and ``loss_fn`` returns an additive share of the client's loss
    (``train_loss``'s ``split``); the loss and the gradients are then
    summed over the group
    (:func:`sum_shares`), and the aux values stay this rank's shares (no
    step reads them: a caller that wants the client's sums them over
    ``split``). A data group or a 'model' axis
    above one rank runs without the vmap (:func:`client_value_and_grad`:
    their collectives have no batching rule)."""
    split = mesh.axes(mesh.split_axes(c_axes))
    if split.size > 1 or mesh.shape.get("model", 1) > 1:
        loss, aux, grads = client_value_and_grad(loss_fn, params, batch)
    else:
        loss, aux, grads = per_client_value_and_grad(loss_fn, params, batch,
                                                     1)
    if split.size > 1:
        loss = comm.share_sum(split, loss)
        grads = sum_shares(split, grads)
    return loss, aux, grads


def tree_norm_sq_sharded(tree: Tree, pspecs, model_axes) -> torch.Tensor:
    """‖tree‖² of a tree of this rank's 'model' shards: the split leaves'
    squares summed over the axis, the replicated leaves' counted once.
    Every rank of the axis gets the same bits."""
    split = [k for k in sorted(tree) if "model" in pspecs[k]]
    whole = [k for k in sorted(tree) if "model" not in pspecs[k]]
    dev = next(iter(tree.values())).device
    sq = torch.zeros((), dtype=torch.float32, device=dev)
    for k in split:
        sq = sq + torch.sum(torch.square(tree[k].float()))
    sq = comm.all_reduce_sum(model_axes, sq)
    for k in whole:
        sq = sq + torch.sum(torch.square(tree[k].float()))
    return sq


def init_ef_state(efc: EFConfig, params: Tree, dp: int,
                  init_grads: Optional[Tree] = None) -> Dict:
    """init_grads: optional per-client grads (dp leading) for Alg 1 line 2
    (v⁰ = g⁰ = first gradients); the clients' state takes that tensor over
    (or its cast to the method's state dtype). Under a schedule each group
    takes its own state dtype. The server's estimate, the downlink memory h
    and the pods' memories stay in the params' dtype."""
    method = efc.method
    if efc.schedule is not None:
        def init_one(like, g=None):
            return sched_lib.init_state_grouped(efc.schedule, method, like, g)
    else:
        init_one = method.init
    if init_grads is None:
        like = ef_lib.tree_map(
            lambda p: torch.zeros((dp, *p.shape), dtype=p.dtype,
                                  device=p.device), params)
        clients = init_one(like)
        server = ef_lib.server_init(method, params)
    else:
        clients = init_one(init_grads, init_grads)
        server = ef_lib.server_init(
            method, params,
            ef_lib.tree_map(lambda g: g.sum(0) / dp, init_grads))
    state = {"clients": clients, "server": server}
    if efc.has_downlink:
        state["h"] = ef_lib.downlink_init(server)
    hops = efc.effective_hops
    if hops is not None:
        hier_lib.check_pods(hops, dp)
        state["pods"] = hier_lib.pod_init(params, hops.pods)
    return state


def _participation_mask(efc: EFConfig, n: int, step, device
                        ) -> Optional[torch.Tensor]:
    """The round's cohort mask under sampled participation, or None on the
    full path. Refuses 'async' (every round here is a barrier) and a missing
    step (the cohort is a pure function of (seed, step))."""
    part = efc.participation
    if part is None or part.mode == "full":
        return None
    if part.mode == "async":
        raise ValueError(
            "participation mode 'async' does not run on the synchronous "
            "runtimes (every round is a barrier); drive the event-driven "
            "simulator instead: repro_torch.core.participation.run_async")
    if step is None:
        raise ValueError(
            "sampled participation derives the round cohort from the step "
            "index; pass step= into ef_round")
    return part_lib.cohort_mask(part, n, int(step), device)


def ef_round(efc: EFConfig, grads, ef_state: Dict,
             eta=None, step: Optional[int] = None,
             rng: Optional[torch.Generator] = None) -> Tuple[Tree, Dict]:
    """One round on per-client grads (dp leading; a pair of such trees for
    the paired-gradient methods). Returns (the estimate gᵗ⁺¹ the model
    steps with, the new ef_state). The client state is updated in place
    (the fused plans write v and g, the others replace them leaf by leaf).
    ``step`` picks a sampled round's cohort; ``rng`` is the round's stream
    for randomized compressors; ``eta`` may be a 0-d tensor (a
    time-varying schedule, which runs the unfused plans).

    The reference's branches, in its order: the cohort mask, the pod
    topology, the grouped engine or the carrier's plan (one client leg,
    ``schedule.batched_leg``, serves both), the participation postlude, the
    pod tier or the server step, the downlink."""
    method = efc.method
    first = next(iter(sched_lib.base_grads(grads, method).values()))
    dp = first.shape[0]
    clients, server = ef_state["clients"], ef_state["server"]
    carrier = carrier_lib.make(efc.carrier)
    plan = carrier.plan(method, eta)
    mask = _participation_mask(efc, dp, step, first.device)

    # under a NON-trivial cross hop the intra aggregation gives per-pod
    # means (pods leading, pod-major client blocks); a trivial cross keeps
    # the flat aggregation's operations
    hops = efc.effective_hops
    trivial_cross = hops is None or hier_lib.cross_is_trivial(
        hops, efc.schedule)
    want_pods = hops is not None and not trivial_cross
    if hops is not None:
        hier_lib.check_pods(hops, dp)
        if mask is not None:
            raise ValueError(
                "sampled participation does not compose with hierarchical "
                "aggregation (guarded at spec/build construction)")
        if plan == "fused_wire":
            raise ValueError(
                "fused_wire carriers aggregate all clients inside the "
                "kernel; there is no per-pod message to re-aggregate "
                "(guarded at spec/build construction)")
    pods = hops.pods if want_pods else 1

    if efc.schedule is not None:
        msg_mean, new_clients = sched_lib.round_batched(
            efc.schedule, method, grads, clients, dp, eta, mask=mask,
            pods=pods, rng=rng)
    else:
        msg_mean, new_clients = sched_lib.batched_leg(
            method, carrier, plan, grads, clients, dp, eta, mask=mask,
            pods=pods, rng=rng)

    if mask is not None:
        # Bells & Whistles: delta methods fold (1/n)·Σ_S as it is, absolute
        # ones rescale to the cohort mean; the non-sampled clients' state
        # was frozen inside the leg
        msg_mean = part_lib.rescale_message(
            method, msg_mean, dp, efc.participation.cohort_size(dp))
    if want_pods:
        new_pods, new_server = hier_lib.round_pods_batched(
            hops, efc.schedule, method, msg_mean, ef_state["pods"], server,
            rng)
    else:
        new_server = ef_lib.server_step(method, server, msg_mean)
    new_state = {"clients": new_clients, "server": new_server}
    if hops is not None:
        new_state["pods"] = new_pods if want_pods else \
            hier_lib.trivial_bookkeeping(method, ef_state["pods"], msg_mean)
    if not efc.has_downlink:
        return new_server, new_state
    r_down = rng_lib.fold_in(rng, carrier_lib.DOWNLINK_FOLD)
    if efc.schedule is not None:
        g_est, h_new = sched_lib.downlink_round_grouped(
            efc.schedule, new_server, ef_state["h"], r_down)
    else:
        g_est, h_new = ef_lib.downlink_sync(
            carrier_lib.make(efc.down_carrier), efc.down_comp(), new_server,
            ef_state["h"], rng=r_down)
    new_state["h"] = h_new
    return g_est, new_state


# ---------------------------------------------------------------------------
# the sharded runtime: one client a rank, explicit collectives
# ---------------------------------------------------------------------------

def client_rows(batch: Dict[str, torch.Tensor], n: int, client: int
                ) -> Dict[str, torch.Tensor]:
    """Client ``client``'s rows of a global batch: the i-th of n contiguous
    blocks, the rows the single-device round gives that client."""
    b = batch["tokens"].shape[0]
    if b % n:
        raise ValueError(f"global batch {b} not divisible by dp={n}")
    m = b // n
    return {k: x[client * m:(client + 1) * m] for k, x in batch.items()}


def rank_rows(batch: Dict[str, torch.Tensor], mesh,
              c_axes: Tuple[str, ...]) -> Dict[str, torch.Tensor]:
    """This rank's rows of a global batch: its client's block over
    ``c_axes`` and, where the client's data group (``mesh.split_axes``)
    holds several ranks, this rank's sub-block of it."""
    everyone = mesh.axes(c_axes)
    split = mesh.axes(mesh.split_axes(c_axes))
    rows = client_rows(batch, everyone.size, everyone.index)
    if split.size > 1:
        rows = client_rows(rows, split.size, split.index)
    return rows


def init_ef_state_sharded(efc: EFConfig, params: Tree, mesh,
                          init_grads: Optional[Tree] = None) -> Dict:
    """``init_ef_state`` in the sharded layout: this rank's client state
    (leading axis 1), from its own first gradients ``init_grads`` (1, ...)
    when given; the server estimate from their mean over all clients (an
    all-reduce over the client axes: every rank gets the same bits); h
    and, with hops, this pod's memory slot (leading axis 1)."""
    method = efc.method
    axes = mesh.axes(round_axes(efc))
    if efc.schedule is not None:
        def init_one(like, g=None):
            return sched_lib.init_state_grouped(efc.schedule, method, like, g)
    else:
        init_one = method.init
    if init_grads is None:
        clients = init_one(ef_lib.tree_map(
            lambda p: torch.zeros((1, *p.shape), dtype=p.dtype,
                                  device=p.device), params))
        server = ef_lib.server_init(method, params)
    else:
        clients = init_one(init_grads, init_grads)
        server = ef_lib.server_init(method, params, ef_lib.tree_map(
            lambda g: (comm.all_reduce_sum(axes, g[0].float())
                       / axes.size).to(g.dtype), init_grads))
    state = {"clients": clients, "server": server}
    if efc.has_downlink:
        state["h"] = ef_lib.downlink_init(server)
    hops = efc.effective_hops
    if hops is not None:
        hier_lib.check_pods(hops, axes.size)
        state["pods"] = hier_lib.pod_init(params, 1)
    return state


def ef_round_sharded(efc: EFConfig, grads, ef_state: Dict, mesh,
                     eta=None, step: Optional[int] = None,
                     rng: Optional[torch.Generator] = None,
                     overlap: bool = False) -> Tuple[Tree, Dict]:
    """One round with ONE client a rank: ``grads`` and
    ``ef_state['clients']`` carry this client's leaves on a leading axis of
    1, ``server``/``h`` are replicated and ``pods`` holds this pod's slot.
    Each rank runs its client's update, then the carrier issues the
    aggregation collective itself over the client axes of ``mesh``:

      'dense'      all-reduce of the method's message (mean over clients)
      'fused'      K2, then the all-reduce of c
      'fused_wire' K3 on the client's rows, then the all-reduce of the
                   decoded wire (dequantize, then sum)
      'wire'       the sparse and sparse-quantized payloads all-gather the
                   wire (``overlap``: the ring, the same bits) and decode each
                   client's chunk; the dense payload all-reduces its decode

    The cohort mask comes from the global cohort (then the rescale and the
    freeze); under hops the intra hop reduces over the non-pod axes (all of
    them when the cross hop is trivial) and the pod tier all-reduces the
    pods' messages over 'pod'. The downlink key comes off the round rng
    before any per-client use, and every rank encodes the same new server
    state. Returns (gᵗ⁺¹ estimate, new state), replicated parts equal bit
    for bit on every rank."""
    method = efc.method
    c_axes = round_axes(efc)
    sched = efc.schedule
    carrier = dataclasses.replace(carrier_lib.make(efc.carrier),
                                  overlap=overlap)
    plan = carrier.plan(method, eta)
    everyone = mesh.axes(c_axes)
    n_total, client = everyone.size, everyone.index   # pod-major index
    first = next(iter(sched_lib.base_grads(grads, method).values()))
    if first.shape[0] != 1:
        raise ValueError(f"a rank holds one client: grads lead with "
                         f"{first.shape[0]}")
    mask_full = _participation_mask(efc, n_total, step, first.device)
    m_cohort = efc.participation.cohort_size(n_total) \
        if mask_full is not None else n_total

    hops = efc.effective_hops
    trivial_cross = hops is None or hier_lib.cross_is_trivial(hops, sched)
    if hops is not None:
        if "pod" not in c_axes:
            raise ValueError(
                "hierarchical aggregation needs a 'pod' client axis; "
                f"got client axes {c_axes}")
        if hops.pods != mesh.shape["pod"]:
            raise ValueError(
                f"hops.pods={hops.pods} must equal the mesh pod axis "
                f"({mesh.shape['pod']})")
        if mask_full is not None:
            raise ValueError(
                "sampled participation does not compose with hierarchical "
                "aggregation (guarded at spec/build construction)")
        if plan == "fused_wire":
            raise ValueError(
                "fused_wire carriers aggregate all clients inside the "
                "kernel; there is no per-pod message to re-aggregate "
                "(guarded at spec/build construction)")
    intra = everyone if trivial_cross \
        else mesh.axes(tuple(a for a in c_axes if a != "pod"))
    mask_m = None if mask_full is None else mask_full[client:client + 1]

    clients, server = ef_state["clients"], ef_state["server"]
    # the client's randomized compressor draws the single-device round's
    # batched stream and keeps its own row (schedule.client_method), so the
    # round's generator reaches the leg unfolded
    if sched is not None:
        msg_mean, new_clients = sched_lib.round_local(
            sched, method, grads, clients, intra, eta, overlap=overlap,
            mask=mask_m, rng=rng, client=(n_total, client))
    else:
        msg_mean, new_clients = sched_lib.local_leg(
            sched_lib.client_method(method, n_total, client), carrier, plan,
            grads, clients, intra, eta, mask=mask_m, rng=rng)
    if mask_m is not None:
        msg_mean = part_lib.rescale_message(method, msg_mean, n_total,
                                            m_cohort)

    new_pods = None
    if trivial_cross:
        new_server = ef_lib.server_step(method, server, msg_mean)
        if hops is not None:
            # msg_mean is the global mean: the pod memory is bookkeeping
            new_pods = hier_lib.trivial_bookkeeping(
                method, ef_state["pods"], msg_mean)
    else:
        pod = mesh.coordinate()["pod"]
        st = {name: {k: x[0] for k, x in tree.items()}
              for name, tree in ef_state["pods"].items()}
        r_pod = rng_lib.fold_in(rng_lib.fold_in(rng, hier_lib.CROSS_FOLD),
                                pod)
        t_new = hier_lib.pod_target(method, st["t"], msg_mean)
        b_new = hier_lib.cross_sync(hops, sched, t_new, st["b"], r_pod)
        pod_msg = hier_lib.pod_message(method, st["b"], b_new)
        pods_axes = mesh.axes(("pod",))
        server_msg = ef_lib.tree_map(
            lambda m: (comm.all_reduce_sum(pods_axes, m.float())
                       / hops.pods).to(m.dtype), pod_msg)
        new_server = ef_lib.server_step(method, server, server_msg)
        new_pods = {"t": ef_lib.tree_map(lambda x: x[None], t_new),
                    "b": ef_lib.tree_map(lambda x: x[None], b_new)}
    new_state = {"clients": new_clients, "server": new_server}
    if new_pods is not None:
        new_state["pods"] = new_pods
    if not efc.has_downlink:
        return new_server, new_state
    r_down = rng_lib.fold_in(rng, carrier_lib.DOWNLINK_FOLD)
    if sched is not None:
        g_est, h_new = sched_lib.downlink_round_grouped(
            sched, new_server, ef_state["h"], r_down)
    else:
        g_est, h_new = ef_lib.downlink_sync(
            carrier_lib.make(efc.down_carrier), efc.down_comp(), new_server,
            ef_state["h"], rng=r_down)
    new_state["h"] = h_new
    return g_est, new_state


def make_train_step(loss_fn: Callable, efc: EFConfig, optimizer, dp: int,
                    eta: Optional[float] = None, mesh=None,
                    overlap: bool = False, pspecs=None):
    """Returns train_step(params, opt_state, ef_state, batch, step, rng) →
    (params, opt_state, ef_state, metrics). ``rng`` is the step's
    generator (``rng.round_generator(seed, step)``, or None when no
    compressor draws); the round draws from ``fold_in(rng, 1)``, as the
    reference's ``r_comp``. With a ``mesh`` of more than one rank the step
    runs sharded: ``batch`` is this rank's rows of the global batch
    (:func:`rank_rows`), its gradients are its client's
    (:func:`sharded_value_and_grad`: under client granularity 'pod' the
    sum of its data group's shares), the
    round is ``ef_round_sharded`` over ``efc``'s client axes (its gathers
    the ring under ``overlap``), and the loss is the clients' mean
    (all-reduced); g_norm is that of the replicated estimate, the same on
    every rank.

    On a mesh whose 'model' axis exceeds 1, ``params`` and every state
    tree hold this rank's shards (``pspecs``, launch/shardings.py),
    ``loss_fn`` is the tensor-parallel pass (one client, no vmap:
    :func:`client_value_and_grad`), the round runs on the shards with the
    client axes at this rank's 'model' coordinate, and g_norm sums the
    split leaves' squares over 'model' (:func:`tree_norm_sq_sharded`)."""
    from repro_torch.optim.optimizer import apply_updates
    sharded = mesh is not None and mesh.size > 1
    c_axes = round_axes(efc) if sharded else ()
    everyone = mesh.axes(c_axes) if sharded else None
    model = mesh.axes(("model",)) if sharded else comm.Axes()

    def clients_pass(params, batch):
        if not sharded:
            loss, _, grads = per_client_value_and_grad(loss_fn, params,
                                                       batch, dp)
            return loss, grads
        loss, _, grads = sharded_value_and_grad(loss_fn, params, batch,
                                                mesh, c_axes)
        return comm.mean(everyone, loss), grads

    def norm_sq(tree):
        if model.size > 1:
            return tree_norm_sq_sharded(tree, pspecs, model)
        return ef_lib.tree_norm_sq(tree)

    def train_step(params, opt_state, ef_state, batch, step, rng=None):
        loss, grads = clients_pass(params, batch)
        if sharded:
            g_est, ef_state = ef_round_sharded(
                efc, grads, ef_state, mesh, eta=eta, step=step,
                rng=rng_lib.fold_in(rng, 1), overlap=overlap)
        else:
            g_est, ef_state = ef_round(efc, grads, ef_state, eta=eta,
                                       step=step, rng=rng_lib.fold_in(rng, 1))
        del grads                      # free the per-client stack early
        updates, opt_state = optimizer.update(g_est, opt_state, params, step)
        params = apply_updates(params, updates)
        metrics = {"loss": loss, "g_norm": torch.sqrt(norm_sq(g_est))}
        return params, opt_state, ef_state, metrics

    return train_step
