"""One EF synchronization round on a single device (counterpart of the vmap
runtime in src/repro/core/distributed.py).

The paper's n clients are emulated on one device: per-client gradients carry
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
(core/rng.py), as the reference folds its key. The sharded multi-device
runtime arrives with a later slice (ROADMAP Queue 1).
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Optional, Tuple

import torch

from repro_torch.core import carriers as carrier_lib
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


def make_train_step(loss_fn: Callable, efc: EFConfig, optimizer, dp: int,
                    eta: Optional[float] = None):
    """Returns train_step(params, opt_state, ef_state, batch, step, rng) →
    (params, opt_state, ef_state, metrics). ``rng`` is the step's
    generator (``rng.round_generator(seed, step)``, or None when no
    compressor draws); the round draws from ``fold_in(rng, 1)``, as the
    reference's ``r_comp``."""
    from repro_torch.optim.optimizer import apply_updates

    def train_step(params, opt_state, ef_state, batch, step, rng=None):
        loss, _, grads = per_client_value_and_grad(loss_fn, params, batch,
                                                   dp)
        g_est, ef_state = ef_round(efc, grads, ef_state, eta=eta,
                                   step=step, rng=rng_lib.fold_in(rng, 1))
        del grads                      # free the per-client stack early
        updates, opt_state = optimizer.update(g_est, opt_state, params, step)
        params = apply_updates(params, updates)
        metrics = {"loss": loss,
                   "g_norm": torch.sqrt(ef_lib.tree_norm_sq(g_est))}
        return params, opt_state, ef_state, metrics

    return train_step
