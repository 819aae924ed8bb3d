"""One EF synchronization round on a single device (counterpart of the vmap
runtime in src/repro/core/distributed.py).

The paper's n clients are emulated on one device: per-client gradients carry
a leading client axis, as in the reference's layout, and the carrier folds
the clients into kernel rows. Plans: ``fused`` (K2), ``fused_wire`` (K3 up,
K4 down), ``wire`` (the unfused sparse and quantized wires, K5/K6) and
``dense``. The sharded multi-device runtime, the per-group schedule, partial
participation and the two-tier hierarchy arrive with later slices (ROADMAP
Queue 1).
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Optional, Tuple

import torch

from repro_torch.core import carriers as carrier_lib
from repro_torch.core import compressors as comp_lib
from repro_torch.core import ef as ef_lib

Tree = Dict[str, torch.Tensor]


@dataclasses.dataclass(frozen=True)
class EFConfig:
    method: ef_lib.Method
    carrier: str = "dense"
    # the downlink leg (the reference's DESIGN.md §8): 'dense' with no
    # compressor runs no downlink machinery at all
    down_carrier: str = "dense"
    down_compressor: Optional[comp_lib.Compressor] = None

    @property
    def has_downlink(self) -> bool:
        return self.down_carrier != "dense" or self.down_compressor is not None

    def down_comp(self) -> comp_lib.Compressor:
        return self.down_compressor if self.down_compressor is not None \
            else comp_lib.Identity()


def per_client_value_and_grad(loss_fn: Callable, params: Tree,
                              batch: Dict[str, torch.Tensor], dp: int
                              ) -> Tuple[torch.Tensor, Tree]:
    """loss_fn(params, sub_batch) -> scalar loss. Returns (mean loss over the
    clients, per-client grads with a leading dp axis). The clients run one
    after another; each one's gradient lands in a preallocated stack."""
    b = batch["tokens"].shape[0]
    if b % dp:
        raise ValueError(f"global batch {b} not divisible by dp={dp}")
    keys = sorted(params)
    grads = {k: torch.empty((dp, *params[k].shape), dtype=params[k].dtype,
                            device=params[k].device) for k in keys}
    losses = []
    for i in range(dp):
        sub = {n: x.reshape(dp, b // dp, *x.shape[1:])[i]
               for n, x in batch.items()}
        leaves = {k: params[k].detach().requires_grad_(True) for k in keys}
        loss = loss_fn(leaves, sub)
        for k, gk in zip(keys, torch.autograd.grad(
                loss, [leaves[k] for k in keys])):
            grads[k][i].copy_(gk)
        losses.append(loss.detach())
    return torch.stack(losses).mean(), grads


def init_ef_state(efc: EFConfig, params: Tree, dp: int,
                  init_grads: Optional[Tree] = None) -> Dict:
    """init_grads: optional per-client grads (dp leading) for Alg 1 line 2
    (v⁰ = g⁰ = first gradients); the clients' state takes that tensor
    over."""
    method = efc.method
    if init_grads is None:
        like = ef_lib.tree_map(
            lambda p: torch.zeros((dp, *p.shape), dtype=p.dtype,
                                  device=p.device), params)
        clients = method.init(like)
        server = ef_lib.server_init(method, params)
    else:
        clients = method.init(init_grads, init_grads)
        server = ef_lib.server_init(
            method, params,
            ef_lib.tree_map(lambda g: g.sum(0) / dp, init_grads))
    state = {"clients": clients, "server": server}
    if efc.has_downlink:
        state["h"] = ef_lib.downlink_init(server)
    return state


def _wire_round(carrier, method, grads: Tree, clients: Dict[str, Tree],
                eta) -> Tree:
    """The 'wire' plan, one leaf at a time: pre_compress, then the carrier's
    encode → local_c → aggregate (carriers.wire_round_batched), then
    post_compress. Every method acts leaf by leaf, so this is the
    reference's whole-tree round; going leaf by leaf keeps one leaf's
    temporaries alive at a time, and each leaf's new client state replaces
    the old IN PLACE in ``clients``. Returns the mean message."""
    msg_mean: Tree = {}
    for key in sorted(grads):
        delta, ctx = method.pre_compress(
            {key: grads[key]},
            {name: {key: tree[key]} for name, tree in clients.items()},
            eta=eta)
        c, agg = carrier_lib.wire_round_batched(
            carrier, method.compressor, delta, grads[key].shape[0])
        del delta
        msg_mean[key] = agg[key]
        _, new = method.post_compress(c, ctx)
        for name in clients:
            clients[name][key] = new[name][key]
    return msg_mean


def ef_round(efc: EFConfig, grads: Tree, ef_state: Dict,
             eta: Optional[float] = None) -> Tuple[Tree, Dict]:
    """One round on per-client grads (dp leading). Returns (the estimate
    gᵗ⁺¹ the model steps with, the new ef_state). Under the fused and wire
    plans the client state is updated in place."""
    method = efc.method
    dp = next(iter(grads.values())).shape[0]
    clients, server = ef_state["clients"], ef_state["server"]
    carrier = carrier_lib.make(efc.carrier)
    plan = carrier.plan(method, eta)

    if plan == "fused":
        c_tree, new_clients = carrier.fused_update(method, grads, clients,
                                                   eta=eta)
        msg_mean = ef_lib.tree_map(lambda c: c.sum(0) / dp, c_tree)
    elif plan == "fused_wire":
        msg_mean, new_clients = carrier.fused_wire_round(method, grads,
                                                         clients, eta=eta)
    elif plan == "wire":
        msg_mean = _wire_round(carrier, method, grads, clients, eta)
        new_clients = clients
    else:
        outs = [method.update(ef_lib.tree_index(grads, i),
                              {name: ef_lib.tree_index(tree, i)
                               for name, tree in clients.items()}, eta=eta)
                for i in range(dp)]
        msg_mean = ef_lib.tree_map(lambda m: m.sum(0) / dp,
                                   ef_lib.tree_stack([m for m, _ in outs]))
        new_clients = {name: ef_lib.tree_stack([s[name] for _, s in outs])
                       for name in clients}

    new_server = ef_lib.server_step(method, server, msg_mean)
    new_state = {"clients": new_clients, "server": new_server}
    if not efc.has_downlink:
        return new_server, new_state
    g_est, h_new = ef_lib.downlink_sync(
        carrier_lib.make(efc.down_carrier), efc.down_comp(), new_server,
        ef_state["h"])
    new_state["h"] = h_new
    return g_est, new_state


def make_train_step(loss_fn: Callable, efc: EFConfig, optimizer, dp: int,
                    eta: Optional[float] = None):
    """Returns train_step(params, opt_state, ef_state, batch, step) →
    (params, opt_state, ef_state, metrics). The reference's rng argument has
    no counterpart: no compressor of this slice draws randomness."""
    from repro_torch.optim.optimizer import apply_updates

    def train_step(params, opt_state, ef_state, batch, step):
        loss, grads = per_client_value_and_grad(loss_fn, params, batch, dp)
        g_est, ef_state = ef_round(efc, grads, ef_state, eta=eta)
        del grads                      # free the per-client stack early
        updates, opt_state = optimizer.update(g_est, opt_state, params, step)
        params = apply_updates(params, updates)
        metrics = {"loss": loss,
                   "g_norm": torch.sqrt(ef_lib.tree_norm_sq(g_est))}
        return params, opt_state, ef_state, metrics

    return train_step
