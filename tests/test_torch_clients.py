"""The clients in one batched pass against the clients one after another,
on the CPU: their gradients (``core/distributed.py::
per_client_value_and_grad``, ``torch.func.vmap`` of ``grad_and_value``, as
the reference's ``jax.vmap`` of ``value_and_grad``) against ``_loop`` below
at smoke size, and the dense plan of ``ef_round`` (the method's steps on the
client-stacked trees, ``Compressor.batched``) against ``_dense_loop``, the
method's update client by client. Both loops are the passes the port ran
before.

Tolerances, per client and leaf, as a fraction of that client's largest
|gradient| in the leaf (measured on these inputs, seeds 0-3):
- f32 activations: 1e-5. The two passes differ by the order of their sums
  alone (at most 7.8e-7 measured);
- bf16 activations (f32 params): 3e-2. Both passes round their products
  and the gradients flowing back to bf16, at places that differ: they are
  0.5-1.5 % apart, while each is 1.5-2.8 % from the f32-activation
  gradient;
- the mean loss: rtol 1e-6 in both (equal on these inputs);
- the dense plan: bit-identical.
"""
import dataclasses

import numpy as np
import pytest
import torch

from repro_torch.configs import base as cb
from repro_torch.core import compressors as comp_lib
from repro_torch.core import distributed as dist
from repro_torch.core import ef as ef_lib
from repro_torch.models import model as model_lib

GRAD_TOL = {"float32": 1e-5, "bfloat16": 3e-2}


def _loop(loss_fn, params, batch, dp):
    """The clients one after another, each gradient copied into a
    preallocated (dp, ...) stack: the yardstick."""
    b = batch["tokens"].shape[0]
    keys = sorted(params)
    grads = {k: torch.empty((dp, *params[k].shape), dtype=params[k].dtype)
             for k in keys}
    losses = []
    for i in range(dp):
        sub = {n: x.reshape(dp, b // dp, *x.shape[1:])[i]
               for n, x in batch.items()}
        leaves = {k: params[k].detach().requires_grad_(True) for k in keys}
        loss, _ = loss_fn(leaves, sub)
        for k, gk in zip(keys, torch.autograd.grad(
                loss, [leaves[k] for k in keys])):
            grads[k][i].copy_(gk)
        losses.append(loss.detach())
    return torch.stack(losses).mean(), grads


def _setup(dtype, seed=0, batch_size=4, seq=32):
    cfg = dataclasses.replace(cb.get_smoke("smollm-360m"), dtype=dtype)
    params = model_lib.init_params(cfg, torch.Generator().manual_seed(seed))
    rs = np.random.RandomState(seed)
    batch = {name: torch.from_numpy(
        rs.randint(0, cfg.vocab_size, (batch_size, seq)).astype(np.int32))
        for name in ("tokens", "labels")}
    return (lambda p, b: model_lib.train_loss(cfg, p, b)), params, batch


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("dp", [1, 2, 4])
def test_batched_pass_matches_the_client_loop(dtype, dp):
    loss_fn, params, batch = _setup(dtype)
    want_loss, want = _loop(loss_fn, params, batch, dp)
    loss, _, grads = dist.per_client_value_and_grad(loss_fn, params, batch,
                                                    dp)
    np.testing.assert_allclose(float(loss), float(want_loss), rtol=1e-6)
    assert sorted(grads) == sorted(params)
    for k, g in grads.items():
        assert g.shape == (dp, *params[k].shape), k
        assert g.dtype == params[k].dtype and g.is_contiguous(), k
        dims = tuple(range(1, g.dim()))
        scale = want[k].abs().amax(dim=dims)
        worst = float(((g - want[k]).abs().amax(dim=dims) / scale).max())
        assert worst <= GRAD_TOL[dtype], (k, worst)


def test_clients_see_their_own_batch_rows():
    """Client i's gradient is the gradient of client i's rows alone."""
    loss_fn, params, batch = _setup("float32", seed=1)
    _, _, grads = dist.per_client_value_and_grad(loss_fn, params, batch, 2)
    sub = {n: x[2:] for n, x in batch.items()}      # client 1's rows
    leaves = {k: p.clone().requires_grad_(True) for k, p in params.items()}
    keys = sorted(leaves)
    want = torch.autograd.grad(loss_fn(leaves, sub)[0],
                               [leaves[k] for k in keys])
    for k, w in zip(keys, want):
        torch.testing.assert_close(grads[k][1], w, rtol=1e-5,
                                   atol=1e-5 * float(w.abs().max()))


def test_batch_not_divisible_by_clients_raises():
    loss_fn, params, batch = _setup("float32", batch_size=6)
    with pytest.raises(ValueError, match="not divisible by dp=4"):
        dist.per_client_value_and_grad(loss_fn, params, batch, 4)


def _dense_loop(method, grads, clients):
    """The dense plan's clients one after another, each through the
    method's own update: the yardstick. Returns (the server's new estimate,
    the new client state)."""
    dp = next(iter(grads.values())).shape[0]
    outs = [method.update({k: g[i] for k, g in grads.items()},
                          {n: {k: t[i] for k, t in tree.items()}
                           for n, tree in clients.items()})
            for i in range(dp)]
    msgs = {k: torch.stack([m[k] for m, _ in outs]) for k in grads}
    new = {n: {k: torch.stack([s[n][k] for _, s in outs]) for k in tree}
           for n, tree in clients.items()}
    return msgs, new


DENSE_COMPRESSORS = {
    "block_quant8": comp_lib.BlockQuant(bits=8, block=16),
    "block_quant4": comp_lib.BlockQuant(bits=4, block=16),
    "block_topk": comp_lib.BlockTopK(block=16, k_per_block=3),
    "topk": comp_lib.TopK(ratio=0.1),
    "rank1": comp_lib.Rank1(rows=4),
    "hard_threshold": comp_lib.HardThreshold(lam=0.5),
    "identity": comp_lib.Identity(),
}


@pytest.mark.parametrize("method_name", ["ef21_sgdm", "ef14_sgd"])
@pytest.mark.parametrize("comp_name", sorted(DENSE_COMPRESSORS))
def test_dense_plan_matches_the_client_loop(comp_name, method_name):
    """Leaves whose sizes are not a multiple of the block (a padded last
    block a client), 4 clients, an all-zero client in one leaf."""
    method = ef_lib.REGISTRY[method_name](
        compressor=DENSE_COMPRESSORS[comp_name])
    rs = np.random.RandomState(7)
    shapes = {"a": (3, 40), "b": (100,), "c": (2, 5, 7)}
    dp = 4

    def tree():
        return {k: torch.from_numpy(rs.randn(dp, *s).astype(np.float32))
                for k, s in shapes.items()}
    params = {k: torch.zeros(s) for k, s in shapes.items()}
    grads = tree()
    grads["b"][2] = 0.0
    efc = dist.EFConfig(method=method, carrier="dense")
    state = dist.init_ef_state(efc, params, dp, init_grads=tree())
    clients = {n: {k: t.clone() for k, t in tr.items()}
               for n, tr in state["clients"].items()}
    want_msgs, want_clients = _dense_loop(method, grads, clients)
    want_g = ef_lib.server_step(
        method, state["server"],
        ef_lib.tree_map(ef_lib.client_mean, want_msgs))
    g_est, new = dist.ef_round(efc, grads, state)

    for n, tr in want_clients.items():
        for k, w in tr.items():
            assert torch.equal(new["clients"][n][k], w), (n, k)
    for k, w in want_g.items():
        assert torch.equal(g_est[k], w), k
