"""Block recompute (the reference's ``jax.checkpoint`` of each scanned block,
src/repro/models/model.py ``_run_stack``): the forward keeps a block's
inputs only, and the backward runs the block again to take its vector-
Jacobian product.

The clients' gradients are one ``torch.func.vmap`` of ``grad_and_value``
(core/distributed.py), where ``torch.utils.checkpoint`` runs in neither
mode: ``use_reentrant=False`` needs saved-tensor hooks, which
``torch.func`` does not support, and ``use_reentrant=True`` is an
``autograd.Function`` without ``setup_context``, which ``torch.func``
refuses. :class:`_Recompute` is an ``autograd.Function`` written for
``torch.func``: ``setup_context`` saves the inputs, ``generate_vmap_rule``
lets ``vmap`` batch it, and its backward recomputes the block under
``torch.func.vjp``.

``torch.func.grad`` differentiates with ``create_graph=True``, so every
tensor the forward saved, and every intermediate of the backward, lives
until the whole pass returns: recompute would change nothing if the
recomputed block were recorded there too. The backward therefore
recomputes from DETACHED inputs: nothing of the block is recorded at the
outer level, and its activations die with the block's vjp. Grad mode
stays on, so each operation takes the backward formula the pass without
recompute takes (``silu``'s, for one, depends on grad mode), and gradients
and values equal that pass's bit for bit.
"""
from __future__ import annotations

from typing import Callable, Sequence, Tuple, Union

import torch

Outputs = Union[torch.Tensor, Tuple[torch.Tensor, ...]]


class _Recompute(torch.autograd.Function):
    generate_vmap_rule = True

    @staticmethod
    def forward(fn, n_diff, *args):
        return fn(*args)

    @staticmethod
    def setup_context(ctx, inputs, output):
        fn, n_diff, *args = inputs
        ctx.fn, ctx.n_diff = fn, n_diff
        ctx.save_for_backward(*args)

    @staticmethod
    def backward(ctx, *grad_outs):
        args = ctx.saved_tensors
        diff = [t.detach() for t in args[:ctx.n_diff]]
        const = args[ctx.n_diff:]
        out, vjp = torch.func.vjp(lambda *d: ctx.fn(*d, *const), *diff)
        cot = tuple(g.detach() for g in grad_outs)
        return (None, None,
                *vjp(cot if isinstance(out, tuple) else cot[0]),
                *([None] * len(const)))


def checkpoint(fn: Callable[..., Outputs], diff: Sequence[torch.Tensor],
               const: Sequence[torch.Tensor] = ()) -> Outputs:
    """``fn(*diff, *const)``, keeping only the inputs for the backward,
    which recomputes ``fn``. ``fn`` returns one tensor or a tuple of them
    (a block: the hidden state and its MoE aux scalars); the backward
    takes a gradient for each output, zero for one the loss does not use
    or one that carries none (``dropped_frac``, made of integers).
    Gradients flow to ``diff``; ``const`` takes none. ``fn`` must be pure
    (no in-place writes to its inputs, no state) and deterministic, since
    the backward calls it again: an MoE block recomputes exactly the
    forward's routing (same inputs, a stable sort, the same top-k)."""
    return _Recompute.apply(fn, len(diff), *diff, *const)
