"""Server optimizer (counterpart of src/repro/optim/optimizer.py): plain SGD
at a constant learning rate, the paper's x ← x − γ·gᵗ. Momentum SGD, AdamW
and the schedules arrive with a later slice.

An optimizer is (init, update):
    state = opt.init(params)
    updates, state = opt.update(grads, state, params, step)
    params = apply_updates(params, updates)        # params + updates
"""
from __future__ import annotations

from typing import Callable, Dict, NamedTuple

import numpy as np
import torch

Tree = Dict[str, torch.Tensor]


class Optimizer(NamedTuple):
    init: Callable[[Tree], dict]
    update: Callable[..., tuple]        # (grads, state, params, step) -> (upd, st)


def apply_updates(params: Tree, updates: Tree) -> Tree:
    return {k: (params[k].float() + updates[k].float()).to(params[k].dtype)
            for k in sorted(params)}


def sgd(lr: float) -> Optimizer:
    neg_lr = -float(np.float32(lr))     # the reference's f32 constant lr

    def init(params):
        return {}

    def update(grads, state, params=None, step=0):
        return {k: neg_lr * grads[k].float() for k in sorted(grads)}, state

    return Optimizer(init, update)


REGISTRY = {"sgd": sgd}


def make(name: str, **kw) -> Optimizer:
    if name not in REGISTRY:
        raise NotImplementedError(
            f"optimizer {name!r} is not ported yet (this port runs "
            f"{sorted(REGISTRY)}); it arrives with a later slice")
    return REGISTRY[name](**kw)
