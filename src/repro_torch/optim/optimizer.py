"""Server optimizers (counterpart of src/repro/optim/optimizer.py).

An optimizer is (init, update):
    state = opt.init(params)
    updates, state = opt.update(grads, state, params, step)
    params = apply_updates(params, updates)        # params + updates

Composed with the EF layer's aggregated estimate gᵗ (core/distributed.py):
  * ``sgd(lr)``            — the paper's server step x ← x − γ·gᵗ
  * ``sgd(lr, momentum)``  — server-side heavy ball (Nesterov optional)
  * ``adamw(...)``         — the EF-compressed estimate feeding Adam, with
                             f32 moments and bias correction by 1 − bᵗ at
                             t = step + 1

The state is a dict of flat trees (``{"m": {...}, "v": {...}}``), so a
checkpoint names its leaves ``opt_state/m/<leaf>`` exactly as the
reference's does. A learning rate is a float or a schedule, a function of
the step returning a 0-dim f32 tensor; every scalar is taken in f32, as the
reference's jnp arithmetic takes it.
"""
from __future__ import annotations

import math
from typing import Callable, Dict, NamedTuple, Union

import torch

Tree = Dict[str, torch.Tensor]
Schedule = Callable[[int], torch.Tensor]


class Optimizer(NamedTuple):
    init: Callable[[Tree], dict]
    update: Callable[..., tuple]        # (grads, state, params, step) -> (upd, st)


def apply_updates(params: Tree, updates: Tree) -> Tree:
    return {k: (params[k].float() + updates[k].float()).to(params[k].dtype)
            for k in sorted(params)}


def _f32(x) -> torch.Tensor:
    return torch.as_tensor(x, dtype=torch.float32)


# ---------------------------------------------------------------------------
# schedules
# ---------------------------------------------------------------------------

def constant_schedule(lr: float) -> Schedule:
    return lambda step: _f32(lr)


def cosine_schedule(lr: float, warmup: int, total: int,
                    min_frac: float = 0.1) -> Schedule:
    """Linear warmup to ``lr`` over ``warmup`` steps, then a cosine decay to
    ``min_frac·lr`` at ``total``."""
    def sched(step):
        step = _f32(step)
        warm = lr * step / max(warmup, 1)
        prog = torch.clamp((step - warmup) / max(total - warmup, 1), 0.0, 1.0)
        cos = lr * (min_frac + (1 - min_frac) * 0.5
                    * (1 + torch.cos(_f32(math.pi) * prog)))
        return torch.where(step < warmup, warm, cos)
    return sched


def rsqrt_schedule(lr: float) -> Schedule:
    """γₜ = γ/√(t+1) — the paper's Appendix J time-varying choice."""
    return lambda step: lr / torch.sqrt(_f32(step) + 1.0)


def _as_sched(lr: Union[float, Schedule]) -> Schedule:
    return lr if callable(lr) else constant_schedule(lr)


# ---------------------------------------------------------------------------
# optimizers
# ---------------------------------------------------------------------------

def _zeros_f32(params: Tree) -> Tree:
    return {k: torch.zeros(p.shape, dtype=torch.float32, device=p.device)
            for k, p in sorted(params.items())}


def sgd(lr, momentum: float = 0.0, nesterov: bool = False) -> Optimizer:
    sched = _as_sched(lr)

    def init(params):
        return {} if momentum == 0.0 else {"m": _zeros_f32(params)}

    def update(grads, state, params=None, step=0):
        lr_t = sched(step)
        g32 = {k: grads[k].float() for k in sorted(grads)}
        if momentum == 0.0:
            return {k: -lr_t * g for k, g in g32.items()}, state
        m = {k: momentum * state["m"][k] + g for k, g in g32.items()}
        if nesterov:
            upd = {k: -(lr_t * (momentum * m[k] + g)) for k, g in g32.items()}
        else:
            upd = {k: -lr_t * mo for k, mo in m.items()}
        return upd, {"m": m}

    return Optimizer(init, update)


def adamw(lr, b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8,
          weight_decay: float = 0.0) -> Optimizer:
    sched = _as_sched(lr)

    def init(params):
        return {"m": _zeros_f32(params), "v": _zeros_f32(params)}

    def update(grads, state, params, step=0):
        t = _f32(step) + 1.0
        bc1, bc2 = 1 - _f32(b1) ** t, 1 - _f32(b2) ** t
        lr_t = sched(step)
        m, v, upd = {}, {}, {}
        for k in sorted(grads):      # leaf by leaf: one leaf's temporaries
            g = grads[k].float()
            m[k] = b1 * state["m"][k] + (1 - b1) * g
            v[k] = b2 * state["v"][k] + (1 - b2) * g * g
            step_dir = (m[k] / bc1) / (torch.sqrt(v[k] / bc2) + eps)
            if weight_decay:
                step_dir = step_dir + weight_decay * params[k].float()
            upd[k] = -lr_t * step_dir
        return upd, {"m": m, "v": v}

    return Optimizer(init, update)


def clip_by_global_norm(opt: Optimizer, max_norm: float,
                        norm_sq=None) -> Optimizer:
    """``opt`` on the gradients scaled to a global norm of at most
    ``max_norm``. ``norm_sq(grads)`` gives the squared norm of the whole
    tree; on a 'model' axis, whose ranks hold shards, it is
    ``distributed.tree_norm_sq_sharded`` over the axis (the local sum by
    default)."""
    def update(grads, state, params=None, step=0):
        if norm_sq is not None:
            gn = torch.sqrt(norm_sq(grads))
        else:
            gn = torch.sqrt(sum(torch.sum(torch.square(grads[k].float()))
                                for k in sorted(grads)))
        scale = torch.clamp(max_norm / torch.clamp(gn, min=1e-9), max=1.0)
        return opt.update({k: g * scale for k, g in grads.items()}, state,
                          params, step)
    return Optimizer(opt.init, update)


REGISTRY = {"sgd": sgd, "adamw": adamw}


def make(name: str, **kw) -> Optimizer:
    if name not in REGISTRY:
        raise ValueError(f"unknown optimizer {name!r}; have {sorted(REGISTRY)}")
    return REGISTRY[name](**kw)
