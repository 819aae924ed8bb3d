"""Error-feedback methods (counterpart of src/repro/core/ef.py).

A tree is a plain dict of tensors keyed by ``/``-joined leaf paths, always
walked in sorted key order — the order ``jax.tree_util`` flattens the
reference's nested dicts in — so per-leaf work, checkpoints and the
reference's npz keys line up one for one.

This slice ports EF21-SGD and EF21-SGDM (Algorithm 1) with their two-phase
API, the server rule and the downlink (server → client broadcast) sync. The
other eight methods arrive with a later slice (ROADMAP Queue 1).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, Optional, Tuple

import torch

from repro_torch.core import compressors as comp_lib
from repro_torch.kernels import ref as kref

Tree = Dict[str, torch.Tensor]


# ---------------------------------------------------------------------------
# tree helpers
# ---------------------------------------------------------------------------

def flatten(tree: Dict[str, Any], prefix: str = "") -> Tree:
    """Nested dict → flat dict of ``/``-joined paths, in sorted order."""
    out: Tree = {}
    for key in sorted(tree):
        path = f"{prefix}/{key}" if prefix else str(key)
        if isinstance(tree[key], dict):
            out.update(flatten(tree[key], path))
        else:
            out[path] = tree[key]
    return out


def tree_map(fn: Callable, tree: Tree, *rest: Tree) -> Tree:
    return {k: fn(tree[k], *(r[k] for r in rest)) for k in sorted(tree)}


def tree_zeros_like(tree: Tree) -> Tree:
    return tree_map(torch.zeros_like, tree)


def tree_add(a: Tree, b: Tree) -> Tree:
    return tree_map(torch.add, a, b)


def tree_sub(a: Tree, b: Tree) -> Tree:
    return tree_map(torch.sub, a, b)


def tree_lerp(a: Tree, b: Tree, eta: float) -> Tree:
    """(1-eta)*a + eta*b — the Polyak momentum update, leaf-wise, in f32."""
    c1, c2 = kref._coeffs(eta)
    return tree_map(lambda x, y: (c1 * x.float() + c2 * y.float()).to(x.dtype),
                    a, b)


def tree_norm_sq(tree: Tree) -> torch.Tensor:
    return sum(torch.sum(torch.square(tree[k].float())) for k in sorted(tree))


def tree_index(tree: Tree, i: int) -> Tree:
    return tree_map(lambda x: x[i], tree)


def tree_stack(trees) -> Tree:
    return {k: torch.stack([t[k] for t in trees]) for k in sorted(trees[0])}


def tree_compress(comp: comp_lib.Compressor, tree: Tree) -> Tree:
    """Apply a flat-vector compressor leaf-wise (budget ∝ leaf size)."""
    return tree_map(lambda x: comp(x.reshape(-1)).reshape(x.shape), tree)


# ---------------------------------------------------------------------------
# methods
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class Method:
    """Base EF method: ``pre_compress → C(·) → post_compress``. Both ported
    methods are EF21 methods: the server integrates the mean message,
    gᵗ⁺¹ = gᵗ + meanᵢ cᵢ, and the EF state follows the grads' dtype (the
    bfloat16 state of the reference arrives with a later slice)."""

    compressor: comp_lib.Compressor = comp_lib.BlockTopK()
    name: str = "base"

    def init(self, params_like: Tree, init_grads: Optional[Tree] = None
             ) -> Dict[str, Tree]:
        raise NotImplementedError

    def pre_compress(self, grads: Tree, state: Dict[str, Tree], *, eta=None
                     ) -> Tuple[Tree, Dict[str, Tree]]:
        raise NotImplementedError

    def post_compress(self, c: Tree, ctx: Dict[str, Tree]
                      ) -> Tuple[Tree, Dict[str, Tree]]:
        raise NotImplementedError

    def update(self, grads: Tree, state: Dict[str, Tree], *, eta=None
               ) -> Tuple[Tree, Dict[str, Tree]]:
        delta, ctx = self.pre_compress(grads, state, eta=eta)
        return self.post_compress(tree_compress(self.compressor, delta), ctx)

    def _eta(self, eta):
        return eta if eta is not None else getattr(self, "eta", 1.0)


@dataclasses.dataclass(frozen=True)
class EF21SGD(Method):
    """EF21 with stochastic gradients — eq (5a)+(5ab)."""
    name: str = "ef21_sgd"

    def init(self, params_like, init_grads=None):
        g = init_grads if init_grads is not None else tree_zeros_like(params_like)
        return {"g": g}

    def pre_compress(self, grads, state, *, eta=None):
        return tree_sub(grads, state["g"]), {"g": state["g"]}

    def post_compress(self, c, ctx):
        return c, {"g": tree_add(ctx["g"], c)}


@dataclasses.dataclass(frozen=True)
class EF21SGDM(Method):
    """EF21-SGDM — Algorithm 1: v' = (1-η)v + η∇f; c = C(v' - g); g' = g + c.
    ``init`` gives v and g their own tensors (the reference shares one
    immutable array): the fused carriers update both in place."""
    eta: float = 0.1
    name: str = "ef21_sgdm"

    def init(self, params_like, init_grads=None):
        v = init_grads if init_grads is not None else tree_zeros_like(params_like)
        return {"v": v, "g": tree_map(torch.clone, v)}

    def pre_compress(self, grads, state, *, eta=None):
        v_new = tree_lerp(state["v"], grads, self._eta(eta))
        return tree_sub(v_new, state["g"]), {"v": v_new, "g": state["g"]}

    def post_compress(self, c, ctx):
        return c, {"v": ctx["v"], "g": tree_add(ctx["g"], c)}


REGISTRY = {"ef21_sgd": EF21SGD, "ef21_sgdm": EF21SGDM}


def make(name: str, **kwargs) -> Method:
    if name not in REGISTRY:
        raise NotImplementedError(
            f"EF method {name!r} is not ported yet (this port runs "
            f"{sorted(REGISTRY)}); it arrives with a later slice "
            "(ROADMAP Queue 1)")
    return REGISTRY[name](**kwargs)


# ---------------------------------------------------------------------------
# server side
# ---------------------------------------------------------------------------

def server_init(params_like: Tree, init_grads_mean: Optional[Tree] = None
                ) -> Tree:
    """The aggregated estimate gᵗ the server keeps (g⁰ = mean of gᵢ⁰)."""
    if init_grads_mean is not None:
        return init_grads_mean
    return tree_zeros_like(params_like)


def server_step(g_server: Tree, msg_mean: Tree) -> Tree:
    """gᵗ⁺¹ = gᵗ + meanᵢ cᵢ (Algorithm 1 line 10)."""
    return tree_add(g_server, msg_mean)


def downlink_init(g_server: Tree) -> Tree:
    """h⁰ = g⁰, the server's EF21 broadcast memory."""
    return tree_map(torch.clone, g_server)


def downlink_sync(carrier, comp: comp_lib.Compressor, g_server: Tree,
                  h: Tree) -> Tuple[Tree, Tree]:
    """One downlink broadcast with memory (EF21-BC): the server ships the wire
    of C(g - h) and everyone integrates h' = h + decode(wire). Returns
    ``(g_est, h_new)``; both are h'."""
    from repro_torch.core import carriers as carrier_lib
    h_new = carrier_lib.downlink_round_integrate(
        carrier, comp, tree_sub(g_server, h), h)
    return h_new, h_new
