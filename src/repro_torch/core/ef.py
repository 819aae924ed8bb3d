"""Error-feedback methods (counterpart of src/repro/core/ef.py).

A tree is a plain dict of tensors keyed by ``/``-joined leaf paths, always
walked in sorted key order — the order ``jax.tree_util`` flattens the
reference's nested dicts in — so per-leaf work, checkpoints and the
reference's npz keys line up one for one.

A method is ``(init, pre_compress → C(·) → post_compress)`` per client; its
``mode`` names the server rule: 'delta' methods (the EF21 family) integrate
the mean message, gᵗ⁺¹ = gᵗ + meanᵢ cᵢ, 'absolute' ones (EF14, SGD, SGDM)
replace the estimate, gᵗ⁺¹ = meanᵢ msgᵢ. This slice ports seven of the
reference's ten methods with the server rule and the downlink (server →
client broadcast) sync. ``ef21_sgdm_ideal`` and ``ef21_storm`` take paired
gradients and ``neolithic`` runs R compression rounds a step: they arrive
with later slices (ROADMAP Queue 1), and naming one raises
``NotImplementedError``. The client EF state follows the grads' dtype, or
the method's ``state_dtype`` (bfloat16 at LLM scale): every method casts its
state where the reference does, in ``init`` and after each step.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, Optional, Tuple

import torch

from repro_torch.core import compressors as comp_lib
from repro_torch.kernels import ops

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
    c1, c2 = ops.momentum_coeffs(eta)
    return tree_map(lambda x, y: (c1 * x.float() + c2 * y.float()).to(x.dtype),
                    a, b)


def tree_scale(a: Tree, s: float) -> Tree:
    """x * s leaf-wise, with s rounded to x's dtype first: the reference
    multiplies by a weakly typed Python scalar, which JAX converts to the
    array's dtype (a bfloat16 leaf is scaled by bf16(s))."""
    return tree_map(lambda x: x * torch.tensor(s, dtype=x.dtype), a)


def tree_cast(tree: Tree, dtype: Optional[torch.dtype]) -> Tree:
    if dtype is None:
        return tree
    return tree_map(lambda x: x.to(dtype), tree)


def client_mean(x: torch.Tensor) -> torch.Tensor:
    """The mean over the leading client axis, as ``jnp.mean`` takes it: a
    bfloat16 stack is summed in f32 and the mean rounded back once."""
    return (x.float().sum(0) / x.shape[0]).to(x.dtype)


def tree_clone(tree: Tree) -> Tree:
    return tree_map(torch.clone, tree)


def tree_norm_sq(tree: Tree) -> torch.Tensor:
    return sum(torch.sum(torch.square(tree[k].float())) for k in sorted(tree))


def tree_compress(comp: comp_lib.Compressor, tree: Tree) -> Tree:
    """Apply a flat-vector compressor leaf-wise (budget ∝ leaf size)."""
    return tree_map(lambda x: comp(x.reshape(-1)).reshape(x.shape), tree)


# ---------------------------------------------------------------------------
# methods
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class Method:
    """Base EF method: ``pre_compress → C(·) → post_compress``.

    ``mode`` is the server rule ('delta' | 'absolute'); ``wire_is_msg`` says
    the transmitted message IS the compressed tensor c (post_compress returns
    c unchanged), the condition for a non-dense carrier to aggregate the wire
    directly. ``init`` gives every state entry its own tensor (the reference
    shares one immutable array): the fused carriers update v and g in
    place. ``state_dtype`` (None: follow the grads; ``torch.bfloat16`` at
    LLM scale) is the dtype of the client state."""

    compressor: comp_lib.Compressor = comp_lib.Identity()
    state_dtype: Optional[torch.dtype] = None
    name: str = "base"
    mode: str = "delta"
    needs_paired_grads: bool = False
    wire_is_msg: bool = True

    def init(self, params_like: Tree, init_grads: Optional[Tree] = None
             ) -> Dict[str, Tree]:
        raise NotImplementedError

    def pre_compress(self, grads: Tree, state: Dict[str, Tree], *, eta=None
                     ) -> Tuple[Tree, Dict[str, Tree]]:
        """→ (delta to compress, ctx)."""
        raise NotImplementedError

    def post_compress(self, c: Tree, ctx: Dict[str, Tree]
                      ) -> Tuple[Tree, Dict[str, Tree]]:
        """→ (msg, new state)."""
        raise NotImplementedError

    def update(self, grads: Tree, state: Dict[str, Tree], *, eta=None
               ) -> Tuple[Tree, Dict[str, Tree]]:
        delta, ctx = self.pre_compress(grads, state, eta=eta)
        return self.post_compress(tree_compress(self.compressor, delta), ctx)

    def coords_per_message(self, d: int) -> float:
        """Idealized transmitted-coordinate count of one message over a
        (d,) leaf (the paper's x-axis): TopK's k, BlockTopK's nb·kb, else d
        (HardThreshold's is data-dependent: d bounds it). The words that
        actually travel are the carrier's ``wire_words``."""
        c = self.compressor
        if isinstance(c, comp_lib.TopK):
            return c._k(d)
        if isinstance(c, comp_lib.BlockTopK):
            nb, _, kb = c.geom(d)
            return nb * kb
        return d

    def _eta(self, eta):
        return eta if eta is not None else getattr(self, "eta", 1.0)

    def _cast(self, tree: Tree) -> Tree:
        return tree_cast(tree, self.state_dtype)

    def _first(self, params_like, init_grads) -> Tree:
        """The initial estimate in the state's dtype: the clients' first
        gradients (Alg 1 line 2) or zeros."""
        return self._cast(init_grads if init_grads is not None
                          else tree_zeros_like(params_like))


@dataclasses.dataclass(frozen=True)
class EF21SGD(Method):
    """EF21 with stochastic gradients — eq (5a)+(5ab)."""
    name: str = "ef21_sgd"

    def init(self, params_like, init_grads=None):
        return {"g": self._first(params_like, init_grads)}

    def pre_compress(self, grads, state, *, eta=None):
        return tree_sub(grads, state["g"]), {"g": state["g"]}

    def post_compress(self, c, ctx):
        return c, {"g": self._cast(tree_add(ctx["g"], c))}


@dataclasses.dataclass(frozen=True)
class EF21SGDM(Method):
    """EF21-SGDM — Algorithm 1: v' = (1-η)v + η∇f; c = C(v' - g); g' = g + c."""
    eta: float = 0.1
    name: str = "ef21_sgdm"

    def init(self, params_like, init_grads=None):
        v = self._first(params_like, init_grads)
        return {"v": v, "g": tree_clone(v)}

    def pre_compress(self, grads, state, *, eta=None):
        v_new = tree_lerp(state["v"], grads, self._eta(eta))
        return tree_sub(v_new, state["g"]), {"v": v_new, "g": state["g"]}

    def post_compress(self, c, ctx):
        return c, {"v": self._cast(ctx["v"]),
                   "g": self._cast(tree_add(ctx["g"], c))}


@dataclasses.dataclass(frozen=True)
class EF21SGD2M(Method):
    """EF21-SGD2M — Algorithm 3 (double momentum, eq (10)):
    v' = (1-η)v + η∇f; u' = (1-η)u + ηv'; c = C(u' - g); g' = g + c."""
    eta: float = 0.1
    name: str = "ef21_sgd2m"

    def init(self, params_like, init_grads=None):
        v = self._first(params_like, init_grads)
        return {"v": v, "u": tree_clone(v), "g": tree_clone(v)}

    def pre_compress(self, grads, state, *, eta=None):
        e = self._eta(eta)
        v_new = tree_lerp(state["v"], grads, e)
        u_new = tree_lerp(state["u"], v_new, e)
        return tree_sub(u_new, state["g"]), \
            {"v": v_new, "u": u_new, "g": state["g"]}

    def post_compress(self, c, ctx):
        return c, {"v": self._cast(ctx["v"]), "u": self._cast(ctx["u"]),
                   "g": self._cast(tree_add(ctx["g"], c))}


@dataclasses.dataclass(frozen=True)
class EF21SGDMAbs(Method):
    """EF21-SGDM with an absolute compressor — Algorithm 4:
    c = γ·C((v' − g)/γ). Its message is a transform of the wire."""
    eta: float = 0.1
    gamma: float = 1e-2
    name: str = "ef21_sgdm_abs"
    wire_is_msg: bool = False

    def init(self, params_like, init_grads=None):
        v = self._first(params_like, init_grads)
        return {"v": v, "g": tree_clone(v)}

    def pre_compress(self, grads, state, *, eta=None):
        v_new = tree_lerp(state["v"], grads, self._eta(eta))
        innov = tree_scale(tree_sub(v_new, state["g"]), 1.0 / self.gamma)
        return innov, {"v": v_new, "g": state["g"]}

    def post_compress(self, c, ctx):
        c = tree_scale(c, self.gamma)
        return c, {"v": self._cast(ctx["v"]),
                   "g": self._cast(tree_add(ctx["g"], c))}


@dataclasses.dataclass(frozen=True)
class EF14SGD(Method):
    """EF14-SGD — eq (64)–(65) in gradient units: p = e + ∇f; msg = C(p);
    e' = p − msg."""
    name: str = "ef14_sgd"
    mode: str = "absolute"

    def init(self, params_like, init_grads=None):
        return {"e": self._cast(tree_zeros_like(params_like))}

    def pre_compress(self, grads, state, *, eta=None):
        p = tree_add(state["e"], grads)
        return p, {"p": p}

    def post_compress(self, c, ctx):
        return c, {"e": self._cast(tree_sub(ctx["p"], c))}


@dataclasses.dataclass(frozen=True)
class SGDM(Method):
    """Polyak SGDM — eq (3): the message is C(v')."""
    eta: float = 0.1
    name: str = "sgdm"
    mode: str = "absolute"

    def init(self, params_like, init_grads=None):
        return {"v": self._first(params_like, init_grads)}

    def pre_compress(self, grads, state, *, eta=None):
        v_new = tree_lerp(state["v"], grads, self._eta(eta))
        return v_new, {"v": v_new}

    def post_compress(self, c, ctx):
        return c, {"v": self._cast(ctx["v"])}


@dataclasses.dataclass(frozen=True)
class SGD(Method):
    """Distributed SGD: the message is C(∇f); no client state."""
    name: str = "sgd"
    mode: str = "absolute"

    def init(self, params_like, init_grads=None):
        return {}

    def pre_compress(self, grads, state, *, eta=None):
        return grads, {}

    def post_compress(self, c, ctx):
        return c, {}


REGISTRY = {
    "ef21_sgd": EF21SGD,
    "ef21_sgdm": EF21SGDM,
    "ef21_sgd2m": EF21SGD2M,
    "ef21_sgdm_abs": EF21SGDMAbs,
    "ef14_sgd": EF14SGD,
    "sgdm": SGDM,
    "sgd": SGD,
}

_LATER = {
    "ef21_sgdm_ideal": "takes paired (stochastic, exact) gradients",
    "ef21_storm": "takes paired gradients under one noise draw",
    "neolithic": "runs R compression rounds a step outside the two-phase API",
}


def make(name: str, **kwargs) -> Method:
    if name in _LATER:
        raise NotImplementedError(
            f"EF method {name!r} {_LATER[name]} and is not ported yet (this "
            f"port runs {sorted(REGISTRY)}); it arrives with a later slice "
            "(ROADMAP Queue 1)")
    if name not in REGISTRY:
        raise ValueError(f"unknown EF method {name!r}; have {sorted(REGISTRY)}")
    return REGISTRY[name](**kwargs)


# ---------------------------------------------------------------------------
# server side
# ---------------------------------------------------------------------------

def server_init(method: Method, params_like: Tree,
                init_grads_mean: Optional[Tree] = None) -> Tree:
    """The aggregated estimate gᵗ the server keeps: g⁰ = mean of gᵢ⁰ for
    'delta' methods, zeros for 'absolute' ones (they replace it each
    round)."""
    if method.mode == "delta" and init_grads_mean is not None:
        return init_grads_mean
    return tree_zeros_like(params_like)


def server_step(method: Method, g_server: Tree, msg_mean: Tree) -> Tree:
    """'delta': gᵗ⁺¹ = gᵗ + meanᵢ cᵢ (Algorithm 1 line 10); 'absolute':
    gᵗ⁺¹ = meanᵢ msgᵢ."""
    if method.mode == "delta":
        return tree_add(g_server, msg_mean)
    return msg_mean


def downlink_init(g_server: Tree) -> Tree:
    """h⁰ = g⁰, the server's EF21 broadcast memory."""
    return tree_clone(g_server)


def downlink_sync(carrier, comp: comp_lib.Compressor, g_server: Tree,
                  h: Tree) -> Tuple[Tree, Tree]:
    """One downlink broadcast with memory (EF21-BC): the server ships the wire
    of C(g - h) and everyone integrates h' = h + decode(wire). Returns
    ``(g_est, h_new)``; both are h'."""
    from repro_torch.core import carriers as carrier_lib
    h_new = carrier_lib.downlink_round_integrate(
        carrier, comp, tree_sub(g_server, h), h)
    return h_new, h_new
