"""One EF round of the port against the reference's vmap runtime over the
(method × carrier × downlink) grid of the reference's own anchor tests
(tests/test_participation.py::_grid_cells) — EF21-SGDM, EF21-SGD and
EF14-SGD × dense / sparse / quant8 / quant4 / fused (EF21 only) × downlink
dense / quant4 — and the other ported methods (EF21-SGD2M, SGDM, SGD,
EF21-SGDM-abs with HardThreshold) on the dense and quant8 carriers.

A small problem keeps the grid fast: four clients, three leaves (a
sub-block leaf, a ragged multi-block leaf, an exact multiple of the
block), Block-TopK with block 64. Inputs are numpy draws; the reference
runs jitted, as its train step runs it. Three rounds run, each from the
reference's state after the one before. Tolerances as in test_torch_ef_round.py: rtol 1e-6
with an atol of four ulps at the scale of the values, at η = 0.5, where
the momentum products are exact in both packages and so is every
selection, mantissa and scale.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import compressors as jax_comp
from repro.core import distributed as jax_dist
from repro.core import ef as jax_ef
from repro_torch.core import compressors as pt_comp
from repro_torch.core import distributed as pt_dist
from repro_torch.core import ef as pt_ef

DP, ETA, ROUNDS = 4, 0.5, 3
SHAPES = {"b": (17,), "w": (3, 100), "z": (256,)}
UP = ("block_topk", {"block": 64, "k_per_block": 5})
DOWN = ("block_topk", {"block": 64, "ratio": 0.1})


def _grid():
    for method in ("ef21_sgdm", "ef21_sgd", "ef14_sgd"):
        for carrier in ("dense", "sparse", "quant8", "quant4", "fused"):
            if carrier == "fused" and method == "ef14_sgd":
                continue                   # fused covers EF21-SGD(M) only
            for down in ("dense", "quant4"):
                yield pytest.param(method, UP, carrier, down,
                                   id=f"{method}-{carrier}-{down}")
    for method, comp in (("ef21_sgd2m", UP), ("sgdm", UP), ("sgd", UP),
                         ("ef21_sgdm_abs", ("hard_threshold", {"lam": 0.5}))):
        for carrier in ("dense", "quant8"):
            yield pytest.param(method, comp, carrier, "quant4",
                               id=f"{method}-{carrier}-quant4")


def _close(got, want, what):
    assert sorted(got) == sorted(want), what
    for k in want:
        g, w = np.asarray(got[k]), np.asarray(want[k])
        atol = 4 * np.spacing(np.float32(np.abs(w).max()))
        np.testing.assert_allclose(g, w, rtol=1e-6, atol=atol,
                                   err_msg=f"{what}/{k}")


def _np(tree):
    return {k: np.asarray(v) for k, v in pt_ef.flatten(tree).items()} \
        if isinstance(tree, dict) else np.asarray(tree)


def _configs(method, comp, carrier, down):
    kw = {"eta": ETA} if method in ("ef21_sgdm", "ef21_sgd2m", "sgdm",
                                    "ef21_sgdm_abs") else {}
    efcs = []
    for comp_lib, ef_lib, dist in ((jax_comp, jax_ef, jax_dist),
                                   (pt_comp, pt_ef, pt_dist)):
        m = ef_lib.make(method, compressor=comp_lib.make(comp[0], **comp[1]),
                        **kw)
        efcs.append(dist.EFConfig(
            method=m, carrier=carrier, down_carrier=down,
            down_compressor=None if down == "dense"
            else comp_lib.make(DOWN[0], **DOWN[1])))
    return efcs


@pytest.mark.parametrize("method,comp,carrier,down", _grid())
def test_rounds_match_reference(method, comp, carrier, down):
    j_efc, p_efc = _configs(method, comp, carrier, down)
    rng = np.random.RandomState(len(method) * 7 + len(carrier))
    params = {k: np.zeros(s, np.float32) for k, s in SHAPES.items()}
    g0 = {k: rng.randn(DP, *s).astype(np.float32) for k, s in SHAPES.items()}
    j_state = jax_dist.init_ef_state(
        j_efc, jax.tree_util.tree_map(jnp.asarray, params), DP,
        init_grads=jax.tree_util.tree_map(jnp.asarray, g0))
    p_state = pt_dist.init_ef_state(
        p_efc, {k: torch.tensor(v) for k, v in params.items()}, DP,
        init_grads={k: torch.tensor(v) for k, v in g0.items()})
    step = jax.jit(lambda g, s: jax_dist.ef_round(j_efc, g, s, None))
    for r in range(ROUNDS):
        grads = {k: rng.randint(-6, 7, size=(DP, *s)).astype(np.float32)
                 * 0.25 + rng.randn(DP, *s).astype(np.float32)
                 for k, s in SHAPES.items()}
        j_est, j_state = step(jax.tree_util.tree_map(jnp.asarray, grads),
                              j_state)
        p_est, p_state = pt_dist.ef_round(
            p_efc, {k: torch.tensor(v) for k, v in grads.items()}, p_state)
        _close(_np(p_est), _np(j_est), f"round {r} g_est")
        assert sorted(p_state) == sorted(j_state)
        for part in p_state:
            _close(_np(p_state[part]), _np(j_state[part]),
                   f"round {r} {part}")
        # carry the reference's state on, so one round's ulp cannot move
        # the next round's selection
        p_state = _to_torch(j_state)


def _to_torch(state):
    """The reference's EF state as the port's (the leaves here are flat)."""
    def conv(tree):
        return {k: torch.tensor(np.asarray(v)) for k, v in tree.items()}
    out = {part: conv(tree) for part, tree in state.items()
           if part != "clients"}
    out["clients"] = {n: conv(t) for n, t in state["clients"].items()}
    return out


def test_absolute_methods_replace_the_server_estimate():
    m = pt_ef.make("ef14_sgd", compressor=pt_comp.Identity())
    assert m.mode == "absolute" and m.wire_is_msg
    g, msg = {"a": torch.ones(3)}, {"a": torch.full((3,), 2.0)}
    assert torch.equal(pt_ef.server_step(m, g, msg)["a"], msg["a"])
    d = pt_ef.make("ef21_sgd")
    assert torch.equal(pt_ef.server_step(d, g, msg)["a"], torch.full((3,), 3.0))
    assert not pt_ef.make("ef21_sgdm_abs").wire_is_msg
    assert set(pt_ef.REGISTRY) == set(jax_ef.REGISTRY)
