"""The port's server optimizers (repro_torch.optim.optimizer) against the
reference's (repro.optim.optimizer), on the same numpy trees over several
steps: SGD plain, with momentum and with Nesterov, AdamW (with and without
weight decay), global-norm clipping and the three schedules.

Tolerance: rtol 1e-6 per step, with an atol of 1e-6 of each leaf's largest
value. XLA on the CPU contracts ``b·m + (1-b)·g`` and the like into fused
multiply-adds where PyTorch rounds twice, the two frameworks' f32
``pow``/``cos`` may differ in the last ulp, and the clipping norm sums in
another order; where a moment cancels (gradients of changing sign) those
ulps of the leaf's scale become larger relative errors of the small
values, hence the atol. Plain SGD at a constant rate is exact.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.optim import optimizer as jax_opt
from repro_torch.optim import optimizer as pt_opt

SHAPES = {"embed": (16, 8), "layers/mlp/w_up": (2, 8, 12), "norm": (8,)}


def _tree(rng, scale=1.0):
    return {k: (scale * rng.randn(*s)).astype(np.float32)
            for k, s in SHAPES.items()}


def _nest(flat):
    out = {}
    for path, x in flat.items():
        node = out
        *heads, leaf = path.split("/")
        for h in heads:
            node = node.setdefault(h, {})
        node[leaf] = jnp.asarray(x)
    return out


def _flat(tree, prefix=""):
    out = {}
    for k in sorted(tree):
        path = f"{prefix}/{k}" if prefix else k
        if isinstance(tree[k], dict):
            out.update(_flat(tree[k], path))
        else:
            out[path] = np.asarray(tree[k])
    return out


def _run(name, j_opt, p_opt, steps=4, seed=0):
    """Both optimizers over ``steps`` steps on the same grads and params;
    each step's updates, state and params must agree."""
    rng = np.random.RandomState(seed)
    params = _tree(rng)
    jp, pp = _nest(params), {k: torch.tensor(v) for k, v in params.items()}
    js, ps = j_opt.init(jp), p_opt.init(pp)
    for step in range(steps):
        grads = _tree(rng, scale=10.0 ** (step - 2))
        ju, js = j_opt.update(_nest(grads), js, jp, step)
        pu, ps = p_opt.update({k: torch.tensor(v) for k, v in grads.items()},
                              ps, pp, step)
        jp = jax_opt.apply_updates(jp, ju)
        pp = pt_opt.apply_updates(pp, pu)
        for what, got, want in (("updates", pu, _flat(ju)),
                                ("params", pp, _flat(jp))):
            assert sorted(got) == sorted(want)
            for k in want:
                np.testing.assert_allclose(
                    got[k].numpy(), want[k], rtol=1e-6,
                    atol=1e-6 * np.abs(want[k]).max(),
                    err_msg=f"{name} {what}/{k} @ {step}")
        want_state = _flat(js)
        got_state = {f"{n}/{k}": v.numpy() for n, t in ps.items()
                     for k, v in t.items()}
        assert sorted(got_state) == sorted(want_state)
        for k in want_state:
            np.testing.assert_allclose(
                got_state[k], want_state[k], rtol=1e-6,
                atol=1e-6 * np.abs(want_state[k]).max(),
                err_msg=f"{name} state/{k} @ {step}")


OPTIMIZERS = [
    pytest.param(lambda m: m.sgd(0.5), id="sgd"),
    pytest.param(lambda m: m.sgd(0.1, momentum=0.9), id="sgd_momentum"),
    pytest.param(lambda m: m.sgd(0.1, momentum=0.9, nesterov=True),
                 id="sgd_nesterov"),
    pytest.param(lambda m: m.adamw(1e-3), id="adamw"),
    pytest.param(lambda m: m.adamw(3e-4, b1=0.8, b2=0.95, eps=1e-6,
                                   weight_decay=0.1), id="adamw_decay"),
    pytest.param(lambda m: m.clip_by_global_norm(m.adamw(1e-3), 1.0),
                 id="adamw_clipped"),
    pytest.param(lambda m: m.clip_by_global_norm(m.sgd(0.5), 2.0),
                 id="sgd_clipped"),
    pytest.param(lambda m: m.adamw(m.cosine_schedule(1e-3, 2, 4)),
                 id="adamw_cosine"),
    pytest.param(lambda m: m.sgd(m.rsqrt_schedule(0.5), momentum=0.5),
                 id="sgd_rsqrt"),
]


@pytest.mark.parametrize("make", OPTIMIZERS)
def test_optimizer_matches_reference(make, request):
    _run(request.node.callspec.id, make(jax_opt), make(pt_opt))


def test_plain_sgd_is_exact():
    rng = np.random.RandomState(3)
    grads = _tree(rng)
    ju, _ = jax_opt.sgd(0.5).update(_nest(grads), {})
    pu, _ = pt_opt.sgd(0.5).update({k: torch.tensor(v)
                                    for k, v in grads.items()}, {})
    for k, want in _flat(ju).items():
        np.testing.assert_array_equal(pu[k].numpy(), want)


@pytest.mark.parametrize("name,make", [
    ("constant", lambda m: m.constant_schedule(0.3)),
    ("cosine", lambda m: m.cosine_schedule(1e-3, warmup=10, total=100)),
    ("cosine_min", lambda m: m.cosine_schedule(2.0, warmup=0, total=7,
                                               min_frac=0.0)),
    ("rsqrt", lambda m: m.rsqrt_schedule(0.5)),
])
def test_schedules_match_reference(name, make):
    j, p = make(jax_opt), make(pt_opt)
    for step in (0, 1, 5, 9, 10, 11, 50, 99, 100, 250):
        got, want = float(p(step)), float(jax.device_get(j(step)))
        np.testing.assert_allclose(got, want, rtol=1e-6,
                                   err_msg=f"{name} @ {step}")
        assert p(step).dtype == torch.float32


def test_make_names_the_optimizers():
    assert sorted(pt_opt.REGISTRY) == sorted(jax_opt.REGISTRY)
    with pytest.raises(ValueError, match="unknown optimizer"):
        pt_opt.make("lion", lr=1.0)
    state = pt_opt.make("adamw", lr=1e-3).init(
        {"w": torch.zeros(3, dtype=torch.bfloat16)})
    assert state["m"]["w"].dtype == state["v"]["w"].dtype == torch.float32
