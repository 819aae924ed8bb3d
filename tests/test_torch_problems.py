"""The paper's problems in the port (repro_torch.core.problems) against the
reference's (repro.core.problems), on the CPU at small sizes.

Exact: the data and the initial points (the same ``np.random.RandomState``
calls, bit for bit). Within rtol 1e-6 (and an absolute floor of a few f32
ulps of the largest value, for entries near zero: the port writes the
gradients out as batched products, the reference differentiates): the full
gradient, the loss, the exact per-client gradient and a stochastic gradient
on the SAME draw, the reference's indices or noise taken from its own key
and handed to the port's ``grad_on``; one client at a time and all clients
in one call.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import problems as jax_prob
from repro_torch.core import problems as pt_prob
from test_torch_schedule import one_torch_thread  # noqa: F401 (autouse)

LEAF = pt_prob.LEAF
CASES = {
    "quadratic_t1": (dict(), jax_prob.QuadraticT1, pt_prob.QuadraticT1),
    "random_quadratics": (dict(n=4, d=12, lam=0.05, sigma=0.1, seed=3),
                          jax_prob.RandomQuadratics, pt_prob.RandomQuadratics),
    "logistic": (dict(n=3, m_per_client=20, l=7, c=4, seed=2),
                 jax_prob.LogisticRegression, pt_prob.LogisticRegression),
    "logistic_iid": (dict(n=2, m_per_client=16, l=5, c=2, seed=1,
                          heterogeneous=False),
                     jax_prob.LogisticRegression, pt_prob.LogisticRegression),
    "mlp": (dict(n=3, m_per_client=24, in_dim=6, hidden=8, c=4, seed=5),
            jax_prob.MLPClassification, pt_prob.MLPClassification),
}
N_CLIENTS = {"quadratic_t1": 3}
B = 5


def make(name):
    kw, jcls, pcls = CASES[name]
    return jcls(**kw), pcls(device="cpu", **kw)


def as_tree(x):
    """The reference's iterate as the port's flat tree."""
    if isinstance(x, dict):
        return {k: np.asarray(v) for k, v in x.items()}
    return {LEAF: np.asarray(x)}


def to_pt(tree):
    return {k: torch.tensor(np.asarray(v)) for k, v in tree.items()}


def close(got, want, what, rtol=1e-6):
    got, want = as_tree(got), as_tree(want)
    assert sorted(got) == sorted(want), what
    for k in want:
        g = got[k].numpy() if isinstance(got[k], torch.Tensor) else got[k]
        w = np.asarray(want[k])
        atol = 8 * np.spacing(np.float32(np.abs(w).max()))
        np.testing.assert_allclose(g, w, rtol=rtol, atol=atol,
                                   err_msg=f"{what}/{k!r}")


def point(jp):
    """A random iterate of the problem's shape (seeded)."""
    rs = np.random.RandomState(11)
    return {k: (0.3 * rs.randn(*v.shape)).astype(np.float32)
            for k, v in as_tree(jp.init_x()).items()}


def jax_x(jp, x):
    return jnp.asarray(x[LEAF]) if not isinstance(jp.init_x(), dict) \
        else {k: jnp.asarray(v) for k, v in x.items()}


@pytest.mark.parametrize("name", list(CASES))
def test_data_and_initial_points_are_bit_equal(name):
    jp, pp = make(name)
    for attr in ("_Q", "_b", "_A", "_Y"):
        if hasattr(jp, attr):
            want = np.asarray(getattr(jp, attr))
            got = getattr(pp, attr).numpy()
            assert got.shape == want.shape, attr
            np.testing.assert_array_equal(got.astype(want.dtype), want,
                                          err_msg=attr)
    want, got = as_tree(jp.init_x()), pp.init_x()
    assert sorted(got) == sorted(want)
    for k in want:
        assert got[k].dtype == torch.float32
        np.testing.assert_array_equal(got[k].numpy(), want[k])


@pytest.mark.parametrize("name", list(CASES))
def test_full_grad_and_loss_match_reference(name):
    jp, pp = make(name)
    x = point(jp)
    xj, xp = jax_x(jp, x), to_pt(x)
    close(pp.full_grad(xp), jp.full_grad(xj), f"{name} full_grad")
    np.testing.assert_allclose(float(pp.loss(xp)), float(jp.loss(xj)),
                               rtol=1e-6)
    g, fl = pp.full_grad_and_loss(xp)
    close(g, jp.full_grad(xj), f"{name} full_grad_and_loss")
    np.testing.assert_allclose(float(fl), float(jp.loss(xj)), rtol=1e-6)


def _jax_draw(name, jp, key):
    """The draw the reference's ``stoch_grad(x, c, key, B)`` makes, as the
    port's (1, B, ...) draw."""
    if name == "quadratic_t1":
        ks = jax.random.split(key, B)
        idx = jax.vmap(lambda k: jax.random.randint(k, (), 0, 3))(ks)
        return torch.tensor(np.asarray(idx))[None]
    if name == "random_quadratics":
        return torch.tensor(np.asarray(
            jax.random.normal(key, (B, jp.d))))[None]
    return torch.tensor(np.asarray(jax.random.randint(
        key, (B,), 0, jp.m_per_client)))[None]


@pytest.mark.parametrize("name", list(CASES))
def test_stoch_grad_on_the_same_draw_matches_reference(name):
    jp, pp = make(name)
    x = point(jp)
    xj, xp = jax_x(jp, x), to_pt(x)
    n = N_CLIENTS.get(name, getattr(jp, "n", 1))
    draws, wants = [], []
    for c in range(n):
        key = jax.random.PRNGKey(100 + c)
        draw = _jax_draw(name, jp, key)
        want = jp.stoch_grad(xj, c, key, B)
        got = pp.grad_on(xp, draw, range(c, c + 1))
        close({k: v[0] for k, v in got.items()}, want, f"{name} client {c}")
        draws.append(draw)
        wants.append(as_tree(want))
    # every client in one call: the same draws stacked
    got = pp.grad_on(xp, torch.cat(draws), n)
    for c in range(n):
        close({k: v[c] for k, v in got.items()}, wants[c],
              f"{name} batched client {c}")


@pytest.mark.parametrize("name", ["quadratic_t1", "random_quadratics"])
def test_client_grad_matches_reference(name):
    jp, pp = make(name)
    x = point(jp)
    xj, xp = jax_x(jp, x), to_pt(x)
    n = N_CLIENTS.get(name, getattr(jp, "n", 1))
    got = pp.client_grad(xp, n)
    for c in range(n):
        close({k: v[c] for k, v in got.items()}, jp.client_grad(xj, c),
              f"{name} client_grad {c}")


def test_draws_are_on_the_problem_device_and_seeded():
    _, pp = make("logistic")
    g1 = torch.Generator().manual_seed(4)
    g2 = torch.Generator().manual_seed(4)
    a, b = pp.draw(g1, 7, pp.n), pp.draw(g2, 7, pp.n)
    assert a.shape == (pp.n, 7) and torch.equal(a, b)
    assert int(a.min()) >= 0 and int(a.max()) < pp.m_per_client


def test_mlp_accuracy_and_leaf_order_match_reference():
    jp, pp = make("mlp")
    x = point(jp)
    assert list(pp.init_x()) == sorted(jp.init_x())
    np.testing.assert_allclose(
        float(pp.accuracy(to_pt(x))),
        float(jp.accuracy({k: jnp.asarray(v) for k, v in x.items()})),
        rtol=0, atol=1e-7)


def test_problems_default_to_cuda():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default placement succeeds")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        pt_prob.QuadraticT1()
