"""The paper's claims of tests/test_paper_claims.py, asserted on the port's
simulator (repro_torch.core.simulate) with its own generator, at the
reference test's sizes, steps and seeds, on the CPU.

Every test here is a convergence run of thousands of steps, so the module
is ``slow``, as the reference's is.
"""
import numpy as np
import pytest
import torch

from repro_torch.core import compressors as C
from repro_torch.core import ef, problems, simulate
from test_torch_schedule import one_torch_thread  # noqa: F401 (autouse)

pytestmark = pytest.mark.slow


@pytest.fixture(scope="module")
def t1():
    return problems.QuadraticT1(device="cpu")


def _run(prob, method, seeds=3, **kw):
    cfg = simulate.SimConfig(**kw)
    return [simulate.run_numpy(prob, method, cfg, seed=s)
            for s in range(seeds)]


def _end(runs, last=500):
    return np.median([r["grad_norm_sq"][-last:].mean() for r in runs])


def test_theorem1_noise_construction(t1):
    """E[ξ] = 0 and E‖ξ‖² = σ², but E[Top1(ξ)] ≠ 0: the compressor bias at
    the heart of Theorem 1."""
    zs = t1._zs(1).numpy()
    assert np.allclose(zs.mean(0), 0, atol=1e-7)
    assert np.isclose((zs ** 2).sum(1).mean(), 1.0, atol=1e-5)
    top1 = np.zeros_like(zs)
    idx = np.abs(zs).argmax(1)
    top1[np.arange(3), idx] = zs[np.arange(3), idx]
    assert np.abs(top1.mean(0)).max() > 0.05


def test_fig1_ef21_sgd_stalls_sgdm_converges(t1):
    """Figure 1: EF21-SGD drifts away from the optimum; EF21-SGDM stays
    stable and ends far lower."""
    kw = dict(n=1, batch_size=1, gamma=1e-3, steps=8000)
    top1 = C.TopK(k=1)
    sgd_runs = _run(t1, ef.EF21SGD(compressor=top1), **kw)
    sgdm_runs = _run(t1, ef.EF21SGDM(compressor=top1, eta=1e-3), **kw)
    start = np.median([r["grad_norm_sq"][0] for r in sgd_runs])
    assert _end(sgd_runs) > 10 * start
    assert _end(sgdm_runs) < _end(sgd_runs) / 3


def test_fig1b_no_improvement_with_n_for_ef21_sgd(t1):
    """Figure 1b: for every n the EF21-SGD error still GROWS."""
    top1 = C.TopK(k=1)
    for n in (1, 8):
        runs = _run(t1, ef.EF21SGD(compressor=top1), seeds=3, n=n,
                    batch_size=1, gamma=1e-3, steps=6000)
        start = np.median([r["grad_norm_sq"][0] for r in runs])
        assert _end(runs) > 2 * start, (n, start, _end(runs))


def test_theorem1_ideal_floor_independent_of_n(t1):
    """Theorem 1: EF21-SGD-ideal stalls at E‖∇f‖² ≥ min(σ², ‖∇f(x⁰)‖²)/60
    for all T and all n."""
    m = ef.EF21SGDMIdeal(compressor=C.TopK(k=1), eta=1.0)
    g0 = t1.full_grad(t1.init_x())[problems.LEAF]
    floor = min(t1.sigma ** 2, float(torch.sum(g0 ** 2))) / 60.0
    for n in (1, 4):
        runs = _run(t1, m, seeds=4, n=n, batch_size=1, gamma=0.5, steps=4000)
        assert _end(runs) >= floor, (n, _end(runs), floor)


def test_sgdm_improves_with_n(t1):
    """Theorem 3's ησ²/n term: EF21-SGDM does improve with n."""
    top1 = C.TopK(k=1)
    ends = [_end(_run(t1, ef.EF21SGDM(compressor=top1, eta=0.01), seeds=3,
                      n=n, batch_size=1, gamma=2e-3, steps=6000))
            for n in (1, 8)]
    assert ends[1] < ends[0]


def test_megabatch_rescues_ef21_sgd(t1):
    """Theorem 1's tightness (Prop. 1): B = Θ(σ²/ε²) makes EF21-SGD
    converge."""
    top1 = C.TopK(k=1)
    small = _run(t1, ef.EF21SGD(compressor=top1), seeds=3, n=1,
                 batch_size=1, gamma=1e-3, steps=5000)
    big = _run(t1, ef.EF21SGD(compressor=top1), seeds=3, n=1,
               batch_size=64, gamma=1e-3, steps=5000)
    assert _end(big) < _end(small) / 5


def test_logreg_sgdm_never_worse_batchfree():
    """Experiment 1 (weakened for synthetic data, as the reference's): at
    B=1 and equal transmitted coordinates EF21-SGDM is never worse than
    EF21-SGD (≤ 1.5×)."""
    prob = problems.LogisticRegression(n=5, m_per_client=128, l=16, c=5,
                                       seed=1, device="cpu")
    topk = C.TopK(k=10)
    kw = dict(n=5, batch_size=1, gamma=0.05, steps=2500, b_init=8)
    sgdm = _run(prob, ef.EF21SGDM(compressor=topk, eta=0.1), seeds=2, **kw)
    esgd = _run(prob, ef.EF21SGD(compressor=topk), seeds=2, **kw)
    assert _end(sgdm, 200) < 1.5 * _end(esgd, 200)


def test_time_varying_schedule_converges(t1):
    """Appendix J: ηₜ = 1/√(t+1), γₜ = γ·ηₜ needs no tuning and
    converges."""
    runs = _run(t1, ef.EF21SGDM(compressor=C.TopK(k=1)), seeds=2, n=1,
                batch_size=1, gamma=0.3, steps=6000, time_varying=True)
    start = np.median([r["grad_norm_sq"][:10].mean() for r in runs])
    assert _end(runs) < max(start, 1e-3)


def test_ef_recovers_quantization_error():
    """EF21-SGDM over a 4-bit block-quantized wire converges to the dense
    wire's tolerance; naive no-EF 4-bit quantized compression (ship Q(∇fᵢ))
    stalls far above it."""
    prob = problems.RandomQuadratics(n=8, d=40, lam=0.05, sigma=1e-3,
                                     seed=0, device="cpu")
    btk = C.BlockTopK(block=8, k_per_block=2)
    kw = dict(n=8, batch_size=1, gamma=5e-2, steps=2500)

    def end(method, carrier="dense"):
        cfg = simulate.SimConfig(carrier=carrier, **kw)
        out = simulate.run_numpy(prob, method, cfg, seed=0)
        return out["grad_norm_sq"][-300:].mean()

    sgdm = ef.EF21SGDM(compressor=btk, eta=0.1)
    end_dense = end(sgdm, "dense")
    end_q4 = end(sgdm, "quant4")
    end_naive = end(ef.SGD(compressor=C.BlockQuant(bits=4, block=8)))
    assert end_q4 < 3 * end_dense, (end_q4, end_dense)
    assert end_naive > 30 * end_q4, (end_naive, end_q4)


def test_quadratic_generator_spectrum():
    """Algorithm 2: the mean matrix's least eigenvalue is λ."""
    prob = problems.RandomQuadratics(n=8, d=40, lam=0.05, seed=0,
                                     device="cpu")
    Q = prob._Q.double().mean(0).numpy()
    assert np.isclose(np.linalg.eigvalsh(Q).min(), 0.05, atol=1e-5)
