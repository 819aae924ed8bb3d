"""The port's experiment drivers (repro_torch.experiments) keep the
reference scripts' constants (benchmarks/fig1_divergence.py, exp1–4), and
each runs end to end on the CPU at a few steps, writing its claims to
results/torch/<name>.json (here into a temporary directory)."""
import importlib
import json

import pytest

from test_torch_schedule import one_torch_thread  # noqa: F401 (autouse)

DRIVERS = {  # name: (constants to compare, the CPU run's cuts)
    "fig1_divergence": (("SEEDS", "STEPS"), dict(SEEDS=1, STEPS=30)),
    "exp1_batchsize": (("SEEDS", "STEPS", "N", "K"), dict(SEEDS=1, STEPS=4)),
    "exp2_nspeedup": (("SEEDS", "STEPS", "B", "K", "GAMMA"),
                      dict(SEEDS=1, STEPS=3)),
    "exp3_quadratic": (("SEEDS", "STEPS", "D", "N"), dict(SEEDS=1, STEPS=4)),
    "exp4_neuralnet": (("SEEDS", "STEPS", "N"), dict(SEEDS=1, STEPS=3)),
}


@pytest.mark.parametrize("name", sorted(DRIVERS))
def test_driver_keeps_the_reference_constants_and_runs(name, monkeypatch,
                                                       tmp_path):
    keys, cuts = DRIVERS[name]
    ref = importlib.import_module(f"benchmarks.{name}")
    port = importlib.import_module(f"repro_torch.experiments.{name}")
    for k in keys:
        assert getattr(port, k) == getattr(ref, k), k
    from repro_torch.experiments import common
    monkeypatch.setattr(common, "RESULTS_DIR", str(tmp_path))
    for k, v in cuts.items():
        monkeypatch.setattr(port, k, v)
    out = port.run(device="cpu")
    with open(tmp_path / f"{name}.json") as f:
        saved = json.load(f)
    assert saved["claims"] == out["claims"] and out["claims"]
    assert all(isinstance(v, bool) for v in out["claims"].values())


def test_drivers_default_to_cuda():
    """With no card the drivers' default device fails loudly: nothing falls
    back to the CPU."""
    import torch
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default placement succeeds")
    from repro_torch.experiments import fig1_divergence
    with pytest.raises(RuntimeError, match="device='cpu'"):
        fig1_divergence.run()


def test_complexity_check_keeps_the_reference_constants():
    """benchmarks/complexity_check.py's numbers, written in its run():
    Ts 500/2000/8000; σ 0 over 3 seeds from x0 (1, −1), EF21-SGDM(TopK(1),
    η 1), γ 0.2; σ 1 over 4 seeds from x0 (0, −1), η = min(1, 3/√T), γ
    0.05·η, b_init 16."""
    from repro_torch.experiments import complexity_check as cc
    assert cc.TS == (500, 2000, 8000)
    assert (cc.DET_SEEDS, cc.STOCH_SEEDS) == (3, 4)
    assert (cc.DET_X0, cc.DET_ETA, cc.DET_GAMMA) == ((1.0, -1.0), 1.0, 0.2)
    assert (cc.STOCH_X0, cc.STOCH_ETA_SCALE, cc.STOCH_GAMMA_SCALE,
            cc.STOCH_B_INIT) == ((0.0, -1.0), 3.0, 0.05, 16)


def test_complexity_check_deterministic_curve_is_the_reference_s():
    """The σ = 0 running-average curve over 300 rounds within rtol 1e-4
    (the simulator's bar) of the reference simulator's ``run_numpy`` on
    the same config, its median over the same seeds."""
    import numpy as np
    from repro.core import compressors as jax_comp
    from repro.core import ef as jax_ef
    from repro.core import problems as jax_problems
    from repro.core import simulate as jax_sim
    from repro_torch.experiments import complexity_check as cc
    steps = 300
    got = cc.det_curve(steps, device="cpu")
    cfg = jax_sim.SimConfig(n=1, batch_size=1, gamma=cc.DET_GAMMA,
                            steps=steps)
    outs = [jax_sim.run_numpy(
        jax_problems.QuadraticT1(sigma=0.0, x0=cc.DET_X0),
        jax_ef.EF21SGDM(compressor=jax_comp.TopK(k=1), eta=cc.DET_ETA), cfg,
        seed=s) for s in range(cc.DET_SEEDS)]
    gn = np.median(np.stack([o["grad_norm_sq"] for o in outs]), 0)
    want = np.cumsum(gn) / np.arange(1, steps + 1)
    np.testing.assert_allclose(got, want, rtol=1e-4)


def test_complexity_check_runs_at_cut_horizons(monkeypatch, tmp_path):
    """Ts cut to 40/80/160: the σ = 1 values finite, both slopes finite,
    the claims booleans, written to results/torch/complexity_check.json
    (here a temporary directory)."""
    import math
    from repro_torch.experiments import common
    from repro_torch.experiments import complexity_check as cc
    monkeypatch.setattr(common, "RESULTS_DIR", str(tmp_path))
    monkeypatch.setattr(cc, "TS", (40, 80, 160))
    out = cc.run(device="cpu")
    with open(tmp_path / "complexity_check.json") as f:
        saved = json.load(f)
    assert saved["claims"] == out["claims"]
    assert sorted(out["claims"]) == ["det_rate_at_least_1_over_T",
                                     "stoch_rate_near_half"]
    assert all(isinstance(v, bool) for v in out["claims"].values())
    for part in ("deterministic", "stochastic"):
        assert out[part]["Ts"] == [40, 80, 160]
        assert all(math.isfinite(v) for v in out[part]["vals"])
        assert math.isfinite(out[part]["slope"])
