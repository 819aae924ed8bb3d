"""Tables 1–2: the measured rate exponents of EF21-SGDM (the port of
benchmarks/complexity_check.py).

Theorems 2/3 predict E‖∇f(x̂ᵀ)‖² = O(1/(αT)) in the deterministic case and
O(√(σ²/T)) asymptotically in the stochastic case. The log-log slope of the
running-average ‖∇f‖² against T on the paper's quadratic (``QuadraticT1``)
should land near −1 with σ = 0 and near −1/2 with σ = 1 and η ∝ T^−1/2.

    PYTHONPATH=src python -m repro_torch.experiments.complexity_check
    PYTHONPATH=src python -m repro_torch.experiments.complexity_check \\
        --device cpu
"""
from __future__ import annotations

import numpy as np

from repro_torch.core import compressors as C
from repro_torch.core import ef, problems, simulate
from repro_torch.experiments.common import (Timer, csv_row, main,
                                            median_curves, save_json)

TS = (500, 2000, 8000)
DET_SEEDS = 3
STOCH_SEEDS = 4
# σ = 0: EF21-SGDM(TopK(1), η 1) from x0 (1, −1) at γ 0.2
DET_X0 = (1.0, -1.0)
DET_ETA = 1.0
DET_GAMMA = 0.2
# σ = 1 from x0 (0, −1): η = min(1, 3/√T), γ 0.05·η, a first batch of 16
STOCH_X0 = (0.0, -1.0)
STOCH_ETA_SCALE = 3.0
STOCH_GAMMA_SCALE = 0.05
STOCH_B_INIT = 16


def det_curve(steps: int, device=None) -> np.ndarray:
    """σ = 0: the median over DET_SEEDS of ‖∇f(xᵗ)‖², averaged over the
    first t rounds (E over a uniform x̂ᵗ), for t = 1..steps."""
    prob = problems.QuadraticT1(sigma=0.0, x0=DET_X0, device=device)
    m = ef.EF21SGDM(compressor=C.TopK(k=1), eta=DET_ETA)
    cfg = simulate.SimConfig(n=1, batch_size=1, gamma=DET_GAMMA, steps=steps)
    gn = median_curves([simulate.run_numpy(prob, m, cfg, seed=s)
                        for s in range(DET_SEEDS)])
    return np.cumsum(gn) / np.arange(1, steps + 1)


def stoch_value(T: int, device=None) -> float:
    """σ = 1 at horizon T (η and γ tuned to T): the mean over the rounds of
    the median over STOCH_SEEDS of ‖∇f(xᵗ)‖²."""
    prob = problems.QuadraticT1(sigma=1.0, x0=STOCH_X0, device=device)
    eta = min(1.0, STOCH_ETA_SCALE / np.sqrt(T))
    m = ef.EF21SGDM(compressor=C.TopK(k=1), eta=float(eta))
    cfg = simulate.SimConfig(n=1, batch_size=1, gamma=STOCH_GAMMA_SCALE * eta,
                             steps=int(T), b_init=STOCH_B_INIT)
    return float(median_curves([simulate.run_numpy(prob, m, cfg, seed=s)
                                for s in range(STOCH_SEEDS)]).mean())


def run(device=None) -> dict:
    Ts = np.asarray(TS)
    with Timer() as t:
        vals_det = det_curve(int(Ts[-1]), device)[Ts - 1]
        slope_det = np.polyfit(np.log(Ts), np.log(vals_det + 1e-30), 1)[0]
        vals_st = [stoch_value(int(T), device) for T in Ts]
        slope_st = np.polyfit(np.log(Ts), np.log(np.asarray(vals_st)), 1)[0]
    out = {
        "deterministic": {"Ts": Ts.tolist(), "vals": vals_det.tolist(),
                          "slope": float(slope_det), "theory": -1.0},
        "stochastic": {"Ts": Ts.tolist(), "vals": vals_st,
                       "slope": float(slope_st), "theory": -0.5},
        "claims": {
            "det_rate_at_least_1_over_T": bool(slope_det < -0.7),
            "stoch_rate_near_half": bool(-1.1 < slope_st < -0.25),
        },
    }
    save_json("complexity_check", out)
    csv_row("complexity_check", t.us_per(int(Ts.sum()) * 7),
            f"slope_det={slope_det:.2f}(-1);slope_stoch={slope_st:.2f}(-0.5);"
            f"claims={sum(out['claims'].values())}/2")
    return out


if __name__ == "__main__":
    main(run, __doc__)
