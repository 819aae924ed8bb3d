"""Figure 1 (+ Figure 4): divergence of EF21-SGD on f(x)=½‖x‖² with Top1,
B=1 (the port of benchmarks/fig1_divergence.py).

Claims: (a) EF21-SGD drifts AWAY from the optimum (‖∇f‖² grows far above
its start) — Fig 1a; (b) increasing n does not rescue it — Fig 1b; (c)
EF21-SGDM is stable near the optimum on the same instance — Fig 1a; (d) the
same happens with the App-J time-varying schedule — Fig 4.

    PYTHONPATH=src python -m repro_torch.experiments.fig1_divergence
"""
from __future__ import annotations

from repro_torch.core import compressors as C
from repro_torch.core import ef, problems, simulate
from repro_torch.experiments.common import (Timer, csv_row, main,
                                            median_curves, save_json)

SEEDS = 5
STEPS = 10_000


def run(device=None) -> dict:
    prob = problems.QuadraticT1(device=device)
    top1 = C.TopK(k=1)
    out = {}

    def runs(method, n, tv=False, gamma=1e-3, p=prob):
        cfg = simulate.SimConfig(n=n, batch_size=1, gamma=gamma, steps=STEPS,
                                 time_varying=tv)
        return [simulate.run_numpy(p, method, cfg, seed=s)
                for s in range(SEEDS)]

    with Timer() as t:
        for name, m in [("ef21_sgd", ef.EF21SGD(compressor=top1)),
                        ("ef21_sgdm", ef.EF21SGDM(compressor=top1, eta=1e-3)),
                        ("sgd", ef.SGD())]:
            curve = median_curves(runs(m, n=1))
            out[f"fig1a/{name}"] = {
                "start": float(curve[0]), "end": float(curve[-500:].mean()),
                "max": float(curve.max()),
                "curve_ds": curve[::100].tolist(),
            }
        # Fig 1b: n-sweep for EF21-SGD
        for n in (1, 4, 16):
            curve = median_curves(runs(ef.EF21SGD(compressor=top1), n=n))
            out[f"fig1b/ef21_sgd_n{n}"] = {"start": float(curve[0]),
                                           "end": float(curve[-500:].mean())}
        # Theorem 1's exact object: EF21-SGD-ideal's floor at x⁰ = (0, −1),
        # independent of n: E‖∇f‖² ≥ min(σ², ‖∇f(x⁰)‖²)/60 = 1/60
        prob_thm = problems.QuadraticT1(x0=(0.0, -1.0), device=device)
        floor = 1.0 / 60.0
        for n in (1, 4):
            m = ef.EF21SGDMIdeal(compressor=top1, eta=1.0)
            curve = median_curves(runs(m, n=n, gamma=0.5, p=prob_thm))
            out[f"thm1/ideal_n{n}"] = {"end": float(curve[-500:].mean()),
                                       "floor": floor}
        # Fig 4: time-varying parameters
        for name, m in [("ef21_sgd", ef.EF21SGD(compressor=top1)),
                        ("ef21_sgdm", ef.EF21SGDM(compressor=top1, eta=0.1))]:
            curve = median_curves(runs(m, n=1, tv=True, gamma=0.1))
            out[f"fig4/{name}"] = {"end": float(curve[-500:].mean())}

    sgd_end = out["fig1a/ef21_sgd"]["end"]
    sgdm_end = out["fig1a/ef21_sgdm"]["end"]
    out["claims"] = {
        "ef21_sgd_diverges": sgd_end > 10 * out["fig1a/ef21_sgd"]["start"],
        "sgdm_stable": sgdm_end < sgd_end / 3,
        # convergence is NOT restored at any n (the error still ends ≥2×
        # above its start for every n)
        "no_n_restores_convergence": all(
            out[f"fig1b/ef21_sgd_n{n}"]["end"]
            > 2 * out[f"fig1b/ef21_sgd_n{n}"]["start"] for n in (1, 4, 16)),
        "thm1_floor_holds_all_n": all(
            out[f"thm1/ideal_n{n}"]["end"] >= out[f"thm1/ideal_n{n}"]["floor"]
            for n in (1, 4)),
        "tv_same_story": out["fig4/ef21_sgd"]["end"]
        > 3 * out["fig4/ef21_sgdm"]["end"],
    }
    save_json("fig1_divergence", out)
    csv_row("fig1_divergence", t.us_per(SEEDS * STEPS * 8),
            f"ef21_sgd_end={sgd_end:.2e};sgdm_end={sgdm_end:.2e};"
            f"claims={sum(out['claims'].values())}/{len(out['claims'])}")
    return out


if __name__ == "__main__":
    main(run, __doc__)
