"""Experiment 2 (Figure 3): logistic regression, B=64, TopK, n ∈ {1, 10,
50} (the port of benchmarks/exp2_nspeedup.py).

Claims: EF21-SGDM/2M are near the best at every n AND improve as n grows
(Corollary 2's O(σ²/(nε⁴)) term); EF21-SGD does not. (real-sim replaced by
a shape-matched synthetic set.)

    PYTHONPATH=src python -m repro_torch.experiments.exp2_nspeedup
"""
from __future__ import annotations

from repro_torch.core import compressors as C
from repro_torch.core import ef, problems, simulate
from repro_torch.experiments.common import (Timer, csv_row, main,
                                            median_curves, save_json)

SEEDS = 3
STEPS = 800
B = 64
K = 50
GAMMA = 0.05


def run(device=None) -> dict:
    out = {}
    with Timer() as t:
        for n in (1, 10, 50):
            # iid clients with FIXED per-client data: Corollary 2's speedup
            # term is σ²-averaging across clients
            prob = problems.LogisticRegression(
                n=n, m_per_client=512, l=128, c=2, seed=1,
                heterogeneous=False, device=device)
            topk = C.TopK(k=K)
            for name, m in {
                "ef14_sgd": ef.EF14SGD(compressor=topk),
                "ef21_sgd": ef.EF21SGD(compressor=topk),
                "ef21_sgdm": ef.EF21SGDM(compressor=topk, eta=0.1),
                "ef21_sgd2m": ef.EF21SGD2M(compressor=topk, eta=0.1),
            }.items():
                cfg = simulate.SimConfig(n=n, batch_size=B, gamma=GAMMA,
                                         steps=STEPS, b_init=4)
                runs = [simulate.run_numpy(prob, m, cfg, seed=s)
                        for s in range(SEEDS)]
                curve = median_curves(runs)
                out[f"n{n}/{name}"] = {
                    "end_grad_sq": float(curve[-100:].mean()),
                    "curve_ds": curve[::50].tolist(),
                }
    out["claims"] = {
        # EF14-SGD is competitive on iid synthetic logreg: "within 1.5× of
        # the best"
        "sgdm_near_best_at_n50":
            out["n50/ef21_sgdm"]["end_grad_sq"]
            <= min(out["n50/ef14_sgd"]["end_grad_sq"],
                   out["n50/ef21_sgd"]["end_grad_sq"]) * 1.5,
        "sgdm_improves_with_n":
            out["n50/ef21_sgdm"]["end_grad_sq"]
            < out["n1/ef21_sgdm"]["end_grad_sq"],
    }
    save_json("exp2_nspeedup", out)
    csv_row("exp2_nspeedup", t.us_per(SEEDS * STEPS * 12),
            f"n1_sgdm={out['n1/ef21_sgdm']['end_grad_sq']:.2e};"
            f"n50_sgdm={out['n50/ef21_sgdm']['end_grad_sq']:.2e};"
            f"claims={sum(out['claims'].values())}/2")
    return out


if __name__ == "__main__":
    main(run, __doc__)
