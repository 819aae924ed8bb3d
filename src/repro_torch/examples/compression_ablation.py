"""Ablation: every EF method x several compressors on one problem (the
paper's method zoo side by side), reporting the final ‖∇f‖² and the
transmitted coordinates (counterpart of examples/compression_ablation.py).

Each grid cell is named by a declarative RunSpec (launch/spec.py), the
surface the production drivers use, and its Method is built from it by
``build.make_method``, so the simulator sweep and the production train path
cannot disagree about what a cell means. Swap ``simulate.run_numpy`` for
``Session(spec).train`` to run a cell at model scale. Then a mixed
per-parameter-group schedule on the MLP problem against uniform sparse.

    PYTHONPATH=src python -m repro_torch.examples.compression_ablation
    PYTHONPATH=src python -m repro_torch.examples.compression_ablation --device cpu
"""
from __future__ import annotations

import argparse
from typing import Dict, List, Optional

import numpy as np

from repro_torch.core import compressors as C
from repro_torch.core import ef as ef_lib
from repro_torch.core import problems, simulate
from repro_torch.core import schedule as sched_lib
from repro_torch.launch import build as build_lib
from repro_torch.launch.spec import RunSpec

STEPS = 1200
MIXED_STEPS = 400
COMPRESSORS = [
    ("top10", "topk", {"k": 10}),
    ("block_topk", "block_topk", {"block": 64, "k_per_block": 4}),
    ("randk10", "randk", {"k": 10}),
    ("natural", "natural", {}),
    ("rank1", "rank1", {"rows": 15}),
]


def grid() -> List[RunSpec]:
    out = [RunSpec(method=mname, compressor=cname, compressor_kw=ckw,
                   eta=0.1)
           for _, cname, ckw in COMPRESSORS
           for mname in ["ef21_sgd", "ef21_sgdm", "ef21_sgd2m", "ef14_sgd"]]
    # the absolute compressor variant (Algorithm 4)
    out.append(RunSpec(method="ef21_sgdm_abs", compressor="hard_threshold",
                       compressor_kw={"lam": 0.05},
                       method_kw={"gamma": 0.05}, eta=0.1))
    # bidirectional: the block_topk row's uplink, the server broadcast on a
    # quant4 wire; its total (up + down) wire words against the rows above
    out.append(RunSpec(method="ef21_sgdm", compressor="block_topk",
                       compressor_kw={"block": 64, "k_per_block": 4},
                       eta=0.1, downlink_carrier="quant4",
                       downlink_ratio=0.05))
    return out


def sim_config(spec: RunSpec, steps: int) -> simulate.SimConfig:
    return simulate.SimConfig(
        n=8, batch_size=4, gamma=0.05, steps=steps, b_init=4,
        down_carrier=spec.downlink_carrier,
        down_compressor=build_lib.make_down_compressor(spec))


def main(argv: Optional[List[str]] = None) -> Dict:
    ap = argparse.ArgumentParser("repro_torch.examples.compression_ablation")
    ap.add_argument("--steps", type=int, default=STEPS)
    ap.add_argument("--mixed-steps", type=int, default=MIXED_STEPS)
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda)")
    args = ap.parse_args(argv)
    prob = problems.LogisticRegression(n=8, m_per_client=128, l=32, c=5,
                                       seed=0, device=args.device)
    d = prob.dim
    rows = []
    for spec in grid():
        m = build_lib.make_method(spec)
        out = simulate.run_numpy(prob, m, sim_config(spec, args.steps),
                                 seed=0)
        gn = float(np.asarray(out["grad_norm_sq"][-100:]).mean())
        label = spec.compressor + (f"+{spec.downlink_carrier}↓"
                                   if spec.downlink_carrier != "dense"
                                   else "")
        rows.append((spec.method, label, gn, m.coords_per_message(d),
                     out["wire_words_total_per_round"]))
    print(f"{'method':15s} {'compressor':12s} {'end ‖∇f‖²':>12s} "
          f"{'coords/round':>13s} {'wire up+down':>13s}")
    for mname, cname, gn, coords, wire in sorted(rows, key=lambda r: r[2]):
        print(f"{mname:15s} {cname:12s} {gn:12.3e} {coords:13.0f} "
              f"{wire:13.0f}")

    # a mixed per-parameter-group schedule on a multi-leaf problem: dense
    # biases, quant4 on the input layer (the embedding's analogue), sparse
    # on the other matrices, against the uniform sparse schedule
    mlp = problems.MLPClassification(n=8, m_per_client=128, seed=0,
                                     device=args.device)
    btk = C.BlockTopK(block=64, k_per_block=4)
    method = ef_lib.EF21SGDM(compressor=btk, eta=0.1)
    mixed = sched_lib.CompressionSchedule((
        sched_lib.Group(pattern="b", compressor=C.Identity(),
                        carrier="dense"),
        sched_lib.Group(pattern="w1", compressor=btk, carrier="quant4"),
        sched_lib.Group(pattern="*", compressor=C.BlockTopK(
            block=64, k_per_block=2), carrier="sparse"),
    ))
    uniform = sched_lib.CompressionSchedule.uniform(btk, carrier="sparse")
    print("\nmixed schedule (dense b* | quant4 w1 | sparse *) vs uniform "
          "sparse:")
    scheduled = {}
    for label, sched in (("uniform", uniform), ("mixed", mixed)):
        cfg = simulate.SimConfig(n=8, batch_size=4, gamma=0.05,
                                 steps=args.mixed_steps, b_init=4,
                                 schedule=sched)
        out = simulate.run_numpy(mlp, method, cfg, seed=0)
        gn = float(np.asarray(out["grad_norm_sq"][-50:]).mean())
        per = ", ".join(f"{g.pattern}={w:.0f}" for g, w in zip(
            sched.groups, np.asarray(out["wire_words_up_per_group"])))
        print(f"  {label:8s} end ‖∇f‖² {gn:9.3e}  wire/round up "
              f"{out['wire_words_up_per_round']:6.0f} [{per}] "
              f"total {out['wire_words_total_per_round']:.0f}")
        scheduled[label] = out
    print(sched_lib.plan_table(mixed, method, mlp.init_x()))
    return {"rows": rows, "scheduled": scheduled}


if __name__ == "__main__":
    main()
