"""Quickstart: EF21-SGDM (Algorithm 1) end to end through the
RunSpec/Session API (counterpart of examples/quickstart.py).

Each experiment is ONE declarative, JSON-serializable RunSpec; the Session
owns the rest (mesh, EFConfig, pipeline, step). Trains a reduced SmolLM on
the synthetic pipeline with 4 emulated clients and Top-16-per-block
compression, then uncompressed SGDM for the same steps, and prints the
transmitted-coordinate savings.

    PYTHONPATH=src python -m repro_torch.examples.quickstart          # card
    PYTHONPATH=src python -m repro_torch.examples.quickstart --device cpu
"""
from __future__ import annotations

import argparse
from typing import Dict, List, Optional, Tuple

from repro_torch.launch import build as build_lib
from repro_torch.launch.spec import RunSpec
from repro_torch.models import model as model_lib

STEPS = 120
BASE = dict(arch="smollm-360m", smoke=True, clients=4, global_batch=8,
            seq_len=128, eta=0.2, lr=0.5)
SPECS: List[Tuple[str, RunSpec]] = [
    ("EF21-SGDM + BlockTopK(1.6%)",
     RunSpec(**BASE, method="ef21_sgdm", compressor="block_topk",
             compressor_kw={"block": 1024, "k_per_block": 16})),
    ("SGDM (uncompressed)",
     RunSpec(**BASE, method="sgdm", compressor="identity")),
]


def main(argv: Optional[List[str]] = None) -> List[Dict]:
    ap = argparse.ArgumentParser("repro_torch.examples.quickstart")
    ap.add_argument("--steps", type=int, default=STEPS)
    ap.add_argument("--log-every", type=int, default=40)
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda; 'cpu' runs the plain "
                         "versions of the kernels)")
    args = ap.parse_args(argv)
    from repro_torch.launch.session import Session
    out = []
    for name, spec in SPECS:
        print(f"== {name}", flush=True)
        sess = Session(spec, device=args.device)
        sess.train(args.steps, log_every=args.log_every, verbose=True)
        d = sum(t.numel() for t in model_lib.init_params(
            sess.cfg, None, "meta").values())
        coords = build_lib.make_method(spec).coords_per_message(d)
        print(f"{name}: final loss {sess.history[-1]['loss']:.4f}, "
              f"{coords:.3g}/{d:.3g} coords per client per round "
              f"({100 * coords / d:.1f}% of uncompressed)")
        print(f"  spec: {spec.to_json()}\n", flush=True)
        out.append({"name": name, "spec": spec, "history": sess.history,
                    "coords": coords, "d": d})
    return out


if __name__ == "__main__":
    main()
