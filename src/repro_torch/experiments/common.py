"""What the experiment drivers share: the results file, a timer, median
curves over seeds and the command line (``--device``, cuda by default)."""
from __future__ import annotations

import argparse
import json
import os
import time
from typing import Callable, Dict, List

import numpy as np

ROOT = os.path.normpath(os.path.join(os.path.dirname(__file__), "..", "..",
                                     ".."))
RESULTS_DIR = os.path.join(ROOT, "results", "torch")


def save_json(name: str, payload) -> str:
    """Write ``results/torch/<name>.json`` and return its path."""
    os.makedirs(RESULTS_DIR, exist_ok=True)
    path = os.path.join(RESULTS_DIR, f"{name}.json")
    with open(path, "w") as f:
        json.dump(payload, f, indent=1, default=float)
    return path


def csv_row(name: str, us_per_call: float, derived: str) -> None:
    print(f"{name},{us_per_call:.1f},{derived}", flush=True)


class Timer:
    def __enter__(self):
        self.t0 = time.time()
        return self

    def __exit__(self, *a):
        self.dt = time.time() - self.t0

    def us_per(self, calls: int) -> float:
        return 1e6 * self.dt / max(calls, 1)


def median_curves(runs: List[Dict], key: str = "grad_norm_sq") -> np.ndarray:
    return np.median(np.stack([r[key] for r in runs]), axis=0)


def main(run: Callable[..., dict], doc: str) -> None:
    """The drivers' command line: ``--device`` (cuda unless told)."""
    ap = argparse.ArgumentParser(description=doc.splitlines()[0])
    ap.add_argument("--device", default="cuda",
                    help="where the problem's data and the run live "
                         "(default cuda; 'cpu' runs the plain versions)")
    args = ap.parse_args()
    out = run(device=args.device)
    print(json.dumps(out["claims"]), flush=True)
