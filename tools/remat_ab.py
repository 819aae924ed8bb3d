#!/usr/bin/env python3
"""Time full-width training paths of two checkouts of the port in turns on
one card, with block recompute on and off in the newer one:

    python3 tools/remat_ab.py PARENT_DIR CHANGE_DIR [--steps 5]

Four processes run in the order parent, change, change, parent. Each
imports its checkout's chip_smoke.py, builds the kernels and runs
``chip_smoke.main_path`` (full-width smollm-360m, 8 clients,
fused_quickstart.json) on two paths: fused_quant8 up and fused_quant4 down,
and phase G's groups. The change's processes run each path with
``cfg.remat`` on and off, on first in the first process and off first in
the second. Every run prints one JSON line (``{"run": ...}``): the
checkout, the path, remat, the steps' ms after the first, the client pass,
EF round and optimizer ms of main_path's step breakdown, and the peak
bytes. The last line is a JSON summary: per checkout, path and remat, the
median step ms and client-pass ms over all its runs."""
import argparse
import contextlib
import io
import json
import os
import re
import statistics
import subprocess
import sys

PATHS = {"fused_quant8": {"carrier": "fused_quant8",
                          "downlink_carrier": "fused_quant4"},
         "G": None}                     # chip_smoke.G_GROUPS of the checkout


def child(tree: str, arms, steps: int) -> None:
    """Run every path once for each arm in this process."""
    tree = os.path.abspath(tree)
    sys.path.insert(0, tree)
    import chip_smoke as cs
    import torch
    if not torch.cuda.is_available():
        sys.exit("this run needs a CUDA card")
    sys.path.insert(0, cs.SRC)
    from repro_torch.kernels import build, ops
    from repro_torch.launch import spec as spec_lib
    from repro_torch.launch.session import Session
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    build.build()
    for path, overrides in PATHS.items():
        overrides = overrides or {"groups": cs.G_GROUPS}
        for arm in arms:
            kw = {} if arm == "parent" else {"cut": {"remat": arm == "on"}}
            out = io.StringIO()
            try:
                with contextlib.redirect_stdout(out):
                    cs.main_path(Session, spec_lib, ops, steps, **kw,
                                 **overrides)
            except SystemExit:                      # a check failed
                print(out.getvalue(), flush=True)
                raise
            text = out.getvalue()
            m = re.search(r"step_ms \[([^\]]*)\] max_memory_allocated (\d+)",
                          text)
            b = re.search(r"client_grads ([\d.]+) ef_round ([\d.]+) "
                          r"optimizer ([\d.]+)", text)
            if m is None or b is None:
                sys.exit(f"no step times in main_path's output:\n{text}")
            step_ms = [float(x) for x in m.group(1).split(",")]
            print(json.dumps({"run": {
                "tree": tree, "path": path, "remat": arm,
                "step_ms": step_ms[1:], "peak_bytes": int(m.group(2)),
                "client_grads_ms": float(b.group(1)),
                "ef_round_ms": float(b.group(2)),
                "optimizer_ms": float(b.group(3))}}), flush=True)


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("parent", nargs="?")
    ap.add_argument("change", nargs="?")
    ap.add_argument("--steps", type=int, default=5)
    ap.add_argument("--child", help=argparse.SUPPRESS)
    ap.add_argument("--arms", help=argparse.SUPPRESS)
    a = ap.parse_args()
    if a.child:
        child(a.child, a.arms.split(","), a.steps)
        return
    if not (a.parent and a.change):
        ap.error("give PARENT_DIR and CHANGE_DIR")
    order = [(a.parent, "parent"), (a.change, "on,off"),
             (a.change, "off,on"), (a.parent, "parent")]
    runs = []
    for tree, arms in order:
        proc = subprocess.run(
            [sys.executable, os.path.abspath(__file__), "--child", tree,
             "--arms", arms, "--steps", str(a.steps)],
            stdout=subprocess.PIPE, text=True)
        for line in proc.stdout.splitlines():
            if line.startswith('{"run"'):
                print(line, flush=True)
                runs.append(json.loads(line)["run"])
        if proc.returncode:
            print(proc.stdout[-6000:], flush=True)
            sys.exit(f"the run of {tree} ({arms}) failed with exit code "
                     f"{proc.returncode}")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], stdout=subprocess.PIPE,
        text=True).stdout.strip()
    summary = {}
    for r in runs:
        key = f"parent {r['path']}" if r["remat"] == "parent" else \
            f"change {r['path']} remat={r['remat']}"
        s = summary.setdefault(key, {"step_ms": [], "client_grads_ms": [],
                                     "peak_bytes": r["peak_bytes"]})
        s["step_ms"] += r["step_ms"]
        s["client_grads_ms"].append(r["client_grads_ms"])
    for s in summary.values():
        s["median_step_ms"] = statistics.median(s["step_ms"])
        s["median_client_grads_ms"] = statistics.median(s["client_grads_ms"])
    print(json.dumps({"card": card, "summary": summary}), flush=True)


if __name__ == "__main__":
    main()
