"""The production-mesh dry run (counterpart of src/repro/launch/dryrun.py):
one step of every (architecture x input shape) traced at one rank's
coordinate of the production mesh, in one process and without a card, and
what that rank holds, computes and sends.

  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch gemma2-9b --shape train_4k
  PYTHONPATH=src python -m repro_torch.launch.dryrun --all --out results/dryrun.json
  ... --mesh multi_pod     → (pod=2, data=16, model=16) = 512 ranks
  ... --carrier sparse     → wire-optimized (values, indices) aggregation
  ... --granularity pod    → EF clients = pods
  ... --state-sharding zero → ZeRO-sharded EF state (refused where the
                              reference's round fails)
  ... --rank 17            → the coordinate traced (default 0)

Every combo is one RunSpec traced through ``Session.lower()``
(launch/session.py), the Session's own train step or serving closures on
meta tensors (launch/trace_analysis.py). The world is a
``torch.distributed`` process group of the mesh's full size on PyTorch's
``fake`` backend (``FakeStore``), joined as ``--rank``: the Session builds
its production mesh, groups and collectives as on the cards, and each
collective returns at once. A spec-level ValueError (a fused
misconfiguration, the ZeRO state the reference cannot build) is recorded
as FAIL; ``long_500k`` on the pure full-attention archs is SKIP, with the
reference's reasons.

A record keeps the reference's keys (``status``, ``n_devices``, ``flops``,
``collectives``, ``collective_counts``, ``collective_bytes``,
``memory{argument_bytes, output_bytes, temp_bytes, alias_bytes}``, and the
spec's fields) and adds ``kernel_launches`` (the hand kernels' traced
launches by name) and ``arguments`` (``argument_bytes`` by tree: params,
optimizer and EF state, batch, cache). The reference's ``xla_*`` keys
(XLA's own cost analysis, which counts a loop body once) and
``compile_s`` have no counterpart: nothing is compiled, and
trace_analysis.py's module doc says how each figure differs from the
reference analyzer's. ``lower_s`` is the trace's wall time.
"""
from __future__ import annotations

import argparse
import contextlib
import json
import os
import sys
import time
import traceback
from typing import Dict, Optional

from repro_torch.configs import base as cb
from repro_torch.launch import spec as spec_lib

# long_500k requires sub-quadratic state: the pure full-attention archs
# are skipped, with the reference's reasons
LONG_SKIP = {
    "granite_34b": "pure full attention (MQA), no windowed variant published",
    "smollm_360m": "pure full attention, no windowed variant published",
    "musicgen_medium": "pure full attention over EnCodec tokens",
    "internvl2_76b": "pure full attention LLM decoder",
    "olmoe_1b_7b": "pure full attention MoE",
    "grok1_314b": "pure full attention MoE",
}

MESH_SIZE = {"pod": 16 * 16, "multi_pod": 2 * 16 * 16}


@contextlib.contextmanager
def fake_world(size: int, rank: int = 0):
    """A ``torch.distributed`` world of ``size`` ranks on the ``fake``
    backend, joined as ``rank``, destroyed on exit. Nothing else may hold
    a process group in this process."""
    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore
    if dist.is_initialized():
        raise RuntimeError("a process group is already initialized here; "
                           "the dry run needs a world of its own")
    dist.init_process_group("fake", rank=rank, world_size=size,
                            store=FakeStore())
    try:
        yield
    finally:
        dist.destroy_process_group()


def run_one(arch: str, shape_name: str, *, mesh: str = "pod",
            carrier: str = "dense", method: str = "ef21_sgdm",
            compressor: str = "block_topk", ratio: float = 0.01,
            granularity: str = "group", state_sharding: str = "client",
            ef_state_dtype: Optional[str] = None, pad_heads: int = 0,
            moe_impl: str = "dispatch", optimizer: str = "sgd",
            extra_tag: str = "", rank: int = 0) -> Dict:
    """One cell's record (module doc), traced at ``rank``'s coordinate.
    The port's RunSpec names the arch by its id (the reference's also
    takes the module name, which its record keeps, as this one does)."""
    mod = cb.ARCH_ALIASES.get(arch, arch)
    rec: Dict = {
        "arch": mod, "shape": shape_name, "multi_pod": mesh == "multi_pod",
        "carrier": carrier, "method": method, "compressor": compressor,
        "granularity": granularity, "state_sharding": state_sharding,
        "optimizer": optimizer, "tag": extra_tag,
    }
    if shape_name == "long_500k" and mod in LONG_SKIP:
        rec.update(status="SKIP", reason=LONG_SKIP[mod])
        return rec

    t0 = time.time()
    try:
        spec = spec_lib.RunSpec(
            arch=arch, shape=shape_name, mesh=mesh, carrier=carrier,
            method=method, compressor=compressor, ratio=ratio,
            client_granularity=granularity, state_sharding=state_sharding,
            ef_state_dtype=ef_state_dtype, tp_pad_heads=pad_heads,
            moe_impl=moe_impl, optimizer=optimizer)
        rec["spec_hash"] = spec.spec_hash()
        from repro_torch.launch.session import Session
        size = MESH_SIZE.get(spec.mesh, 1)
        world = fake_world(size, rank) if size > 1 \
            else contextlib.nullcontext()
        with world:
            sess = Session(spec, device="cpu")
            got = sess.lower(shape_name)
        got.pop("leaves")
        rec.update(status="OK", lower_s=round(time.time() - t0, 1),
                   rank=rank, **got)
    except Exception as e:  # noqa: BLE001 — record, don't crash the sweep
        rec.update(status="FAIL", error=f"{type(e).__name__}: {e}",
                   traceback=traceback.format_exc()[-2000:])
    return rec


def main(argv=None) -> None:
    ap = argparse.ArgumentParser("repro_torch.launch.dryrun")
    ap.add_argument("--arch", default=None,
                    help="arch id (e.g. gemma2-9b); omit with --all")
    ap.add_argument("--shape", default=None, choices=[*cb.INPUT_SHAPES, None])
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--multi-pod", action="store_true",
                    help="alias for --mesh multi_pod")
    ap.add_argument("--mesh", default="pod", choices=["pod", "multi_pod"])
    ap.add_argument("--carrier", default="dense",
                    choices=sorted(spec_lib.CARRIERS))
    ap.add_argument("--method", default="ef21_sgdm")
    ap.add_argument("--compressor", default="block_topk")
    ap.add_argument("--ratio", type=float, default=0.01)
    ap.add_argument("--granularity", default="group", choices=["group", "pod"])
    ap.add_argument("--state-sharding", default="client",
                    choices=["client", "zero"])
    ap.add_argument("--ef-state-dtype", default=None)
    ap.add_argument("--pad-heads", type=int, default=0)
    ap.add_argument("--moe-impl", default="dispatch",
                    choices=["dispatch", "dense"])
    ap.add_argument("--optimizer", default="sgd")
    ap.add_argument("--tag", default="")
    ap.add_argument("--rank", type=int, default=0,
                    help="the rank whose coordinate is traced")
    ap.add_argument("--out", default=None, help="JSON output path")
    args = ap.parse_args(argv)
    mesh = "multi_pod" if args.multi_pod else args.mesh

    if args.all:
        combos = [(a, s) for a in cb.ARCH_ALIASES for s in cb.INPUT_SHAPES]
    else:
        if not (args.arch and args.shape):
            ap.error("--arch and --shape, or --all")
        combos = [(args.arch, args.shape)]

    results = []
    for a, s in combos:
        rec = run_one(
            a, s, mesh=mesh, carrier=args.carrier,
            method=args.method, compressor=args.compressor, ratio=args.ratio,
            granularity=args.granularity, state_sharding=args.state_sharding,
            ef_state_dtype=args.ef_state_dtype, pad_heads=args.pad_heads,
            moe_impl=args.moe_impl, optimizer=args.optimizer,
            extra_tag=args.tag, rank=args.rank)
        results.append(rec)
        line = f"[{rec['status']:4s}] {rec['arch']:18s} {rec['shape']:12s}"
        if rec["status"] == "OK":
            parts = " ".join(f"{k}={v}" for k, v in rec["arguments"].items())
            line += (f" flops={rec['flops']:.3e}"
                     f" coll={rec['collective_bytes']:.3e}"
                     f" temp={rec['memory']['temp_bytes'] / 2 ** 30:.2f}GiB"
                     f" {parts} lower={rec['lower_s']}s")
        elif rec["status"] == "FAIL":
            line += " " + rec["error"][:160]
        else:
            line += " " + rec["reason"]
        print(line, flush=True)

    if args.out:
        os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(results, f, indent=1)
        print(f"wrote {args.out}")
    sys.exit(0 if all(r["status"] != "FAIL" for r in results) else 1)


if __name__ == "__main__":
    main()
