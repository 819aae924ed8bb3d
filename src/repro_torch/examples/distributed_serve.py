"""Streaming serve: one trainer publishing its downlink wire, two serving
replicas subscribing at different lags (counterpart of
examples/distributed_serve.py; launch/fleet.py).

The trainer runs EF21-SGDM with a quant4 downlink carrier and publishes
every wire record to a stream directory; each replica joins from the
stream's bootstrap checkpoint, replays the records through the train
step's tail, and serves requests on params BIT-IDENTICAL to the trainer's
model at its lag: dense f32 weights never travel.

    PYTHONPATH=src python -m repro_torch.examples.distributed_serve
    PYTHONPATH=src python -m repro_torch.examples.distributed_serve --device cpu
"""
from __future__ import annotations

import argparse
import os
import tempfile
from typing import Dict, List, Optional

import torch

from repro_torch.launch import fleet as fleet_lib
from repro_torch.launch.spec import RunSpec

STEPS = 6
SPEC = RunSpec(arch="smollm-360m", smoke=True, clients=2, global_batch=4,
               seq_len=32, compressor="block_topk", ratio=0.1,
               downlink_carrier="quant4", downlink_ratio=0.05)


def main(argv: Optional[List[str]] = None) -> Dict:
    ap = argparse.ArgumentParser("repro_torch.examples.distributed_serve")
    ap.add_argument("--steps", type=int, default=STEPS)
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--stream-dir", default=None,
                    help="the wire stream's directory (default: a new "
                         "temporary one)")
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda)")
    args = ap.parse_args(argv)
    from repro_torch.launch.session import Session
    stream_dir = args.stream_dir or os.path.join(
        tempfile.mkdtemp(prefix="repro_torch_wire_"), "wire")

    # the trainer: EF21-SGDM, quant4 downlink, publishing to the stream
    trainer = Session(SPEC, device=args.device)
    trainer.publish_to(stream_dir, bootstrap_every=4)
    trainer.train(args.steps)
    print(f"trainer @ step {trainer.step}, stream at {stream_dir}")

    # the fleet: two replicas on ONE wire, one fresh and one 2 steps behind
    fleet = fleet_lib.Fleet(stream_dir, n_replicas=2, lags=(0, 2),
                            decode_budget=16, max_batch=2, prompt_len=16,
                            device=args.device)
    fleet.sync()
    head = trainer.params
    identical = {}
    for rep in fleet.replicas:
        match = rep.step == trainer.step and all(
            torch.equal(head[k].cpu(), rep.params[k].cpu()) for k in head)
        identical[rep.name] = match
        print(f"{rep.name}: lag={rep.lag} step={rep.step} "
              f"bit-identical-to-head={match}")

    # a small request load through the fleet
    reqs = fleet_lib.synthetic_requests(args.requests, rate=20.0,
                                        prompt_len=16, max_new_tokens=8,
                                        vocab_size=trainer.cfg.vocab_size)
    out = fleet.run(reqs, sync_every=1)
    print(f"{len(out['requests'])} requests in {out['batches']} batches: "
          f"qps={out['qps']:.2f} p50={out['p50_ms']:.0f}ms "
          f"p99={out['p99_ms']:.0f}ms staleness mean="
          f"{out['staleness_mean']:.1f}")
    for req in out["requests"][:3]:
        print(f"  req {req.rid} via {req.replica} (staleness "
              f"{req.staleness}): {req.tokens_out.tolist()}")
    return {"trainer": trainer, "identical": identical, "fleet": out,
            "stream_dir": stream_dir}


if __name__ == "__main__":
    main()
