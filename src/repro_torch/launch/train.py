"""Training driver — flags → RunSpec → Session (counterpart of
src/repro/launch/train.py):

  PYTHONPATH=src python -m repro_torch.launch.train \
      --spec results/specs/fused_quickstart.json \
      --carrier fused_quant8 --downlink-carrier fused_quant4 --steps 3

  # the unfused quantized wire (K5/K6), dense payload:
  PYTHONPATH=src python -m repro_torch.launch.train \
      --spec results/specs/fused_quickstart.json --compressor identity \
      --compressor-kw '{}' --carrier quant8 --downlink-carrier quant4

  # a per-group schedule, sampled participation, the two-tier hierarchy
  # (the shipped specs; --schedule, --participation and --hops take the
  # reference's grammars, e.g. --hops pods=2,cross=quant4:0.05):
  PYTHONPATH=src python -m repro_torch.launch.train \
      --spec results/specs/mixed_schedule.json --steps 3
  PYTHONPATH=src python -m repro_torch.launch.train \
      --spec results/specs/sampled_quarter.json --steps 3
  PYTHONPATH=src python -m repro_torch.launch.train \
      --spec results/specs/hierarchy_quant4_cross.json --steps 3

  # checkpoints every 2 steps, then the same run resumed to step 6:
  PYTHONPATH=src python -m repro_torch.launch.train ... --steps 4 \
      --ckpt-dir /path/to/run --ckpt-every 2
  PYTHONPATH=src python -m repro_torch.launch.train --ckpt-dir /path/to/run \
      --resume --steps 6

  # publish every step's downlink wire for a serving fleet
  # (python -m repro_torch.launch.serve --serve-stream /path/to/wire):
  PYTHONPATH=src python -m repro_torch.launch.train \
      --spec results/specs/fused_quickstart.json --carrier fused_quant8 \
      --downlink-carrier fused_quant4 --steps 3 --publish-stream /path/to/wire

  # one client a process over torch.distributed (mesh pod: data 4, model
  # 1 on four processes; start all four, process ids 0..3):
  PYTHONPATH=src python -m repro_torch.launch.train \
      --spec results/specs/fused_quant8_overlap.json --smoke --seq 64 \
      --device cpu --steps 3 --coordinator localhost:29511 \
      --num-processes 4 --process-id 0

Runs on the CUDA card; ``--device cpu`` runs the kernels' plain PyTorch
versions on the CPU (use ``--smoke`` there). Prints the reference CLI's
``step N loss … g_norm …`` lines.

``--resume`` restores the full training state (params, opt_state, ef_state
and the data cursor) from the latest checkpoint under ``--ckpt-dir``. The
RunSpec embedded in it wins: spec flags passed with ``--resume`` change
single fields on top of it, a ``--spec`` file must match it, and a change
to an experiment-defining field is refused unless ``--allow-spec-mismatch``.
An empty or absent ``--ckpt-dir`` starts a fresh run. ``--ckpt-every`` on
the resume command line applies (checkpoint policy is not part of the
experiment).

``--publish-stream DIR`` appends each step's downlink wire records to a
wire stream (core/stream.py) with a bootstrap checkpoint to join from, and
one more every ``--bootstrap-every`` steps; ``--metrics-out FILE`` writes
the logged steps' loss and g_norm as JSON.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os

from repro_torch.launch import spec as spec_lib


def main(argv=None) -> None:
    # the clients' one batched pass holds all their gradients and, between
    # recomputed blocks, their activations at once (a full-width step peaks
    # at 46 to 79 GB): segments that grow in place keep the caching
    # allocator from freeing its cache and retrying, which synchronizes the
    # card (set before the first CUDA allocation)
    os.environ.setdefault("PYTORCH_CUDA_ALLOC_CONF",
                          "expandable_segments:True")
    ap = argparse.ArgumentParser("repro_torch.launch.train")
    spec_lib.add_flags(ap)
    ap.add_argument("--steps", type=int, default=200,
                    help="train until this ABSOLUTE step count")
    ap.add_argument("--resume", action="store_true",
                    help="restore the full state from the latest checkpoint "
                         "in --ckpt-dir (the spec embedded there wins)")
    ap.add_argument("--allow-spec-mismatch", action="store_true",
                    help="resume even when the spec differs from the "
                         "checkpoint's")
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--metrics-out", default=None, metavar="FILE",
                    help="write the logged steps' loss and g_norm here "
                         "(JSON)")
    ap.add_argument("--publish-stream", default=None, metavar="DIR",
                    help="publish every downlink wire record to this stream "
                         "dir (core/stream.py) so serving replicas can "
                         "subscribe (launch/fleet.py)")
    ap.add_argument("--bootstrap-every", type=int, default=0,
                    help="with --publish-stream: also write a bootstrap "
                         "checkpoint into the stream every N steps (0 = "
                         "only the initial one)")
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda; 'cpu' runs the plain "
                         "versions of the kernels)")
    ap.add_argument("--coordinator", default=None, metavar="HOST:PORT",
                    help="join a multi-process torch.distributed world at "
                         "this address (process 0 listens there) before "
                         "the session is built; needs --num-processes and "
                         "--process-id (launch/multiproc.py)")
    ap.add_argument("--num-processes", type=int, default=None)
    ap.add_argument("--process-id", type=int, default=None)
    args = ap.parse_args(argv)
    spec = spec_lib.from_args(args)

    if args.coordinator is not None:
        if args.num_processes is None or args.process_id is None:
            ap.error("--coordinator needs --num-processes and --process-id")
        from repro_torch.launch import multiproc
        multiproc.distributed_init(
            args.coordinator, args.num_processes, args.process_id,
            backend="gloo" if args.device == "cpu" else None)

    from repro_torch.launch.session import Session
    if args.resume:
        if not spec.ckpt_dir:
            ap.error("--resume needs --ckpt-dir")
        try:
            if args.spec_file:
                sess = Session.resume(
                    spec.ckpt_dir, spec=spec, device=args.device,
                    allow_spec_mismatch=args.allow_spec_mismatch)
            else:
                explicit = spec_lib.explicit_fields(
                    args, ignore=("ckpt_dir", "ckpt_every"))
                sess = Session.resume(
                    spec.ckpt_dir, device=args.device,
                    overrides={f: getattr(args, f) for f in explicit} or None,
                    allow_spec_mismatch=args.allow_spec_mismatch)
            print(f"resumed {sess.spec.arch} from {spec.ckpt_dir} "
                  f"@ step {sess.step}", flush=True)
        except FileNotFoundError:
            print(f"no checkpoint under {spec.ckpt_dir}; starting fresh",
                  flush=True)
            sess = Session(spec, device=args.device)
        if args.ckpt_every is not None:
            sess.spec = dataclasses.replace(sess.spec,
                                            ckpt_every=args.ckpt_every)
    else:
        sess = Session(spec, device=args.device)
    # from the spec the session runs (a bare --resume takes the
    # checkpoint's)
    table = sess.schedule_table()
    if table is not None:
        print("compression schedule (first-match-wins):", flush=True)
        print(table, flush=True)
    else:
        print(f"carrier={sess.spec.carrier} "
              f"downlink={sess.spec.downlink_carrier}", flush=True)
    pp = spec_lib.participation_preview(sess.spec)
    if pp["mode"] != "full":
        print(f"participation mode={pp['mode']} fraction={pp['fraction']} "
              f"seed={pp['seed']} cohort={pp['cohort']}/{pp['n']} per round",
              flush=True)
    hp = spec_lib.hops_preview(sess.spec)
    if hp["hierarchical"]:
        print(f"hops pods={hp['pods']} cross={hp['cross_carrier']}"
              f":{hp['cross_ratio']} "
              f"clients_per_pod={hp['clients_per_pod']}"
              + (" (trivial cross: flat-equivalent)"
                 if hp["trivial_cross"] else ""), flush=True)
    print(f"optimizer={sess.spec.optimizer} "
          f"ef_state_dtype={sess.spec.ef_state_dtype} device={sess.device}",
          flush=True)
    if args.publish_stream:
        sess.publish_to(args.publish_stream,
                        bootstrap_every=args.bootstrap_every)
        print(f"publishing wire records to {args.publish_stream}",
              flush=True)
    sess.train(args.steps, log_every=args.log_every, verbose=True)
    if sess.spec.ckpt_dir:
        print(f"saved checkpoint @ {sess.step}", flush=True)
    if args.metrics_out:
        os.makedirs(os.path.dirname(args.metrics_out) or ".", exist_ok=True)
        with open(args.metrics_out, "w") as f:
            json.dump(sess.history, f, indent=1)
    if args.coordinator is not None:
        multiproc.shutdown()


if __name__ == "__main__":
    main()
