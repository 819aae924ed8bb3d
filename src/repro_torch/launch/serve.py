"""Serving command line — flags → RunSpec → Session or Fleet (counterpart of
src/repro/launch/serve.py).

Static one-shot serve (the spec comes from flags):

  PYTHONPATH=src python -m repro_torch.launch.serve --arch smollm-360m \
      --batch 8 --prompt-len 1024 --decode-steps 32

runs batched prefill (the hand flash-attention kernel K7) and greedy decode
from fresh weights.

Fleet mode — serving replicas subscribed to a wire stream a trainer is
publishing (``repro_torch.launch.train --publish-stream DIR``); the RunSpec
comes from the stream's bootstrap checkpoint, NOT from flags:

  PYTHONPATH=src python -m repro_torch.launch.serve --serve-stream /tmp/wire \
      --replicas 2 --lags 0,4 --requests 32 --rate 8 --decode-budget 64

Every replica's params stay bit-identical to the trainer's post-step model
by applying the compressed wire records (core/stream.py); dense weights are
never pushed. The stream is a directory or ``tcp://host:port`` of a
``python -m repro_torch.launch.transport DIR --port P``; ``--processes``
runs each replica as its own worker process
(``repro_torch.launch.replica_worker``) with continuous sync during decode.

Everything runs on the CUDA card; ``--device cpu`` runs the kernels' plain
PyTorch versions on the CPU (use ``--smoke`` there in static mode). This
command serves in one process, as the reference's does; serving on
several ranks is ``Session.serve`` on a world that
``launch/multiproc.py`` joined (each rank its rows, shards and cache
slice).
"""
from __future__ import annotations

import argparse

from repro_torch.launch import spec as spec_lib


def _print_summary(out) -> None:
    line = (f"{len(out['requests'])} requests in {out['batches']} batches: "
            f"qps={out['qps']:.2f} p50={out['p50_ms']:.0f}ms "
            f"p99={out['p99_ms']:.0f}ms "
            f"staleness mean={out['staleness_mean']:.1f} "
            f"max={out['staleness_max']}")
    if out.get("short_requests"):
        line += (f" SHORT={out['short_requests']} "
                 f"(-{out['tokens_short']} tok)")
    if "restarts" in out:
        line += f" restarts={out['restarts']}"
    print(line, flush=True)


def _fleet_main(args) -> None:
    from repro_torch.launch import fleet as fleet_lib

    lags = [int(x) for x in args.lags.split(",")] if args.lags else None
    if args.processes:
        with fleet_lib.ProcessFleet(
                args.serve_stream, n_workers=args.replicas, lags=lags,
                decode_budget=args.decode_budget, max_batch=args.batch,
                prompt_len=args.prompt_len, device=args.device) as fl:
            print(f"fleet of {len(fl.workers)} worker PROCESSES on "
                  f"{args.serve_stream}: "
                  + ", ".join(f"{w.name}@{w.step}(lag {w.lag})"
                              for w in fl.workers), flush=True)
            reqs = fleet_lib.synthetic_requests(
                args.requests, rate=args.rate, prompt_len=args.prompt_len,
                max_new_tokens=args.max_new_tokens)
            out = fl.run(reqs)
        _print_summary(out)
        return

    fl = fleet_lib.Fleet(args.serve_stream, n_replicas=args.replicas,
                         lags=lags, decode_budget=args.decode_budget,
                         max_batch=args.batch, prompt_len=args.prompt_len,
                         device=args.device)
    fl.sync()
    head = fl.replicas[0].log.last_step()
    print(f"fleet of {len(fl.replicas)} replicas on {args.serve_stream} "
          f"(head step {head}): "
          + ", ".join(f"{r.name}@{r.step}(lag {r.lag})" for r in fl.replicas),
          flush=True)
    reqs = fleet_lib.synthetic_requests(
        args.requests, rate=args.rate, prompt_len=args.prompt_len,
        max_new_tokens=args.max_new_tokens,
        vocab_size=fl.replicas[0].session.cfg.vocab_size)
    out = fl.run(reqs, sync_every=args.sync_every)
    _print_summary(out)


def main(argv=None) -> None:
    ap = argparse.ArgumentParser("repro_torch.launch.serve")
    spec_lib.add_flags(ap)
    ap.add_argument("--batch", type=int, default=4,
                    help="static mode: serve batch; fleet mode: max batch "
                         "a scheduler admit")
    ap.add_argument("--prompt-len", type=int, default=128)
    ap.add_argument("--decode-steps", type=int, default=32)
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda; 'cpu' runs the plain "
                         "versions of the kernels)")
    # fleet mode
    ap.add_argument("--serve-stream", default=None, metavar="DIR|tcp://H:P",
                    help="subscribe a replica fleet to this wire stream — a "
                         "stream directory on a (shared) filesystem, or "
                         "tcp://host:port of a remote TailServer "
                         "(python -m repro_torch.launch.transport DIR "
                         "--port P); the spec comes from the stream's "
                         "bootstrap, not from flags")
    ap.add_argument("--replicas", type=int, default=2)
    ap.add_argument("--lags", default=None,
                    help="comma-separated per-replica lags, e.g. '0,4'")
    ap.add_argument("--requests", type=int, default=16)
    ap.add_argument("--rate", type=float, default=8.0,
                    help="request arrival rate (req/s); <=0 = all at t=0")
    ap.add_argument("--max-new-tokens", type=int, default=8)
    ap.add_argument("--decode-budget", type=int, default=64)
    ap.add_argument("--sync-every", type=int, default=1,
                    help="apply fresh wire records every N serving batches "
                         "(a replica; in-process fleet only)")
    ap.add_argument("--processes", action="store_true",
                    help="run each replica as its own worker PROCESS "
                         "(repro_torch.launch.replica_worker) tailing the "
                         "stream over the transport layer, with continuous "
                         "sync during decode")
    args = ap.parse_args(argv)

    if args.serve_stream:
        _fleet_main(args)
        return

    spec = spec_lib.from_args(args)
    from repro_torch.launch.session import Session
    sess = Session(spec, device=args.device)
    out = sess.serve(batch=args.batch, prompt_len=args.prompt_len,
                     decode_steps=args.decode_steps)

    B, S = args.batch, args.prompt_len
    print(f"prefill {B}×{S}: {out['prefill_s']:.2f}s "
          f"({out['prefill_tok_s']:.0f} tok/s)")
    print(f"decode {args.decode_steps} steps: {out['decode_s']:.2f}s "
          f"({out['decode_tok_s']:.1f} tok/s)")
    print("sample generations (token ids):")
    for row in out["tokens"][:2]:
        print("  ", row[:16], "...")


if __name__ == "__main__":
    main()
