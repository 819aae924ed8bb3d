"""Serving command line — flags → RunSpec → Session (counterpart of the static
mode of src/repro/launch/serve.py):

  PYTHONPATH=src python -m repro_torch.launch.serve --arch smollm-360m \
      --batch 8 --prompt-len 1024 --decode-steps 32

Runs batched prefill (the hand flash-attention kernel K7) and greedy decode
on the CUDA card from fresh weights; ``--device cpu`` runs the kernels'
plain PyTorch versions on the CPU (use ``--smoke`` there). Prints what the
reference prints. The reference's fleet mode (``--serve-stream`` and its
flags) is refused: the wire stream and the serving fleet are not ported.
"""
from __future__ import annotations

import argparse

from repro_torch.launch import spec as spec_lib

# the reference's fleet-mode flags, refused by name
FLEET_FLAGS = ("serve_stream", "replicas", "lags", "requests", "rate",
               "max_new_tokens", "decode_budget", "sync_every", "processes")


def main(argv=None) -> None:
    ap = argparse.ArgumentParser("repro_torch.launch.serve")
    spec_lib.add_flags(ap)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=128)
    ap.add_argument("--decode-steps", type=int, default=32)
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda; 'cpu' runs the plain "
                         "versions of the kernels)")
    for name in FLEET_FLAGS:
        flag = "--" + name.replace("_", "-")
        if name == "processes":
            ap.add_argument(flag, action="store_true", help=argparse.SUPPRESS)
        else:
            ap.add_argument(flag, default=None, help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    given = [f"--{n.replace('_', '-')}" for n in FLEET_FLAGS
             if getattr(args, n) not in (None, False)]
    if given:
        ap.error(f"{', '.join(given)}: fleet mode serves from a wire stream, "
                 "which arrives with the slice that ports core/stream.py and "
                 "launch/fleet.py (ROADMAP Queue 1 item 11); this port serves "
                 "statically only")
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
