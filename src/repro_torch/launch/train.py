"""Training driver — flags → RunSpec → Session (counterpart of
src/repro/launch/train.py):

  PYTHONPATH=src python -m repro_torch.launch.train \
      --spec results/specs/fused_quickstart.json \
      --carrier fused_quant8 --downlink-carrier fused_quant4 --steps 3

Runs on the CUDA card; ``--device cpu`` runs the kernels' plain PyTorch
versions on the CPU (use ``--smoke`` there). Prints the reference CLI's
``step N loss … g_norm …`` lines.
"""
from __future__ import annotations

import argparse

from repro_torch.launch import spec as spec_lib


def main(argv=None) -> None:
    ap = argparse.ArgumentParser("repro_torch.launch.train")
    spec_lib.add_flags(ap)
    ap.add_argument("--steps", type=int, default=200,
                    help="train until this ABSOLUTE step count")
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda; 'cpu' runs the plain "
                         "versions of the kernels)")
    args = ap.parse_args(argv)
    spec = spec_lib.from_args(args)

    from repro_torch.launch.session import Session
    sess = Session(spec, device=args.device)
    print(f"carrier={spec.carrier} downlink={spec.downlink_carrier} "
          f"device={sess.device}", flush=True)
    sess.train(args.steps, log_every=args.log_every, verbose=True)


if __name__ == "__main__":
    main()
