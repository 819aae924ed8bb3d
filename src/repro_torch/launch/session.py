"""Session: the runtime facade over a RunSpec (counterpart of
src/repro/launch/session.py, training path).

    spec = RunSpec.from_json(open("results/specs/fused_quickstart.json").read())
    sess = Session(spec)              # on cuda; Session(spec, device="cpu")
    sess.train(3)

Training state (params, optimizer state, EF state) is built lazily on first
use: parameters from a CPU ``torch.Generator`` seeded with ``spec.seed``, then
the batch-0 per-client gradients initialize the EF state (Alg 1 line 2),
as in the reference. ``restore_from_jax`` replaces that state with a
checkpoint written by the JAX package.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Any, Dict, List, Optional

import torch

from repro_torch.checkpoint import bridge
from repro_torch.configs import base as cb
from repro_torch.core import distributed as dist
from repro_torch.core import ef as ef_lib
from repro_torch.data import pipeline as pipe_lib
from repro_torch.launch import build as build_lib
from repro_torch.launch.spec import RunSpec
from repro_torch.models import model as model_lib
from repro_torch.optim import optimizer as opt_lib


def resolve_device(device: Optional[str]) -> torch.device:
    """``None`` means cuda. Asking for cuda without a card raises: nothing
    moves to the CPU unless the caller says so."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("Session runs on cuda, and no CUDA device is "
                           "available; pass device='cpu' to run the plain "
                           "PyTorch versions of the kernels on the CPU")
    return dev


class Session:
    """Runtime facade over one RunSpec. ``dtype`` overrides the activation
    dtype of the arch config (the parity tests run both packages in f32)."""

    def __init__(self, spec: RunSpec, device: Optional[str] = None,
                 dtype: Optional[str] = None):
        self.spec = spec
        self.device = resolve_device(device)
        cfg = cb.get_smoke(spec.arch) if spec.smoke else cb.get(spec.arch)
        self.cfg = dataclasses.replace(cfg, dtype=dtype) if dtype else cfg
        self.step = 0                      # the data cursor: pipe.batch(step)
        self.history: List[Dict[str, float]] = []
        self._tr: Optional[Dict[str, Any]] = None

    @property
    def n_clients(self) -> int:
        return self.spec.clients

    def _ensure_train(self) -> Dict[str, Any]:
        if self._tr is not None:
            return self._tr
        spec, cfg, n = self.spec, self.cfg, self.n_clients
        efc = build_lib.ef_config(spec)
        opt = opt_lib.make(spec.optimizer, lr=spec.lr)
        pipe = pipe_lib.SyntheticTokens(pipe_lib.DataConfig(
            vocab_size=cfg.vocab_size, seq_len=spec.seq_len,
            global_batch=spec.global_batch, seed=spec.seed, dp_groups=n,
            heterogeneity=spec.heterogeneity))

        def loss_fn(p, b):
            return model_lib.train_loss(cfg, p, b)

        params = model_lib.init_params(
            cfg, torch.Generator().manual_seed(spec.seed), self.device)
        # Alg 1 line 2: v⁰ᵢ = g⁰ᵢ = the clients' gradients on batch 0
        _, g0 = dist.per_client_value_and_grad(
            loss_fn, params, pipe.batch(0, self.device), n)
        self._tr = {
            "pipe": pipe,
            "step_fn": dist.make_train_step(loss_fn, efc, opt, n),
            "params": params, "opt_state": opt.init(params),
            "ef_state": dist.init_ef_state(efc, params, n, init_grads=g0),
        }
        return self._tr

    @property
    def params(self) -> Dict[str, torch.Tensor]:
        return self._ensure_train()["params"]

    @property
    def ef_state(self) -> Dict[str, Any]:
        return self._ensure_train()["ef_state"]

    def batch_for(self, step: int) -> Dict[str, torch.Tensor]:
        return self._ensure_train()["pipe"].batch(step, self.device)

    def step_once(self) -> Dict[str, torch.Tensor]:
        """Advance exactly one training step; returns the step metrics."""
        tr = self._ensure_train()
        batch = self.batch_for(self.step)
        tr["params"], tr["opt_state"], tr["ef_state"], m = tr["step_fn"](
            tr["params"], tr["opt_state"], tr["ef_state"], batch, self.step)
        self.step += 1
        return m

    def train(self, steps: int, log_every: int = 10, verbose: bool = False
              ) -> List[Dict[str, float]]:
        """Train until the step counter reaches ``steps`` (absolute). Logs
        every ``log_every`` steps and the last one; returns the new entries."""
        self._ensure_train()
        new: List[Dict[str, float]] = []
        t0, start = time.time(), self.step
        while self.step < steps:
            m = self.step_once()
            step = self.step - 1
            if (log_every and step % log_every == 0) or step == steps - 1:
                rec = {"step": step, "loss": float(m["loss"]),
                       "g_norm": float(m["g_norm"])}
                self.history.append(rec)
                new.append(rec)
                if verbose:
                    print(f"step {step:5d} loss {rec['loss']:8.4f} "
                          f"g_norm {rec['g_norm']:.3e} "
                          f"({(time.time()-t0)/max(step-start+1,1):.2f}s/step)",
                          flush=True)
        return new

    def restore_from_jax(self, path: str) -> None:
        """Replace params and EF state with a checkpoint the JAX package
        wrote (``Session.save`` there), and take over its step counter. The
        checkpoint's trees must match this session's leaf for leaf."""
        tr = self._ensure_train()
        state, meta = bridge.load_jax_npz(path, self.device)
        for name in ("params", "ef_state"):
            _check_like(name, ef_lib.flatten(state[name]),
                        ef_lib.flatten(tr[name]))
        tr["params"], tr["ef_state"] = state["params"], state["ef_state"]
        self.step = int(meta["step"])


def _check_like(name: str, got: Dict[str, torch.Tensor],
                like: Dict[str, torch.Tensor]) -> None:
    if sorted(got) != sorted(like):
        raise ValueError(f"{name}: leaves {sorted(got)} != {sorted(like)}")
    for k in like:
        if got[k].shape != like[k].shape or got[k].dtype != like[k].dtype:
            raise ValueError(f"{name}/{k}: {tuple(got[k].shape)} "
                             f"{got[k].dtype} != {tuple(like[k].shape)} "
                             f"{like[k].dtype}")
