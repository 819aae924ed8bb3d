"""Weights across from the JAX package: read its npz checkpoints
(src/repro/checkpoint/checkpoint.py) into the port's tensors, so both
packages compute from the same numbers.

The reference writes one npz entry per pytree leaf under its ``/``-joined
path ("params/layers/attn/wq", "ef_state/clients/v/embed", …) plus a
``__meta__`` entry holding JSON (the step, the RunSpec). bfloat16 leaves are
stored as float32. This module only reads that layout; it imports nothing
of the JAX package.
"""
from __future__ import annotations

import json
from typing import Any, Dict, Tuple

import numpy as np
import torch

from repro_torch.core import ef as ef_lib

Tree = Dict[str, torch.Tensor]


def params_from_jax(tree: Dict[str, Any], device="cpu") -> Tree:
    """A nested dict (the reference's pytree, as numpy arrays) or a flat dict
    of ``/``-joined paths → the port's flat dict of tensors, sorted by path.
    Values are copied, never shared with the numpy arrays."""
    flat = ef_lib.flatten(tree)
    return {k: torch.tensor(np.asarray(v), device=device) for k, v in flat.items()}


def _subtree(flat: Dict[str, np.ndarray], prefix: str) -> Dict[str, np.ndarray]:
    p = prefix + "/"
    return {k[len(p):]: v for k, v in flat.items() if k.startswith(p)}


def load_jax_npz(path: str, device="cpu") -> Tuple[Dict[str, Any], dict]:
    """Read a reference checkpoint. Returns (state, meta) where state holds
    ``params`` (flat tree) and ``ef_state`` ({"clients": {"v", "g"},
    "server", and "h" when the run had a downlink}), all on ``device``."""
    with np.load(path) as z:
        flat = {k: z[k] for k in z.files if k != "__meta__"}
        meta = json.loads(bytes(z["__meta__"]).decode())
    ef_flat = _subtree(flat, "ef_state")
    clients = _subtree(ef_flat, "clients")
    ef_state = {
        "clients": {name: params_from_jax(_subtree(clients, name), device)
                    for name in sorted({k.split("/")[0] for k in clients})},
        "server": params_from_jax(_subtree(ef_flat, "server"), device),
    }
    if any(k.startswith("h/") for k in ef_flat):
        ef_state["h"] = params_from_jax(_subtree(ef_flat, "h"), device)
    state = {"params": params_from_jax(_subtree(flat, "params"), device),
             "ef_state": ef_state}
    return state, meta
