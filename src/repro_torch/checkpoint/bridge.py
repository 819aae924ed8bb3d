"""Weights across from the JAX package as they are in memory: a pytree of
numpy arrays (``jax.device_get`` of the reference's params) becomes the
port's flat dict of tensors keyed by ``/``-joined leaf paths, so both
packages compute from the same numbers. A tree padded for the 'model' axis
(``tp_pad_heads``: the attention leaves at ``cfg.eff_heads``) crosses as
it is, and a tree of one rank's shards is joined first
(``launch/shardings.py::unshard_tree``). A checkpoint file of either package
is read by checkpoint/checkpoint.py (``restore``, ``Session.restore_from``)
instead. Imports nothing of the JAX package.
"""
from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch

from repro_torch.core import ef as ef_lib


def params_from_jax(tree: Dict[str, Any], device="cpu") -> Dict[str,
                                                                torch.Tensor]:
    """A nested dict (the reference's pytree, as numpy arrays) or a flat dict
    of ``/``-joined paths → the port's flat dict of tensors, sorted by path.
    Values are copied, never shared with the numpy arrays."""
    flat = ef_lib.flatten(tree)
    return {k: torch.tensor(np.asarray(v), device=device)
            for k, v in flat.items()}
