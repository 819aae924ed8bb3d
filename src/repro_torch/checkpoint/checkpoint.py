"""npz checkpoints with step metadata and atomic writes (counterpart of
src/repro/checkpoint/checkpoint.py, in the same layout, so each package
restores the other's checkpoints).

Layout: one npz entry per tree leaf under its ``/``-joined path
(``params/layers/attn/wq``, ``opt_state/m/embed``,
``ef_state/clients/v/embed``, …); bfloat16 leaves are stored as float32 and
cast back on restore (lossless); ``__meta__`` holds JSON with ``step`` and,
when a RunSpec is given, ``spec`` and ``spec_hash``. A save writes a
``*.tmp.npz`` file beside the target and renames it into place, and
``latest`` never picks such a partial.

A full-width training state is tens of GB, so ``save`` streams it leaf by
leaf from the device into the zip archive and ``restore`` reads it back leaf
by leaf: the host holds one leaf at a time, never a second copy of the
state.
"""
from __future__ import annotations

import json
import os
import re
import tempfile
import zipfile
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

from repro_torch.core import ef as ef_lib

META = "__meta__"


def _host_array(t: torch.Tensor) -> np.ndarray:
    """One leaf on the host as numpy; bfloat16 (which numpy lacks) as f32."""
    t = t.detach()
    if t.dtype == torch.bfloat16:
        t = t.float()
    return t.cpu().numpy()


def _write(zf: zipfile.ZipFile, name: str, arr: np.ndarray) -> None:
    # what np.savez writes for each entry: an .npy member, stored uncompressed
    with zf.open(name + ".npy", "w", force_zip64=True) as f:
        np.lib.format.write_array(f, np.asarray(arr), allow_pickle=False)


def save(path: str, tree: Dict[str, Any], step: int = 0,
         meta: Optional[dict] = None, spec: Optional[Any] = None) -> None:
    """Write ``tree`` (nested dicts of tensors) to ``path``. ``spec`` (a
    RunSpec) is embedded in ``__meta__`` with its hash, so a checkpoint
    names the experiment that wrote it: ``Session.resume`` rebuilds the run
    from it and ``Session.restore_from`` refuses a checkpoint of another."""
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    if spec is not None:
        meta = dict(meta or {})
        meta.setdefault("spec", spec.to_dict())
        meta.setdefault("spec_hash", spec.spec_hash())
    fd, tmp = tempfile.mkstemp(dir=os.path.dirname(path) or ".",
                               suffix=".tmp.npz")
    os.close(fd)
    try:
        with zipfile.ZipFile(tmp, "w", zipfile.ZIP_STORED,
                             allowZip64=True) as zf:
            for key, leaf in ef_lib.flatten(tree).items():
                _write(zf, key, _host_array(leaf))
            _write(zf, META, np.frombuffer(
                json.dumps({"step": step, **(meta or {})}).encode(),
                dtype=np.uint8))
        os.replace(tmp, path)
    except BaseException:
        os.unlink(tmp)
        raise


def _fill(like: Any, key: str, z, device) -> Any:
    if isinstance(like, dict):
        return {k: _fill(v, f"{key}/{k}" if key else str(k), z, device)
                for k, v in like.items()}
    arr = z[key]
    if tuple(arr.shape) != tuple(like.shape):
        raise ValueError(f"{key}: shape {tuple(arr.shape)} != "
                         f"{tuple(like.shape)}")
    dev = like.device if device is None else device
    return torch.from_numpy(arr).to(device=dev, dtype=like.dtype)


def restore(path: str, like: Dict[str, Any], device=None
            ) -> Tuple[Dict[str, Any], dict]:
    """Read ``path`` into the structure of ``like`` (nested dicts of
    tensors; shapes checked, each leaf cast to its ``like`` dtype). Leaves
    land on ``device``, or on their ``like`` leaf's device; ``like`` may
    live on the meta device, a template that costs no memory. Returns
    (tree, meta)."""
    with np.load(path) as z:
        meta = json.loads(bytes(z[META]).decode())
        return _fill(like, "", z, device), meta


def read_meta(path: str) -> dict:
    """The ``__meta__`` dict alone, without reading any leaf."""
    with np.load(path) as z:
        return json.loads(bytes(z[META]).decode())


def parse_step(filename: str) -> Optional[int]:
    """The step in a checkpoint's file name: the LAST run of digits in its
    stem (``run2/step_100.npz`` → 100), or None for a name without one."""
    stem = os.path.splitext(os.path.basename(filename))[0]
    groups = re.findall(r"\d+", stem)
    return int(groups[-1]) if groups else None


def latest(ckpt_dir: str) -> Optional[str]:
    """The newest checkpoint in ``ckpt_dir`` by PARSED step (step_10 after
    step_2, whatever the zero padding); names without a step come first,
    in name order. A ``*.tmp.npz`` partial of an interrupted save is never
    picked."""
    if not os.path.isdir(ckpt_dir):
        return None
    cands = [f for f in os.listdir(ckpt_dir)
             if f.endswith(".npz") and not f.endswith(".tmp.npz")]
    if not cands:
        return None
    best = max(cands, key=lambda f: (parse_step(f) is not None,
                                     parse_step(f) or 0, f))
    return os.path.join(ckpt_dir, best)
