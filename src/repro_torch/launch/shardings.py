"""Which rank holds which slice of the training state (counterpart of
src/repro/launch/shardings.py, without PartitionSpecs).

EF state layout knobs (the reference's DESIGN.md §4):
  client_granularity: 'group': one EF client per data-parallel group
                      (n = dp, the paper's setting); 'pod': one client a
                      pod (refused: it arrives with ZeRO, ROADMAP Queue 1)
  state_sharding:     'client': a client's (vᵢ, gᵢ) live on its own rank
                      whole (the ``model`` axis is 1 in this slice);
                      'zero' (refused, with the same slice)

In the port's layout a rank holds its own client's ``clients`` leaves with
a leading axis of 1, the server estimate, h, the params and the optimizer
state replicated, and with hops its pod's ``pods`` slot (leading axis 1).
:func:`local_state` cuts that slice out of the single-device layout (n
clients, ``pods`` slots on a leading axis) and :func:`global_state` puts
the slices back together, leaf by leaf, on the first rank: a checkpoint
of a sharded run has the keys, shapes and spec hash a single-device run
gives it.
"""
from __future__ import annotations

import dataclasses
import hashlib
from typing import Any, Dict, Optional

import torch

from repro_torch.core import comm


@dataclasses.dataclass(frozen=True)
class ShardPlan:
    client_granularity: str = "group"       # 'group' | 'pod'
    state_sharding: str = "client"          # 'client' | 'zero'
    ef_state_dtype: Optional[str] = None    # None → param dtype


def local_state(ef_state: Dict[str, Any], client: int, pods: int,
                n: int) -> Dict[str, Any]:
    """The slice of a single-device ``ef_state`` (n clients) that the rank
    of ``client`` holds: its clients' leaves (leading axis 1) and, with
    ``pods`` slots, its pod's (pod-major: client // (n/pods))."""
    out = dict(ef_state)
    out["clients"] = {name: {k: x[client:client + 1] for k, x in t.items()}
                      for name, t in ef_state["clients"].items()}
    if "pods" in ef_state:
        p = client // (n // pods)
        out["pods"] = {name: {k: x[p:p + 1] for k, x in t.items()}
                       for name, t in ef_state["pods"].items()}
    return out


def global_state(ef_state: Dict[str, Any], axes: comm.Axes, pods: int
                 ) -> Optional[Dict[str, Any]]:
    """The single-device layout of a sharded ``ef_state``, gathered to the
    first rank of ``axes`` on the CPU, leaf by leaf (None elsewhere): the
    clients' leaves on a leading axis of n, the pods' slots on one of
    ``pods`` (each pod's slot taken from its first client)."""
    first = axes.index == 0
    out: Dict[str, Any] = {}
    for part, tree in ef_state.items():
        if part not in ("clients", "pods"):
            out[part] = tree
            continue
        got = {}
        for name, leaves in tree.items():
            got[name] = {}
            for k, x in leaves.items():
                full = comm.gather_to_first(axes, x[0])
                if first:
                    if part == "pods":
                        full = full[::axes.size // pods]
                    got[name][k] = full
        out[part] = got
    return out if first else None


def replicated_digest(params: Dict[str, torch.Tensor],
                      ef_state: Dict[str, Any]) -> str:
    """A digest of what every rank must hold bit for bit: the params, the
    server estimate and h. Each leaf's bit patterns are summed on its
    device, plain and weighted by position (so a moved or changed bit
    shows), and the sums are hashed."""
    from repro_torch.core.ef import flatten
    tree = {"params": params, "server": ef_state["server"]}
    if "h" in ef_state:
        tree["h"] = ef_state["h"]
    h = hashlib.sha256()
    for key, t in flatten(tree).items():
        bits = t.detach().reshape(-1).view(
            torch.int16 if t.element_size() == 2 else torch.int32).long()
        weight = torch.arange(bits.numel(), device=bits.device) % 65521 + 1
        h.update(f"{key}:{int(bits.sum())}:{int((bits * weight).sum())};"
                 .encode())
    return h.hexdigest()


def to_device(tree: Dict[str, Any], device) -> Dict[str, Any]:
    """A nested dict of tensors moved to ``device``."""
    if isinstance(tree, dict):
        return {k: to_device(v, device) for k, v in tree.items()}
    return tree.to(device) if isinstance(tree, torch.Tensor) else tree
