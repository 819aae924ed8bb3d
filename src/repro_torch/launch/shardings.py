"""Which rank holds which slice of the training state (counterpart of
src/repro/launch/shardings.py, without PartitionSpecs).

EF state layout knobs (the reference's DESIGN.md §4):
  client_granularity: 'group': one EF client per data-parallel group
                      (n = dp, the paper's setting); 'pod': one client a
                      pod (n = #pods, one client on a mesh without a pod
                      axis), its rows split over the pod's data ranks
                      (``Mesh.split_axes``), each rank holding the client's
                      whole state (replicated over 'data', as the
                      reference's shard_map holds it)
  state_sharding:     'client': a client's (vᵢ, gᵢ) live on its own
                      ranks, split over 'model' as the params are;
                      'zero': the reference's rule (:func:`zero_upgrade`)
                      also splits a leaf over the data axes that are not
                      client axes. Where that adds no split (every 'group'
                      run, a 'pod' run with one data rank a pod) the run is
                      the 'client' run; where it would, the reference's
                      round fails (its state leaves are 1/data of their
                      gradients), and the port refuses the training state
                      (:func:`zero_refusal`)

In the port's layout a rank holds its own client's ``clients`` leaves with
a leading axis of 1, the server estimate, h, the params and the optimizer
state replicated over the client axes, and with hops its pod's ``pods``
slot (leading axis 1). :func:`local_state` cuts that slice out of the
single-device layout (n clients, ``pods`` slots on a leading axis) and
:func:`global_state` puts the slices back together, leaf by leaf, on the
first rank: a checkpoint of a sharded run has the keys, shapes and spec
hash a single-device run gives it.

Over the 'model' axis every leaf of every tree (params, optimizer state,
each client's v and g, the server estimate, h, the pods' memories) is
split as its parameter is (``params_pspecs``, the reference's
PartitionSpecs as tuples): rank m of the axis holds the m-th contiguous
block of the split dim, made contiguous (:func:`shard_leaf`), and the
EF round compresses that shard as a leaf of its own, as the reference's
shard_map does. :func:`shard_tree` and :func:`unshard_tree` map a state
tree between the two layouts, a leaf at a time.

Serving (the reference's ``batch_pspecs`` and ``cache_pspecs``): the
prompt rows split over the data axes where B divides them
(:func:`serve_rows`, :func:`local_rows`, :func:`gather_rows`), each
rank's cache its rows, its slice of the 'model' axis and, where the kv
heads do not split over 'model' (or the rows over the data axes), its
block of the sequence (:func:`cache_pspecs`, :func:`seq_axes`; the block
``models/layers.py::slot_range``); :func:`serve_refusal` names what
serving refuses.
"""
from __future__ import annotations

import dataclasses
import hashlib
from typing import Any, Dict, Optional, Tuple

import torch

from repro_torch.core import comm
from repro_torch.models import model as model_lib
from repro_torch.models.model import Spec


@dataclasses.dataclass(frozen=True)
class ShardPlan:
    client_granularity: str = "group"       # 'group' | 'pod'
    state_sharding: str = "client"          # 'client' | 'zero'
    ef_state_dtype: Optional[str] = None    # None → param dtype


def zero_upgrade(spec: Spec, free: Tuple[str, ...], shape, mesh) -> Spec:
    """The reference's ``_zero_upgrade``: the first 'model'-split dim whose
    size the product of 'model' and the ``free`` data axes divides also
    splits over those axes (an entry ``(*free, 'model')``); the spec as it
    is when none does."""
    total = mesh.shape.get("model", 1)
    for a in free:
        total *= mesh.shape[a]
    parts = list(spec)
    for i, s in enumerate(parts):
        if s == "model":
            if i >= len(shape) or shape[i] % total:
                continue
            parts[i] = (*free, "model")
            return tuple(parts)
    return tuple(spec)


def zero_splits(cfg, mesh, plan: ShardPlan) -> Dict[str, Spec]:
    """The parameters whose client state ``state_sharding='zero'`` splits
    over data ranks beyond their gradients' split (the reference's
    ``ef_state_pspecs`` leaf rule against its gradient specs), with the
    upgraded spec: empty unless the plan is 'zero' and the free data axes
    (``Mesh.split_axes``) hold more than one rank."""
    free = mesh.split_axes(mesh.client_axes(plan.client_granularity))
    size = 1
    for a in free:
        size *= mesh.shape[a]
    if plan.state_sharding != "zero" or size == 1:
        return {}
    shapes = model_lib.init_params(cfg, None, "meta")
    out = {}
    for name, spec in params_pspecs(cfg, mesh).items():
        up = zero_upgrade(spec, free, tuple(shapes[name].shape), mesh)
        if up != tuple(spec):
            out[name] = up
    return out


def zero_refusal(cfg, mesh, plan: ShardPlan) -> Optional[str]:
    """Why this run's ZeRO training state cannot be built, or None. The
    reference splits these leaves' client state over the free data axes
    while their gradients stay whole over them, and its shard_map round
    then adds a leaf to a gradient of another shape (``TypeError: add got
    incompatible shapes for broadcasting``): the port mirrors that by
    refusing (ROADMAP Queue 3, standing facts: the reference's pod + zero
    fault)."""
    splits = zero_splits(cfg, mesh, plan)
    if not splits:
        return None
    name, spec = next(iter(splits.items()))
    free = mesh.split_axes(mesh.client_axes(plan.client_granularity))
    return (f"state_sharding='zero' with client_granularity="
            f"{plan.client_granularity!r} on mesh {dict(mesh.shape)} would "
            f"split {len(splits)} client-state leaves over the data axes "
            f"{free} beyond their gradients (e.g. {name}: {spec}); the "
            "reference's round fails "
            "there with 'TypeError: add got incompatible shapes for "
            "broadcasting', and the port refuses it (ROADMAP Queue 3, "
            "standing facts: the reference's pod + zero fault). It runs "
            "where a pod has one data rank, or with "
            "state_sharding='client'")


def serve_refusal(cfg) -> Optional[str]:
    """Why ``Session.serve`` refuses this config, or None. Head padding
    that MHA-expands the kv heads (``cfg.eff_heads``) is a training layout:
    the reference's ``init_cache`` keeps ``num_kv_heads`` while its padded
    pass writes the expanded heads, and its serve fails on every mesh. The
    port refuses it by name, on one rank and on many (ROADMAP Queue 3,
    standing facts); padding that expands nothing serves as the unpadded
    config does."""
    H, KV = cfg.num_heads, cfg.num_kv_heads
    if cfg.eff_heads == (H, KV):
        return None
    he, kve = cfg.eff_heads
    return (f"serving {cfg.name} with tp_pad_heads={cfg.tp_pad_heads} is "
            f"refused: the padding expands its {H} q / {KV} kv heads to "
            f"{he} / {kve}, and the reference's serve fails there with "
            "'TypeError: dynamic_update_slice update shape ... for operand "
            "shape ...' (its init_cache keeps num_kv_heads while the padded "
            "pass writes the expanded heads; ROADMAP Queue 3, standing "
            "facts). Serve the spec with tp_pad_heads=0")


def serve_rows(mesh, global_batch: int) -> Optional[comm.Axes]:
    """Where serving's prompt rows go (the reference's ``batch_pspecs``):
    over the mesh's data axes ('pod' and 'data', whatever the client
    granularity) when ``global_batch`` divides their size, rank ``index``
    of the group serving the contiguous block ``index`` of the rows. None
    when it does not (every data rank serves every row, as the
    reference's ``b_ax = None``) or the group is this rank alone."""
    axes = mesh.axes(mesh.client_axes("group"))
    if axes.size == 1 or global_batch % axes.size:
        return None
    return axes


def local_rows(x: torch.Tensor, rows: Optional[comm.Axes]) -> torch.Tensor:
    """This rank's block of x's leading (row) dim under ``serve_rows``."""
    if rows is None:
        return x
    n = x.shape[0] // rows.size
    return x[rows.index * n:(rows.index + 1) * n]


def gather_rows(rows: Optional[comm.Axes], x: torch.Tensor) -> torch.Tensor:
    """The global rows, every rank's block in rank order, on every rank."""
    if rows is None:
        return x
    return comm.all_gather(rows, x.contiguous()).flatten(0, 1)


def cache_pspecs(cfg, mesh, global_batch: int) -> Dict[str, Spec]:
    """Each serving cache leaf's split, the reference's ``cache_pspecs``
    as tuples. The rows split over the data axes where ``global_batch``
    divides them; the kv heads over 'model' where ``num_kv_heads`` divides
    it. Where the kv heads do not split, the sequence splits over 'model';
    where the rows do not split, it splits over the data axes and 'model'
    (the data axes alone when the kv heads split). An SSM state splits its
    d_inner (Mamba2: its heads) over 'model', a conv state its last dim.
    The port's hybrid conv state splits that dim in another order (this
    rank's d_inner columns, then B and C's 2N whole: ``ssm.mamba2_apply``'s
    split), so its slice holds d_inner/n + 2N columns where the
    reference's holds (d_inner + 2N)/n."""
    d_ax = mesh.client_axes("group")
    tp = mesh.shape.get("model", 1)
    dp = 1
    for a in d_ax:
        dp *= mesh.shape[a]
    b_ok = global_batch % dp == 0
    # a PartitionSpec entry: one axis by its name, several as a tuple
    d_ent = d_ax[0] if len(d_ax) == 1 else d_ax
    b = d_ent if b_ok else None
    kv = "model" if cfg.num_kv_heads and cfg.num_kv_heads % tp == 0 \
        else None
    if b_ok:
        s = None if kv else "model"
    else:
        s = (*d_ax, "model") if not kv else d_ent
    attn = (None, b, s, kv, None)
    di = "model" if cfg.d_inner % tp == 0 else None
    if cfg.family == "ssm":
        return {"ssm": (None, b, di, None), "conv": (None, b, None, di)}
    if cfg.family == "hybrid":
        nh = cfg.d_inner // cfg.ssm_head_dim
        conv_d = cfg.d_inner + 2 * cfg.ssm_state
        return {"ssm": (None, b, "model" if nh % tp == 0 else None, None,
                        None),
                "conv": (None, b, None, "model" if conv_d % tp == 0
                         else None),
                "k_attn": attn, "v_attn": attn}
    if cfg.local_global:
        return {k: attn for k in ("k_local", "v_local", "k_global",
                                  "v_global")}
    return {"k": attn, "v": attn}


def seq_axes(cfg, mesh, global_batch: int) -> Optional[comm.Axes]:
    """The axes a serving cache's sequence splits over
    (:func:`cache_pspecs`), resolved for this rank, or None where the
    slots stay whole on every rank (no attention cache, a group of one)."""
    specs = cache_pspecs(cfg, mesh, global_batch)
    key = next((k for k in ("k", "k_local", "k_attn") if k in specs), None)
    if key is None or specs[key][2] is None:
        return None
    s = specs[key][2]
    axes = mesh.axes((s,) if isinstance(s, str) else tuple(s))
    return axes if axes.size > 1 else None


def params_pspecs(cfg, mesh) -> Dict[str, Spec]:
    """The params' split over the mesh's 'model' axis."""
    return model_lib.param_pspecs(cfg, tp=mesh.shape.get("model", 1))


def split_dim(spec: Spec) -> Optional[int]:
    """The dim ``spec`` splits over 'model', or None when replicated."""
    return spec.index("model") if "model" in spec else None


def leaf_spec(path: str, x: torch.Tensor, pspecs: Dict[str, Spec]) -> Spec:
    """The spec of a state leaf at ``path`` (``…/<param name>``): its
    parameter's, after the leaf's leading axes (a client's or pod's slot);
    a leaf of no parameter (a step count) is replicated."""
    for name, spec in pspecs.items():
        if path == name or path.endswith("/" + name):
            return (None,) * (x.dim() - len(spec)) + tuple(spec)
    return (None,) * x.dim()


def shard_leaf(x: torch.Tensor, spec: Spec, index: int, size: int
               ) -> torch.Tensor:
    """Block ``index`` of ``size`` of x's split dim, as a tensor of its own
    (contiguous, sharing no storage with x); x itself when replicated."""
    dim = split_dim(spec)
    if dim is None or size == 1:
        return x
    n = x.shape[dim]
    if n % size:
        raise ValueError(f"dim {dim} of {tuple(x.shape)} does not split "
                         f"over {size} ranks")
    b = n // size
    return x.narrow(dim, index * b, b).clone(
        memory_format=torch.contiguous_format)


def unshard_leaf(parts, spec: Spec) -> torch.Tensor:
    """The whole leaf from its blocks in rank order."""
    return torch.cat(list(parts), dim=split_dim(spec))


def _map_paths(fn, tree, prefix=""):
    if isinstance(tree, dict):
        return {k: _map_paths(fn, v, f"{prefix}/{k}" if prefix else k)
                for k, v in tree.items()}
    return fn(prefix, tree) if isinstance(tree, torch.Tensor) else tree


def shard_tree(tree: Dict[str, Any], pspecs: Dict[str, Spec],
               axes: comm.Axes) -> Dict[str, Any]:
    """This rank's blocks of every leaf of ``tree`` (any nested state
    tree whose leaf paths end in parameter names) over the 'model' axis
    ``axes``."""
    return _map_paths(lambda p, x: shard_leaf(
        x, leaf_spec(p, x, pspecs), axes.index, axes.size), tree)


def unshard_tree(tree: Dict[str, Any], pspecs: Dict[str, Spec],
                 axes: comm.Axes) -> Optional[Dict[str, Any]]:
    """The whole leaves of a tree of this rank's blocks, gathered leaf by
    leaf to the first rank of the 'model' axis ``axes`` on the CPU (None
    elsewhere); a replicated leaf is the first rank's own."""
    first = axes.index == 0

    def one(path, x):
        spec = leaf_spec(path, x, pspecs)
        if split_dim(spec) is None or axes.size == 1:
            return x.detach().cpu() if first else None
        parts = comm.gather_to_first(axes, x)
        return unshard_leaf(parts.unbind(0), spec) if first else None
    out = _map_paths(one, tree)
    return out if first else None


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
    """A digest of what every rank of one 'model' coordinate must hold bit
    for bit: the params, the server estimate and h (the ranks of another
    coordinate hold other shards). Each leaf's bit patterns are summed on its
    device, plain and weighted by position (so a moved or changed bit
    shows), and the sums are hashed."""
    tree = {"params": params, "server": ef_state["server"]}
    if "h" in ef_state:
        tree["h"] = ef_state["h"]
    return tree_digest(tree)


def tree_digest(tree: Dict[str, Any]) -> str:
    """:func:`replicated_digest`'s hash of any nested tree of tensors (a
    pod client's state, equal on the pod's data ranks)."""
    from repro_torch.core.ef import flatten
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
