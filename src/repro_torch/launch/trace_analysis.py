"""What one traced step costs one rank (counterpart of
src/repro/launch/hlo_analysis.py, which reads the same figures from the
optimized HLO of a compiled step).

:func:`analyze` runs ``fn(*args)`` once on META tensors: every operation
computes shapes and dtypes only, the hand kernels take their traced branch
(kernels/ops.py: the card's checks and output allocations, the launch
counted, nothing run) and the collectives go to whatever process group the
mesh spans (launch/dryrun.py builds a world of the production mesh's size
on PyTorch's ``fake`` backend, whose collectives return at once). It
reports for this rank:

  * ``flops``: the dot and convolution FLOPs
    (``torch.utils.flop_counter.FlopCounterMode``: mm, bmm, addmm, baddbmm,
    convolutions, 2 FLOPs a multiply-add), plus each traced K7 launch's two
    products over the causal blocks it computes (``ops.traced_flops``);
  * ``collectives``/``collective_counts``: operand bytes and calls by kind
    (core/comm.py ``KINDS``: all-reduce, all-gather, collective-permute),
    ``collective_bytes`` their sum, ``collective_groups`` each kind's
    calls by group (its mesh axes);
  * ``kernel_launches``: the hand kernels' traced launches by name
    (``ops.traced_launches``; ``ops.launches`` counts the card's alone);
  * ``memory``: ``argument_bytes`` (the distinct storages of the arguments:
    the state and inputs this rank holds), ``output_bytes`` (the outputs'
    storages that are not arguments'), ``alias_bytes`` (the outputs' that
    ARE arguments': state written in place) and ``temp_bytes`` (the peak,
    over the call, of the storages it allocated and still held: what the
    caching allocator must find above the arguments, outputs under
    construction included). Storages are counted, not tensors: a view
    costs nothing, and a storage is freed when its last holder goes (the
    recompute of models/remat.py frees its detached inputs, and the trace
    sees it).

How the figures differ from the reference analyzer's. XLA's HLO holds each
while-loop body once, and its analyzer multiplies bodies by their trip
counts; a trace runs every loop iteration, so nothing is multiplied here.
Both leave elementwise work out. The reference's attention is chunked dots
over every key, masked; the port's prefill runs K7, which computes the
causal blocks only, so a prefill's attention FLOPs are about half the
reference's. The reference's all-gather and reduce-scatter bytes are
derived from output shapes and group sizes; here they are the operands
handed in. XLA's ``temp_size`` is its buffer assignment's scratch, which
may reuse and rematerialize; here ``temp_bytes`` is the eager peak of
this call as PyTorch runs it, in program order, with no reuse beyond what
freeing gives.
"""
from __future__ import annotations

import weakref
from typing import Any, Callable, Dict, Iterable, Tuple

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves

from repro_torch.core import comm
from repro_torch.kernels import ops


def _key(t: torch.Tensor) -> int:
    return t.untyped_storage()._cdata


def storage_bytes(tree) -> int:
    """The bytes of the distinct storages of a tree's tensors."""
    return sum(_storages(tree).values())


def _storages(tree) -> Dict[int, int]:
    """{storage key: bytes} of the distinct storages of a tree's tensors."""
    out: Dict[int, int] = {}
    for t in tree_leaves(tree):
        if isinstance(t, torch.Tensor):
            out[_key(t)] = t.untyped_storage().nbytes()
    return out


class StorageTracker(TorchDispatchMode):
    """The live bytes of the storages that the operations under it
    allocate, and their peak. An output whose storage is one of its
    operation's inputs' (a view, an in-place write) allocates nothing; a
    storage counts until its last holder frees it (a weak reference to the
    storage fires then)."""

    def __init__(self):
        super().__init__()
        self.live: Dict[int, int] = {}
        self.current = 0
        self.peak = 0

    def _free(self, key: int) -> None:
        self.current -= self.live.pop(key, 0)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        seen = {_key(t) for t in tree_leaves((args, kwargs))
                if isinstance(t, torch.Tensor)}
        for t in tree_leaves(out):
            if not isinstance(t, torch.Tensor):
                continue
            st = t.untyped_storage()
            key = st._cdata
            if key in seen or key in self.live:
                continue
            self.live[key] = st.nbytes()
            self.current += st.nbytes()
            self.peak = max(self.peak, self.current)
            weakref.finalize(st, self._free, key)
        return out


def leaf_bytes(tree, prefix: str = "") -> Dict[str, Tuple[tuple, str, int]]:
    """{'/'-joined path: (shape, dtype, bytes)} of a nested dict of
    tensors (the checkpoint's leaf paths)."""
    out: Dict[str, Tuple[tuple, str, int]] = {}
    if isinstance(tree, dict):
        for k, v in tree.items():
            out.update(leaf_bytes(v, f"{prefix}/{k}" if prefix else str(k)))
    elif isinstance(tree, torch.Tensor):
        out[prefix] = (tuple(tree.shape), str(tree.dtype).replace(
            "torch.", ""), tree.numel() * tree.element_size())
    return out


def analyze(fn: Callable, args: Dict[str, Any], n_devices: int,
            order: Iterable[str]) -> Dict[str, Any]:
    """Trace ``fn(*(args[name] for name in order))`` once on this rank and
    return its figures (module doc), with ``arguments``: each argument
    group's bytes and ``leaves``: each argument leaf's (shape, dtype,
    bytes) under ``group/path``, both taken before the call (a step may
    replace the leaves of a state dict it is given). The counters of
    core/comm.py are read for this call alone and put back after it;
    kernels/ops.py's traced counters are zeroed before it."""
    from torch.utils.flop_counter import FlopCounterMode
    kinds = {k: dict(v, groups=dict(v["groups"]))
             for k, v in comm.KINDS.items()}
    stats = dict(comm.STATS)
    comm.reset_stats()
    ops.reset_traced()
    try:
        call = [args[name] for name in order]
        arg_st = _storages(call)
        arguments = {name: storage_bytes(args[name]) for name in order}
        leaves = {f"{name}/{p}" if p else name: v for name in order
                  for p, v in leaf_bytes(args[name]).items()}
        # the arguments' storages held through the call: a step that
        # replaces a state leaf in its dict frees the old one, and a new
        # storage must not take its key
        held = [t.untyped_storage() for t in tree_leaves(call)
                if isinstance(t, torch.Tensor)]
        tracker = StorageTracker()
        with FlopCounterMode(display=False) as fc, tracker:
            out = fn(*call)
        out_st = _storages(out)
        del held
        flops = fc.get_total_flops() + sum(ops.traced_flops.values())
        result = {
            "n_devices": n_devices,
            "flops": float(flops),
            "collectives": {k: float(v["bytes"])
                            for k, v in comm.KINDS.items()},
            "collective_counts": {k: float(v["calls"])
                                  for k, v in comm.KINDS.items()},
            "collective_groups": {k: dict(v["groups"])
                                  for k, v in comm.KINDS.items()},
            "collective_bytes": float(sum(v["bytes"]
                                          for v in comm.KINDS.values())),
            "kernel_launches": {k: v for k, v in
                                ops.traced_launches.items() if v},
            "memory": {
                "argument_bytes": sum(arg_st.values()),
                "output_bytes": sum(b for k, b in out_st.items()
                                    if k not in arg_st),
                "temp_bytes": tracker.peak,
                "alias_bytes": sum(b for k, b in out_st.items()
                                   if k in arg_st),
            },
            "arguments": arguments,
            "leaves": leaves,
        }
        del out
        return result
    finally:
        comm.KINDS.clear()
        comm.KINDS.update(kinds)
        comm.STATS.update(stats)

