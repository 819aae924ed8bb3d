"""The collectives of the sharded runtime (the port's counterpart of the
named-axis collectives ``psum``/``all_gather``/``ppermute`` the reference
issues inside ``shard_map``).

An :class:`Axes` is a set of mesh axes resolved for this rank: the
``torch.distributed`` process group over them, its size and this rank's
index in it (``launch/mesh.py::Mesh.axes`` builds one). ``group=None`` is a
world of one with no process group at all: every collective is then the
identity, computed without communication.

This is the ONE place the port talks to ``torch.distributed``. Each helper
below picks the route by the group's backend and the collective
(:func:`_staged`): NCCL takes the tensors where they are, and so does gloo
in ``all_reduce`` and ``all_gather`` (``GLOO_CUDA_OPS``: what chip_smoke.py
phase MD4's probe found gloo to take on an H100 machine). gloo's
``send``/``recv``, the ring's, hand the raw pointer to its transport and
take host memory only, so there a CUDA operand is copied to pinned host
memory, sent, received there and copied back, the bytes counted in
``STATS['staged_bytes']``. That is the transport several ranks sharing one
card have (NCCL refuses two ranks on one GPU); the arithmetic around the
collectives and every kernel stay on the card.

Gathers move raw bytes (a uint8 view of the operand), so int8 mantissas,
int16 indices and bf16 values travel whatever the backend's typed support;
all-reduces sum f32. :func:`ring_all_gather` rebuilds ``all_gather`` as
n − 1 ``batch_isend_irecv`` steps to the ring neighbour, applying ``fn`` to
each chunk as it lands and re-indexing to rank order, so it is bit-identical
to the blocking gather; on NCCL the next step's transfer is in flight while
the host queues ``fn`` on the chunk in hand.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Any, Callable, List, Optional, Tuple

import torch

# per-process counters the multi-rank phases read: collective calls (a ring
# hop is one), the bytes this rank hands to them (its operand of each call),
# the bytes staged through host memory under gloo, and the seconds inside
# them (the device synchronized before and after when TIMED is set)
STATS = {"collectives": 0, "wire_bytes": 0, "staged_bytes": 0,
         "seconds": 0.0}
TIMED = False
# the collectives gloo runs on CUDA tensors as they are
GLOO_CUDA_OPS = frozenset({"all_reduce", "all_gather"})


def reset_stats() -> None:
    for k in STATS:
        STATS[k] = 0.0 if k == "seconds" else 0


@dataclasses.dataclass(frozen=True)
class Axes:
    """Mesh axes resolved for this rank: ``group`` (None: a world of one
    without a process group), its ``size``, this rank's ``index`` in it and
    the global ``ranks`` of its members in index order."""

    names: Tuple[str, ...] = ()
    group: Any = None
    size: int = 1
    index: int = 0
    ranks: Tuple[int, ...] = (0,)


def _dist():
    import torch.distributed as dist
    return dist


def _staged(axes: Axes, x: torch.Tensor, op: str) -> bool:
    """True when ``x`` travels through host memory in collective ``op``: a
    CUDA tensor in a gloo group, ``op`` outside GLOO_CUDA_OPS."""
    return x.is_cuda and op not in GLOO_CUDA_OPS \
        and _dist().get_backend(axes.group) == "gloo"


def _host(x: torch.Tensor) -> torch.Tensor:
    """A pinned host copy of a CUDA tensor (counted as staged)."""
    out = torch.empty(x.shape, dtype=x.dtype,
                      pin_memory=torch.cuda.is_available())
    out.copy_(x)
    STATS["staged_bytes"] += x.numel() * x.element_size()
    return out


def _back(host: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    STATS["staged_bytes"] += host.numel() * host.element_size()
    return host.to(like.device)


def _timed(fn):
    """Run one collective, counting it and its wall time."""
    def run(axes, x, *a, **kw):
        if TIMED and x.is_cuda:
            torch.cuda.synchronize(x.device)
        t0 = time.perf_counter()
        out = fn(axes, x, *a, **kw)
        if TIMED and x.is_cuda:
            torch.cuda.synchronize(x.device)
        STATS["seconds"] += time.perf_counter() - t0
        STATS["collectives"] += 1
        STATS["wire_bytes"] += x.numel() * x.element_size()
        return out
    return run


def _bytes(x: torch.Tensor) -> torch.Tensor:
    return x.contiguous().reshape(-1).view(torch.uint8)


def _unbytes(b: torch.Tensor, dtype: torch.dtype, shape) -> torch.Tensor:
    """The tensor of ``dtype`` and ``shape`` whose bytes are ``b``."""
    return b.view(dtype).reshape(shape)


@_timed
def all_reduce_sum(axes: Axes, x: torch.Tensor) -> torch.Tensor:
    """Σ over the group of an f32 tensor, as a new tensor (every rank gets
    the same bits)."""
    if x.dtype != torch.float32:
        raise ValueError(f"all_reduce_sum sums f32, got {x.dtype}")
    if axes.group is None:
        return x.clone()
    dist = _dist()
    if _staged(axes, x, "all_reduce"):
        buf = _host(x)
        dist.all_reduce(buf, group=axes.group)
        return _back(buf, x)
    out = x.clone()
    dist.all_reduce(out, group=axes.group)
    return out


def mean(axes: Axes, x: torch.Tensor) -> torch.Tensor:
    """The mean over the group's clients, as ``ef.client_mean`` takes it:
    summed in f32, divided once, rounded back to ``x``'s dtype."""
    return (all_reduce_sum(axes, x.float()) / axes.size).to(x.dtype)


@_timed
def all_gather(axes: Axes, x: torch.Tensor) -> torch.Tensor:
    """(size, *x.shape): every member's ``x`` stacked in index order."""
    if axes.group is None:
        return x[None].clone()
    dist = _dist()
    src = _bytes(x)
    staged = _staged(axes, x, "all_gather")
    if staged:
        src = _host(src)
    outs = [torch.empty_like(src) for _ in range(axes.size)]
    dist.all_gather(outs, src, group=axes.group)
    out = torch.stack(outs)
    if staged:
        out = _back(out, x)
    return _unbytes(out, x.dtype, (axes.size, *x.shape))


@_timed
def _ring_step(axes: Axes, x: torch.Tensor) -> torch.Tensor:
    """One ring hop: send ``x`` to the next member, receive the previous
    member's tensor of the same shape and dtype."""
    dist = _dist()
    n, me = axes.size, axes.index
    src = _bytes(x)
    staged = _staged(axes, x, "p2p")
    if staged:
        src = _host(src)
    dst = torch.empty_like(src)
    reqs = dist.batch_isend_irecv([
        dist.P2POp(dist.isend, src, axes.ranks[(me + 1) % n], axes.group),
        dist.P2POp(dist.irecv, dst, axes.ranks[(me - 1) % n], axes.group)])
    for r in reqs:
        r.wait()
    if staged:
        dst = _back(dst, x)
    return _unbytes(dst, x.dtype, x.shape)


def ring_all_gather(axes: Axes, xs: Tuple[torch.Tensor, ...],
                    fn: Optional[Callable] = None) -> Tuple[torch.Tensor, ...]:
    """``all_gather`` of a tuple of tensors rebuilt as a ring of n − 1
    ``batch_isend_irecv`` steps: chunk s arrives from the member s hops
    back, ``fn`` maps each chunk (a tuple) as it lands, and the chunks are
    re-indexed to member order, so the result is the blocking gather's
    (with ``fn`` applied per chunk) bit for bit. A world of one stacks the
    one chunk."""
    if fn is None:
        fn = lambda c: c                                  # noqa: E731
    n = axes.size
    chunks: List[Tuple[torch.Tensor, ...]] = [tuple(fn(xs))]
    buf = xs
    for _ in range(n - 1):
        buf = tuple(_ring_step(axes, b) for b in buf)
        chunks.append(tuple(fn(buf)))
    # chunks[s] came from member (me − s) mod n
    order = [(axes.index - s) % n for s in range(n)]
    by_member = [None] * n
    for s, m in enumerate(order):
        by_member[m] = chunks[s]
    return tuple(torch.stack([c[i] for c in by_member])
                 for i in range(len(chunks[0])))


def gather_to_first(axes: Axes, x: torch.Tensor) -> Optional[torch.Tensor]:
    """(size, *x.shape) on the CPU at the group's first member, None
    elsewhere: a checkpoint's client leaves, collected leaf by leaf with
    ``gather``, so only the first member ever holds the others' slices (one
    leaf at a time, on its device under NCCL, which gathers where the
    tensors are; gloo's gather takes host memory, so a CUDA leaf is staged
    there)."""
    if axes.group is None:
        return x.detach().cpu()[None]
    src = _bytes(x.detach())
    if _staged(axes, x, "gather"):
        src = _host(src)
    outs = [torch.empty_like(src) for _ in range(axes.size)] \
        if axes.index == 0 else None
    _dist().gather(src, outs, dst=axes.ranks[0], group=axes.group)
    if axes.index != 0:
        return None
    return _unbytes(torch.stack(outs).cpu(), x.dtype, (axes.size, *x.shape))


def barrier(axes: Axes) -> None:
    if axes.group is not None:
        _dist().barrier(group=axes.group)
