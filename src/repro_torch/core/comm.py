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
from typing import Any, Callable, Dict, List, Optional, Tuple

import torch

# per-process counters the multi-rank phases read: collective calls (a ring
# hop is one), the bytes this rank hands to them (its operand of each call),
# the bytes staged through host memory under gloo, and the seconds inside
# them (the device synchronized before and after when TIMED is set); the
# tensor-parallel pass's (tp_*) and a pod client's data group's (data_*:
# the sums of its shares, its MoE routing counts) apart
STATS = {"collectives": 0, "wire_bytes": 0, "staged_bytes": 0,
         "seconds": 0.0, "tp_collectives": 0, "tp_wire_bytes": 0,
         "tp_seconds": 0.0, "data_collectives": 0, "data_wire_bytes": 0,
         "data_seconds": 0.0}
TIMED = False
# the collectives by kind, the reference analyzer's names (hlo_analysis's
# COLLECTIVES; the ring's send/recv is its collective-permute): for each,
# the calls, the operand bytes handed in and the calls by group (its mesh
# axes joined by '+'), counted where a group of more than one rank runs
# it, on real and traced runs alike (launch/trace_analysis.py reads them)
KINDS: Dict[str, Dict[str, Any]] = {}
# the collectives gloo runs on CUDA tensors as they are
GLOO_CUDA_OPS = frozenset({"all_reduce", "all_gather"})


def reset_stats() -> None:
    for k in STATS:
        STATS[k] = 0.0 if k.endswith("seconds") else 0
    KINDS.clear()


def _record(kind: str, axes: "Axes", x: torch.Tensor) -> None:
    """Count one collective of ``kind`` over ``axes`` in KINDS."""
    if axes.size == 1:
        return
    k = KINDS.setdefault(kind, {"calls": 0, "bytes": 0, "groups": {}})
    k["calls"] += 1
    k["bytes"] += x.numel() * x.element_size()
    group = "+".join(axes.names)
    k["groups"][group] = k["groups"].get(group, 0) + 1


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


def _counted(prefix: str, kind: str):
    """Run one collective of ``kind``, counting it, its operand's bytes and
    its wall time under the ``prefix`` keys of STATS, and in KINDS."""
    def wrap(fn):
        def run(axes, x, *a, **kw):
            if TIMED and x.is_cuda:
                torch.cuda.synchronize(x.device)
            t0 = time.perf_counter()
            out = fn(axes, x, *a, **kw)
            if TIMED and x.is_cuda:
                torch.cuda.synchronize(x.device)
            STATS[prefix + "seconds"] += time.perf_counter() - t0
            STATS[prefix + "collectives"] += 1
            STATS[prefix + "wire_bytes"] += x.numel() * x.element_size()
            _record(kind, axes, x)
            return out
        return run
    return wrap


def _bytes(x: torch.Tensor) -> torch.Tensor:
    return x.contiguous().reshape(-1).view(torch.uint8)


def _unbytes(b: torch.Tensor, dtype: torch.dtype, shape) -> torch.Tensor:
    """The tensor of ``dtype`` and ``shape`` whose bytes are ``b``."""
    return b.view(dtype).reshape(shape)


def _sum(axes: Axes, x: torch.Tensor) -> torch.Tensor:
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


@_counted("", "all-reduce")
def all_reduce_sum(axes: Axes, x: torch.Tensor) -> torch.Tensor:
    """Σ over the group of an f32 tensor, as a new tensor (every rank gets
    the same bits)."""
    return _sum(axes, x)


@_counted("data_", "all-reduce")
def share_sum(axes: Axes, x: torch.Tensor) -> torch.Tensor:
    """Σ over a pod client's data group of each member's additive share
    (its loss share, a gradient leaf): summed in f32, cast back to x's
    dtype, every member getting the same bits; a new tensor."""
    return _sum(axes, x.float()).to(x.dtype)


def mean(axes: Axes, x: torch.Tensor) -> torch.Tensor:
    """The mean over the group's clients, as ``ef.client_mean`` takes it:
    summed in f32, divided once, rounded back to ``x``'s dtype."""
    return (all_reduce_sum(axes, x.float()) / axes.size).to(x.dtype)


def _all_gather(axes: Axes, x: torch.Tensor) -> torch.Tensor:
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


@_counted("", "all-gather")
def all_gather(axes: Axes, x: torch.Tensor) -> torch.Tensor:
    """(size, *x.shape): every member's ``x`` stacked in index order."""
    return _all_gather(axes, x)


@_counted("", "collective-permute")
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


def broadcast_object(axes: Axes, obj: Any) -> Any:
    """The group's first member's ``obj`` (any picklable value) on every
    member: a decision one rank makes for all (whether a bootstrap exists,
    a publish's outcome, serving's wall clock)."""
    if axes.group is None or axes.size == 1:
        return obj
    box = [obj if axes.index == 0 else None]
    _dist().broadcast_object_list(box, src=axes.ranks[0], group=axes.group)
    return box[0]


# ---------------------------------------------------------------------------
# the tensor-parallel pass's collectives over the 'model' axis (Megatron's
# f and g), differentiable under torch.func.grad/vjp and plain autograd
# ---------------------------------------------------------------------------

def _plain(x: torch.Tensor) -> torch.Tensor:
    """``x`` out of the ``torch.func.grad``/``vjp`` wrappers it comes in
    when a backward runs inside those transforms (a recomputed block's)."""
    from torch._C import _functorch
    while _functorch.is_gradtrackingtensor(x):
        x = _functorch.get_unwrapped(x)
    return x


def _plain_counted(prefix: str, kind: str):
    """Run one collective of ``kind`` inside the client pass, counted under
    KINDS and the
    ``prefix`` keys of STATS (``tp_``: the tensor-parallel pass's; ``data_``:
    a pod client's data group's). It runs on plain tensors with the
    ``torch.func`` transforms set aside (inside them every operation's
    result is a wrapper, and gloo's CUDA all-gather reads the storage,
    which a wrapper has not); its result is a constant to the transforms,
    as every collective's is: the gradients are the autograd.Functions'
    own."""
    def wrap(fn):
        def run(axes, x, *a, **kw):
            if TIMED and x.is_cuda:
                torch.cuda.synchronize(x.device)
            t0 = time.perf_counter()
            with torch.no_grad(), torch._C._DisableFuncTorch():
                out = fn(axes, _plain(x).detach(), *a, **kw)
            if TIMED and x.is_cuda:
                torch.cuda.synchronize(x.device)
            STATS[prefix + "seconds"] += time.perf_counter() - t0
            STATS[prefix + "collectives"] += 1
            STATS[prefix + "wire_bytes"] += x.numel() * x.element_size()
            _record(kind, axes, x)
            return out
        return run
    return wrap


# the tensor-parallel pass's sums and maxes
_tp_timed = _plain_counted("tp_", "all-reduce")


@_tp_timed
def _model_all_reduce(axes: Axes, x: torch.Tensor, op=None) -> torch.Tensor:
    """The f32 sum (or ``op``) of ``x`` over ``axes``, cast back to x's
    dtype: every member gets the same bits."""
    dist = _dist()
    out = x.float().clone()
    kw = {} if op is None else {"op": op}
    # gloo's CUDA route is known to sum (GLOO_CUDA_OPS); a max stages
    if _staged(axes, out, "all_reduce" if op is None else "max"):
        buf = _host(out)
        dist.all_reduce(buf, group=axes.group, **kw)
        out = _back(buf, out)
    else:
        dist.all_reduce(out, group=axes.group, **kw)
    return out.to(x.dtype)


@_plain_counted("tp_", "all-gather")
def _resplit_blocks(axes: Axes, x: torch.Tensor, groups: int,
                    to_grouped: bool) -> torch.Tensor:
    """Move the last dim of ``x`` between two splits over ``axes`` (n
    members) of a tensor T of ``groups`` equal parts, cut into n·groups
    blocks: the contiguous split, member r holding blocks [r·groups,
    (r+1)·groups) (a leaf split on its last dim), and the grouped one,
    member r holding block r of every part (blocks i·n + r). One gather of
    every member's blocks (the raw bytes, in x's dtype), then this
    member's blocks of the other split, in order."""
    n, r = axes.size, axes.index
    blocks = _all_gather(axes, x.contiguous()).unflatten(
        -1, (groups, x.shape[-1] // groups))        # (n, ..., groups, b)
    if to_grouped:      # block i·n + r sits at member (i·n + r) // groups
        want = [divmod(i * n + r, groups) for i in range(groups)]
    else:               # block r·groups + t sits at member (r·groups + t) % n
        want = [((r * groups + t) % n, (r * groups + t) // n)
                for t in range(groups)]
    return torch.cat([blocks[m, ..., s, :] for m, s in want], dim=-1)


@_plain_counted("data_", "all-gather")
def _gather_plain(axes: Axes, x: torch.Tensor) -> torch.Tensor:
    return _all_gather(axes, x.contiguous())


@_plain_counted("tp_", "all-gather")
def _gather_model(axes: Axes, x: torch.Tensor) -> torch.Tensor:
    return _all_gather(axes, x.contiguous())


def gather_last(axes: Axes, x: torch.Tensor) -> torch.Tensor:
    """The members' blocks of x's last dim joined in index order, on every
    member, without a gradient: serving's logits over a vocabulary split
    on the 'model' axis (counted with the tensor-parallel pass's
    collectives)."""
    if axes.size == 1:
        return x
    parts = _gather_model(axes, x)                  # (size, ..., w)
    return torch.movedim(parts, 0, -2).reshape(*x.shape[:-1], -1)


def gather_plain(axes: Axes, x: torch.Tensor) -> torch.Tensor:
    """(size, *x.shape): every member's ``x`` stacked in index order, a
    constant to the ``torch.func`` transforms (a pod client's MoE routing
    counts over its data group, models/moe.py); counted with the data
    group's collectives."""
    return x.detach()[None] if axes.size == 1 else _gather_plain(axes, x)


class _Copy(torch.autograd.Function):
    """f: the identity forward, the sum over the group backward. Placed
    where a tensor every member holds whole enters a split region."""

    @staticmethod
    def forward(x, axes):
        return x.view_as(x)

    @staticmethod
    def setup_context(ctx, inputs, output):
        ctx.axes = inputs[1]

    @staticmethod
    def backward(ctx, g):
        return _model_all_reduce(ctx.axes, g), None


class _Reduce(torch.autograd.Function):
    """g: the sum over the group forward, the identity backward. Placed
    where a split region's partial sums leave it."""

    @staticmethod
    def forward(x, axes):
        return _model_all_reduce(axes, x)

    @staticmethod
    def setup_context(ctx, inputs, output):
        pass

    @staticmethod
    def backward(ctx, g):
        return g, None


class _Resplit(torch.autograd.Function):
    """The contiguous split of a tensor's last dim over the group re-split
    into its parts' own splits (:func:`resplit`) forward, the inverse
    backward: a permutation of blocks among the members both ways."""

    @staticmethod
    def forward(x, axes, groups):
        return _resplit_blocks(axes, x, groups, True)

    @staticmethod
    def setup_context(ctx, inputs, output):
        ctx.axes, ctx.groups = inputs[1], inputs[2]

    @staticmethod
    def backward(ctx, g):
        return _resplit_blocks(ctx.axes, g, ctx.groups, False), None, None


class _Max(torch.autograd.Function):
    """The elementwise max over the group, with no gradient."""

    @staticmethod
    def forward(x, axes):
        return _model_all_reduce(axes, x, _dist().ReduceOp.MAX)

    @staticmethod
    def setup_context(ctx, inputs, output):
        ctx.mark_non_differentiable(output)

    @staticmethod
    def backward(ctx, g):
        return None, None


def seq_all_reduce(axes: Axes, x: torch.Tensor, op: str = "sum"
                   ) -> torch.Tensor:
    """The f32 ``op`` ('sum' or 'max') of ``x`` over ``axes``, cast back to
    x's dtype, without a gradient: a sequence-split decode's softmax merge
    (models/layers.py ``decode_attention``), counted with the serving
    pass's collectives."""
    return _model_all_reduce(axes, x, None if op == "sum"
                             else _dist().ReduceOp.MAX)


def copy_to(axes: Axes, x: torch.Tensor) -> torch.Tensor:
    """Megatron's f over ``axes`` (the identity on a group of one)."""
    return x if axes.size == 1 else _Copy.apply(x, axes)


def reduce_from(axes: Axes, x: torch.Tensor) -> torch.Tensor:
    """Megatron's g over ``axes`` (the identity on a group of one)."""
    return x if axes.size == 1 else _Reduce.apply(x, axes)


def reduce_to_all(axes: Axes, x: torch.Tensor) -> torch.Tensor:
    """g then f: a split region's partial sums made whole on every member
    where the sum feeds split work again, so its gradient (each member's
    share) is summed over ``axes`` on the way back."""
    return copy_to(axes, reduce_from(axes, x))


def resplit(axes: Axes, x: torch.Tensor, groups: int) -> torch.Tensor:
    """``x`` (..., W/n): this member's contiguous block of a tensor (...,
    W) of ``groups`` equal parts, split over ``axes`` as a leaf split on its
    last dim is (at n = 2 and two parts, member 0 holds the first part and
    member 1 the second). Returns (..., W/n): block ``index`` of each part,
    the parts in order, as a split of each part gives them. Its gradient
    goes back to the contiguous blocks the same way (the identity on a
    group of one)."""
    return x if axes.size == 1 else _Resplit.apply(x, axes, groups)


def max_from(axes: Axes, x: torch.Tensor) -> torch.Tensor:
    """The elementwise max over ``axes``, without a gradient (a softmax's
    shift)."""
    if axes.size == 1:
        return x.detach()
    return _Max.apply(x.detach(), axes)
