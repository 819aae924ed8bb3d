"""Production meshes over the ranks of a ``torch.distributed`` world
(counterpart of src/repro/launch/mesh.py).

A :class:`Mesh` names the world's ranks, row-major, by axes
``("data", "model")`` or ``("pod", "data", "model")`` and holds the
``torch.distributed.device_mesh.DeviceMesh`` over them with those
``mesh_dim_names``; :meth:`Mesh.axes` resolves a set of axes to the process
group this rank's collectives run on (core/comm.py). Without a process
group a mesh is a world of one: no ``init_process_group``, no DeviceMesh,
and every collective is the identity.

The geometry is the reference's: (data 16, model 16) for a pod and (pod 2,
data 16, model 16) across two, shrunk pod-major onto fewer ranks by
:func:`_shrink_shape` (a copy of the reference's rule). On 1–16 ranks a pod
mesh keeps ``model`` 1, and so does a two-pod mesh on 1–32; the port runs
those (its ``model`` axis arrives with the next slice).
"""
from __future__ import annotations

from typing import Dict, Tuple

from repro_torch.core import comm

# the reference's production geometry (PROD_DATA/PROD_MODEL/PROD_PODS)
PROD_DATA = 16
PROD_MODEL = 16
PROD_PODS = 2


def _shrink_shape(shape: Tuple[int, ...], n_devices: int) -> Tuple[int, ...]:
    """Fit a production mesh shape onto fewer devices, left to right
    (pod-major): each axis takes the largest divisor of the remaining
    device count no bigger than its production size. (2, 16, 16) on 8
    devices becomes (2, 4, 1)."""
    rem = n_devices
    out = []
    for want in shape:
        for d in range(min(want, rem), 0, -1):
            if rem % d == 0:
                out.append(d)
                rem //= d
                break
    return tuple(out)


def _world() -> Tuple[int, int]:
    """(world size, this rank) of the initialized process group, or (1, 0)
    without one."""
    import torch.distributed as dist
    if dist.is_initialized():
        return dist.get_world_size(), dist.get_rank()
    return 1, 0


class Mesh:
    """Axis names and sizes over the world's ranks (row-major: rank r sits
    at the coordinate ``unravel(r, shape)``), and the DeviceMesh over them
    when the mesh spans a process group."""

    def __init__(self, shape: Tuple[int, ...], axis_names: Tuple[str, ...],
                 device_mesh=None, rank: int = 0):
        if len(shape) != len(axis_names):
            raise ValueError(f"mesh shape {shape} vs axes {axis_names}")
        self.axis_names = tuple(axis_names)
        self.shape: Dict[str, int] = dict(zip(axis_names, shape))
        self.device_mesh = device_mesh
        self.rank = rank

    @property
    def size(self) -> int:
        n = 1
        for s in self.shape.values():
            n *= s
        return n

    def client_axes(self) -> Tuple[str, ...]:
        """The client axes in POD-MAJOR order: ('pod', 'data') whenever the
        pod axis exists. Client i belongs to pod i // (n/pods), as the vmap
        round's pod-major client blocks."""
        return tuple(a for a in ("pod", "data") if a in self.axis_names)

    def coordinate(self) -> Dict[str, int]:
        """This rank's index on each axis."""
        r = self.rank
        out: Dict[str, int] = {}
        for name in reversed(self.axis_names):
            out[name] = r % self.shape[name]
            r //= self.shape[name]
        return {n: out[n] for n in self.axis_names}

    def axes(self, names: Tuple[str, ...]) -> comm.Axes:
        """The group over ``names`` through this rank: its members are the
        ranks that share this rank's coordinate on every other axis, in the
        order of ``names`` (the first name most significant, as the
        reference composes a client index)."""
        names = tuple(names)
        size = 1
        for a in names:
            size *= self.shape[a]
        me = self.coordinate()
        index = 0
        for a in names:
            index = index * self.shape[a] + me[a]
        if self.device_mesh is None:
            return comm.Axes(names, None, size, index, (self.rank,))
        ranks = []
        for i in range(size):
            coord = dict(me)
            rem = i
            for a in reversed(names):
                coord[a] = rem % self.shape[a]
                rem //= self.shape[a]
            r = 0
            for a in self.axis_names:
                r = r * self.shape[a] + coord[a]
            ranks.append(r)
        return comm.Axes(names, self._group(names, ranks), size, index,
                         tuple(ranks))

    def _group(self, names, ranks):
        import torch.distributed as dist
        if len(ranks) == dist.get_world_size():
            if list(ranks) == sorted(ranks):
                return dist.group.WORLD
        if len(names) == 1:
            return self.device_mesh.get_group(names[0])
        raise NotImplementedError(
            f"a group over axes {names} spanning part of the world needs "
            "the 'model' axis, which arrives with the next slice of the "
            "port (ROADMAP Queue 1 item 3)")

    def __repr__(self) -> str:
        return f"Mesh({self.shape})"


def _device_mesh(shape, axes):
    """The DeviceMesh over the world's ranks, on the device type the
    world's backend communicates from."""
    import torch
    import torch.distributed as dist
    from torch.distributed.device_mesh import DeviceMesh
    kind = "cuda" if dist.get_backend() == "nccl" else "cpu"
    return DeviceMesh(kind, torch.arange(dist.get_world_size()).reshape(
        shape), mesh_dim_names=axes)


def make_mesh(shape: Tuple[int, ...], axes: Tuple[str, ...]) -> Mesh:
    """A mesh of ``shape`` over the whole world (its size must be the
    world's); a world of one without a process group needs none."""
    world, rank = _world()
    n = 1
    for s in shape:
        n *= s
    if n != world:
        raise ValueError(f"mesh {dict(zip(axes, shape))} has {n} ranks, the "
                         f"world {world}")
    import torch.distributed as dist
    dm = _device_mesh(shape, axes) if dist.is_initialized() else None
    return Mesh(shape, axes, dm, rank)


def make_production_mesh(*, multi_pod: bool = False) -> Mesh:
    """Single pod: (data=16, model=16); two pods: (pod=2, data=16,
    model=16). On a world of fewer ranks the shape shrinks pod-major
    (:func:`_shrink_shape`), so ``--mesh multi_pod`` runs on any rank
    count."""
    shape = (PROD_PODS, PROD_DATA, PROD_MODEL) if multi_pod \
        else (PROD_DATA, PROD_MODEL)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    world, _ = _world()
    need = 1
    for s in shape:
        need *= s
    if world < need:
        shape = _shrink_shape(shape, world)
    return make_mesh(shape, axes)


def dp_size(mesh: Mesh) -> int:
    """The number of clients: the product of the client axes."""
    s = 1
    for a in mesh.client_axes():
        s *= mesh.shape[a]
    return s


def make_smoke_mesh() -> Mesh:
    """The 1-rank (data 1, model 1) mesh: the single-device runtime."""
    _, rank = _world()
    return Mesh((1, 1), ("data", "model"), None, rank)
