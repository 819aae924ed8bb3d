"""Multi-process ``torch.distributed`` initialization (counterpart of
src/repro/launch/multiproc.py).

One process a client (a rank) joins one world through
``torch.distributed.init_process_group`` at ``tcp://host:port``; after it,
``launch/mesh.py::make_production_mesh`` spans every rank and the sharded
round (core/distributed.py::ef_round_sharded) issues its collectives across
the process boundary. Training drivers opt in with::

    python -m repro_torch.launch.train --coordinator localhost:29511 \\
        --num-processes 4 --process-id 0 ...     # and 1, 2, 3 concurrently

The backend is NCCL when every rank of the host has a card of its own, and
gloo otherwise: on the CPU, and when several ranks share one card (NCCL
refuses two ranks on one GPU; gloo takes CUDA tensors in its all-reduce
and all-gather, and core/comm.py stages its send/recv through pinned host
memory). A rank with a card of its own
takes ``cuda:<rank % cards>`` as its current device.

Idempotent: ``distributed_init`` with the coordinates this process already
joined with is a no-op, and different coordinates after init are a hard
error (one world a process).

The CLI smoke proves the fabric: every process all-gathers its process id,
checks the full roster, clears a barrier and prints ``DISTRIBUTED_OK``::

    python -m repro_torch.launch.multiproc --coordinator localhost:29511 \\
        --num-processes 2 --process-id 0          # and 1, concurrently
"""
from __future__ import annotations

import argparse
import datetime
import os
import pickle
import time
from typing import Any, Callable, List, Optional, Sequence

_INITIALIZED: dict = {}


def choose_backend(num_processes: int) -> str:
    """'nccl' when each of ``num_processes`` ranks (one host) gets a card
    of its own, else 'gloo'."""
    import torch
    if torch.cuda.is_available() \
            and torch.cuda.device_count() >= num_processes:
        return "nccl"
    return "gloo"


# how long a collective may wait for the slowest rank before it fails
TIMEOUT_S = 600.0


def distributed_init(coordinator: str, num_processes: int, process_id: int,
                     backend: Optional[str] = None) -> bool:
    """Join the world. Returns True when this call initialized the process
    group, False when it was already done with the same coordinates.
    ``coordinator`` is ``host:port`` (rank 0 listens there), or any
    ``torch.distributed`` init method URL (``tcp://…``, ``file://…``)."""
    key = (coordinator, int(num_processes), int(process_id))
    if _INITIALIZED:
        prev = next(iter(_INITIALIZED))
        if prev != key:
            raise ValueError(
                f"torch.distributed already initialized as {prev}, refusing "
                f"to re-initialize as {key}: one world a process")
        return False
    if num_processes < 1 or not (0 <= process_id < num_processes):
        raise ValueError(
            f"process_id must be in [0, {num_processes}), got {process_id}")
    import torch
    import torch.distributed as dist
    backend = backend or choose_backend(num_processes)
    if backend == "nccl":
        torch.cuda.set_device(process_id % torch.cuda.device_count())
    url = coordinator if "://" in coordinator else f"tcp://{coordinator}"
    dist.init_process_group(backend, init_method=url,
                            world_size=int(num_processes),
                            rank=int(process_id),
                            timeout=datetime.timedelta(seconds=TIMEOUT_S))
    _INITIALIZED[key] = backend
    return True


def shutdown() -> None:
    """Leave the world (a no-op when this process never joined)."""
    import torch.distributed as dist
    if dist.is_initialized():
        dist.destroy_process_group()
    _INITIALIZED.clear()


def _rank_main(rank: int, fn: Callable, nprocs: int, store: str,
               threads: int, args: Sequence[Any]) -> None:
    """One spawned rank: join the gloo world, run ``fn(rank, *args)``,
    write its result beside the store, leave."""
    import torch
    torch.set_num_threads(threads)
    distributed_init(f"file://{store}", nprocs, rank, "gloo")
    try:
        out = fn(rank, *args)
        with open(f"{store}.result{rank}", "wb") as f:
            pickle.dump(out, f)
    finally:
        shutdown()


def spawn(fn: Callable, nprocs: int, workdir: str, args: Sequence[Any] = (),
          threads: int = 1, timeout_s: float = 300.0) -> List[Any]:
    """Run ``fn(rank, *args)`` on ``nprocs`` fresh processes that form one
    gloo world (a ``file://`` store in ``workdir``, ``threads`` torch
    threads a rank; ranks on a card share it) and return their results in
    rank order. ``fn`` must be importable
    by module and name (a spawned process imports it). A rank that raises
    fails the call; one still running after ``timeout_s`` is killed, and
    the call fails instead of hanging."""
    import torch.multiprocessing as mp
    os.makedirs(workdir, exist_ok=True)
    store = os.path.join(workdir, f"store_{os.getpid()}_{time.time_ns()}")
    ctx = mp.start_processes(
        _rank_main, args=(fn, nprocs, store, threads, tuple(args)),
        nprocs=nprocs, join=False, start_method="spawn")
    deadline = time.time() + timeout_s
    try:
        while not ctx.join(timeout=max(0.0, min(5.0,
                                                deadline - time.time()))):
            if time.time() >= deadline:
                raise TimeoutError(f"{nprocs} ranks still running after "
                                   f"{timeout_s:.0f} s")
    finally:
        for p in ctx.processes:
            if p.is_alive():
                p.kill()
                p.join()
    out = []
    for rank in range(nprocs):
        with open(f"{store}.result{rank}", "rb") as f:
            out.append(pickle.load(f))
        os.remove(f"{store}.result{rank}")
    return out


def smoke(coordinator: str, num_processes: int, process_id: int,
          backend: Optional[str] = None) -> str:
    """The multi-process fabric proof: every rank all-gathers its process
    id, the roster must be [0, n), and all ranks clear one barrier. A
    process that failed to join, or ran alone, cannot pass. Prints and
    returns the ``DISTRIBUTED_OK`` line."""
    import torch
    import torch.distributed as dist
    distributed_init(coordinator, num_processes, process_id, backend)
    assert dist.get_world_size() == num_processes, \
        f"world size {dist.get_world_size()} != {num_processes}"
    assert dist.get_rank() == process_id, \
        f"rank {dist.get_rank()} != {process_id}"
    dev = "cuda" if dist.get_backend() == "nccl" else "cpu"
    mine = torch.tensor([process_id], dtype=torch.int64, device=dev)
    got = [torch.empty_like(mine) for _ in range(num_processes)]
    dist.all_gather(got, mine)
    roster = [int(t.item()) for t in got]
    assert roster == list(range(num_processes)), \
        f"roster {roster} != {list(range(num_processes))}"
    dist.barrier()
    msg = (f"DISTRIBUTED_OK process {process_id}/{num_processes} "
           f"roster={roster} backend={dist.get_backend()} "
           f"sync=roster+barrier")
    print(msg, flush=True)
    return msg


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--coordinator", required=True,
                    help="host:port where process 0 listens")
    ap.add_argument("--num-processes", type=int, required=True)
    ap.add_argument("--process-id", type=int, required=True)
    ap.add_argument("--backend", default=None, choices=("gloo", "nccl"))
    args = ap.parse_args(argv)
    try:
        smoke(args.coordinator, args.num_processes, args.process_id,
              args.backend)
    finally:
        shutdown()


if __name__ == "__main__":
    main()
