"""Partial participation, the synchronous part (counterpart of
src/repro/core/participation.py).

Only a sampled cohort S ⊆ [n] uploads in a round ("EF21 with Bells &
Whistles"): sampled clients run their usual update, NON-sampled clients
keep their whole EF state (gᵢ, the momentum vᵢ, …) frozen, and the server
folds (1/n)·Σ_{i∈S} cᵢ, so g_server = meanᵢ gᵢ survives every round.
Absolute-mode methods average over the cohort instead
(:func:`rescale_message`).

The cohort of a round is the reference's, bit for bit:
``jax.random.permutation(fold_in(PRNGKey(seed), step), n)[:m]``. Its
threefry2x32 stream (the partitionable key derivation, JAX's default) and
the sort-based shuffle are written out below in numpy ``uint32`` arithmetic
with a stable argsort, so the port's cohorts need no JAX.

``mode='async'`` never runs on the synchronous runtimes (they are barrier
loops); :func:`run_async` is the event-driven simulator: each client
computes for a time drawn from an :class:`ArrivalModel` (uniform,
heavy-tailed, or with lost computes), the server folds each accepted upload
c/n as it arrives, an optional cap discards stale uploads, and the wall
clock is compared with a synchronous barrier's
(:func:`sync_barrier_wallclock`). Its event queue draws from numpy's
``RandomState`` exactly as the reference's does, so every event count, the
staleness histogram and both wall clocks equal the reference's; only the
gradients and compressors draw from the port's generators.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

Tree = Dict[str, torch.Tensor]

PART_MODES = ("full", "sampled", "async")


@dataclasses.dataclass(frozen=True)
class Participation:
    """Who uploads each round. ``fraction``/``seed`` only matter for
    mode='sampled'."""

    mode: str = "full"          # 'full' | 'sampled' | 'async'
    fraction: float = 1.0       # sampled cohort size = max(1, round(f·n))
    seed: int = 0               # cohort stream seed (independent of data)

    def __post_init__(self):
        if self.mode not in PART_MODES:
            raise ValueError(f"participation mode {self.mode!r} not in "
                             f"{list(PART_MODES)}")
        if not 0.0 < self.fraction <= 1.0:
            raise ValueError(f"participation fraction must be in (0, 1], "
                             f"got {self.fraction}")

    @property
    def is_sampling(self) -> bool:
        """True when the synchronous runtime runs the masked-cohort path."""
        return self.mode == "sampled"

    def cohort_size(self, n: int) -> int:
        """|S| = max(1, round(fraction·n)); n in mode 'full'."""
        if self.mode == "full":
            return n
        return max(1, int(round(self.fraction * n)))


# ---------------------------------------------------------------------------
# the reference's cohort stream: threefry2x32 and the sort-based shuffle
# ---------------------------------------------------------------------------

_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
_Key = Tuple[np.uint32, np.uint32]


def _rotl(x: np.ndarray, d: int) -> np.ndarray:
    return (x << np.uint32(d)) | (x >> np.uint32(32 - d))


def threefry2x32(key: _Key, x0: np.ndarray, x1: np.ndarray
                 ) -> Tuple[np.ndarray, np.ndarray]:
    """The Threefry-2x32 block cipher (20 rounds) on uint32 count pairs, as
    JAX hashes them (``jax._src.prng._threefry2x32_lowering``)."""
    k1, k2 = np.uint32(key[0]), np.uint32(key[1])
    ks = (k1, k2, k1 ^ k2 ^ np.uint32(0x1BD11BDA))
    with np.errstate(over="ignore"):
        x = [np.asarray(x0, np.uint32) + ks[0],
             np.asarray(x1, np.uint32) + ks[1]]
        for i in range(5):
            for r in _ROTATIONS[i % 2]:
                x[0] = x[0] + x[1]
                x[1] = x[0] ^ _rotl(x[1], r)
            x[0] = x[0] + ks[(i + 1) % 3]
            x[1] = x[1] + ks[(i + 2) % 3] + np.uint32(i + 1)
    return x[0], x[1]


def prng_key(seed: int) -> _Key:
    """``jax.random.PRNGKey(seed)`` with 64-bit types off: the seed's low 32
    bits (the high word of the key is 0)."""
    return np.uint32(0), np.uint32(int(seed) % 2 ** 32)


def fold_in(key: _Key, data: int) -> _Key:
    """``jax.random.fold_in``: the key's hash of the count pair (0, data)."""
    a, b = threefry2x32(key, np.zeros(1, np.uint32),
                       np.array([int(data) % 2 ** 32], np.uint32))
    return a[0], b[0]


def _split2(key: _Key) -> Tuple[_Key, _Key]:
    """``jax.random.split(key)`` on the partitionable path: keys i = 0, 1
    are the hashes of the count pairs (0, i)."""
    a, b = threefry2x32(key, np.zeros(2, np.uint32),
                       np.arange(2, dtype=np.uint32))
    return (a[0], b[0]), (a[1], b[1])


def _random_bits32(key: _Key, n: int) -> np.ndarray:
    """32 random bits for each of n positions: hash of (0, i), halves
    xor-ed (``_threefry_random_bits_partitionable``)."""
    a, b = threefry2x32(key, np.zeros(n, np.uint32),
                        np.arange(n, dtype=np.uint32))
    return a ^ b


def permutation(key: _Key, n: int) -> np.ndarray:
    """``jax.random.permutation(key, n)``: sort arange(n) by fresh 32-bit
    keys, stably, ceil(3·ln n / ln(2³²−1)) times (once for n < 1626)."""
    x = np.arange(n)
    rounds = int(math.ceil(3 * math.log(max(1, n))
                           / math.log(np.iinfo(np.uint32).max)))
    for _ in range(rounds):
        key, sub = _split2(key)
        x = x[np.argsort(_random_bits32(sub, n), kind="stable")]
    return x


def cohort_mask_np(part: Participation, n: int, step: int) -> np.ndarray:
    """The round's 0/1 client mask, (n,) float32: the first ``cohort_size``
    entries of the seeded permutation of [n] for (seed, step). Pure in
    (seed, step), so a resumed run replays the same cohorts; fraction 1.0
    gives all ones."""
    m = part.cohort_size(n)
    perm = permutation(fold_in(prng_key(part.seed), step), n)
    mask = np.zeros(n, np.float32)
    mask[perm[:m]] = 1.0
    return mask


def cohort_mask(part: Participation, n: int, step: int,
                device=None) -> torch.Tensor:
    """:func:`cohort_mask_np` as a float32 tensor on ``device``."""
    return torch.from_numpy(cohort_mask_np(part, n, step)).to(device)


# ---------------------------------------------------------------------------
# masking / freezing primitives
# ---------------------------------------------------------------------------

def _lead(mask: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """The (n,) mask shaped to broadcast over a client-leading leaf."""
    return mask.reshape((mask.shape[0],) + (1,) * (x.ndim - 1))


def apply_mask(mask: torch.Tensor, tree: Tree) -> Tree:
    """Zero the non-cohort clients of a client-leading tree. The mask is
    cast to each leaf's dtype, so ×1.0 and ×0.0 are exact: at fraction 1.0
    the masked path is bitwise the unmasked one."""
    return {k: x * _lead(mask, x).to(x.dtype) for k, x in tree.items()}


def freeze_tree(mask: torch.Tensor, new: Dict[str, Tree],
                old: Dict[str, Tree]) -> Dict[str, Tree]:
    """Non-sampled clients keep their ENTIRE EF state: ``where(mask, new,
    old)`` leaf-wise over ``{name: tree}``, never arithmetic (a += 0 could
    still flip -0.0)."""
    return {name: {k: torch.where(_lead(mask, x).bool(), x, old[name][k])
                   for k, x in tree.items()}
            for name, tree in new.items()}


def rescale_message(method, msg_mean: Tree, n: int, m: int) -> Tree:
    """Masked aggregates come back as (1/n)·Σ_{i∈S}: the delta-mode server
    increment as it is. Absolute-mode methods average over the cohort, so
    the masked mean scales by n/m (×1.0, exact, when m = n), the scale
    rounded to each leaf's dtype as the reference's weak-typed scalar is."""
    if method.mode != "absolute":
        return msg_mean
    from repro_torch.core import ef as ef_lib
    return ef_lib.tree_scale(msg_mean, float(n) / float(m))


# ---------------------------------------------------------------------------
# event-driven asynchronous rounds (mode='async')
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class ArrivalModel:
    """Per-client compute-time model of the async event loop.

    'uniform'     τ ~ U[0.5, 1.5]·mean: a homogeneous fleet
    'heavy_tail'  τ ~ Pareto(alpha) scaled to E[τ] = mean: stragglers, whose
                  per-round maximum (what a barrier pays) is far above the
                  mean an async server pays
    'dropout'     uniform times, each compute LOST with prob drop_prob
    """

    kind: str = "uniform"
    mean: float = 1.0
    alpha: float = 1.3
    drop_prob: float = 0.2

    def __post_init__(self):
        if self.kind not in ("uniform", "heavy_tail", "dropout"):
            raise ValueError(f"unknown arrival kind {self.kind!r}")
        if self.kind == "heavy_tail" and self.alpha <= 1.0:
            raise ValueError("heavy_tail needs alpha > 1 (finite mean), "
                             f"got {self.alpha}")
        if not 0.0 <= self.drop_prob < 1.0:
            raise ValueError("drop_prob must be in [0, 1) — a client that "
                             f"always drops deadlocks, got {self.drop_prob}")

    def sample(self, rs: np.random.RandomState, size: int) -> np.ndarray:
        if self.kind == "heavy_tail":
            # Pareto(alpha) with minimum xm has mean xm·alpha/(alpha-1)
            xm = self.mean * (self.alpha - 1.0) / self.alpha
            return xm * (1.0 + rs.pareto(self.alpha, size=size))
        return self.mean * rs.uniform(0.5, 1.5, size=size)

    def dropped(self, rs: np.random.RandomState, size: int) -> np.ndarray:
        if self.kind != "dropout":
            return np.zeros(size, dtype=bool)
        return rs.uniform(size=size) < self.drop_prob


def sync_barrier_wallclock(arrival: ArrivalModel, n: int, rounds: int,
                           seed: int = 0) -> float:
    """What a synchronous barrier pays under the same compute-time model:
    each round waits for the SLOWEST client, a lost compute retried within
    the round."""
    rs = np.random.RandomState(seed)
    total = 0.0
    for _ in range(rounds):
        t = arrival.sample(rs, n)
        pending = arrival.dropped(rs, n)
        while pending.any():                 # resample lost computes
            k = int(pending.sum())
            t[pending] += arrival.sample(rs, k)
            pending[pending] = arrival.dropped(rs, k)
        total += float(t.max())
    return total


def run_async(problem, method, n: int, gamma: float, rounds: int,
              arrival: ArrivalModel = ArrivalModel(),
              batch_size: int = 1, b_init: int = 1, eta=None,
              staleness_cap: Optional[int] = None, seed: int = 0
              ) -> Dict[str, Any]:
    """Event-driven asynchronous EF rounds, an ADPSGD-style client loop.

    Every client forever fetches x, computes a stochastic gradient for a
    time τ ~ ``arrival`` and uploads. The server takes uploads in arrival
    order: an accepted upload folds the client's compressed innovation,
    g ← g + c/n (the Bells & Whistles rule with a cohort of one), and steps
    x ← x − γ·g. A ROUND is n accepted uploads; the wall clock is the event
    time of the last one. An upload's staleness is the server's model
    version now less the one the client fetched; above ``staleness_cap`` it
    is discarded (the client refetches). A lost compute ('dropout')
    reschedules at once. Delta-mode (EF21-family) methods only.

    Compute k (the k-th fetch) draws its gradient from
    ``generator(derive(seed, k))`` and its compressor from that folded with
    1, on the problem's device; the event queue draws from
    ``RandomState(seed)`` as the reference's does."""
    from repro_torch.core import ef as ef_lib
    from repro_torch.core import rng as rng_lib
    from repro_torch.core import simulate

    if method.mode == "absolute":
        raise ValueError(
            f"run_async supports delta-mode (EF21-family) methods only; "
            f"{method.name!r} is absolute-mode — its server state is a "
            "cohort mean, which has no per-arrival incremental fold")

    rs = np.random.RandomState(seed)
    x = problem.init_x()
    dev = next(iter(x.values())).device
    base = rng_lib.generator(seed, dev)
    # Alg 1 line 2 handshake (synchronous, as the synchronous simulator's)
    g0 = simulate.init_grads(problem, x, base, n, batch_size, b_init)
    states = [method.init(x, init_grads={k: v[i].clone()
                                         for k, v in g0.items()})
              for i in range(n)]
    g_server = ef_lib.server_init(
        method, x, {k: v.sum(0) / n for k, v in g0.items()})

    counter = [0]
    version = [0]                # server model version (accepted uploads)
    x_now = [x]
    clients: Dict[int, Dict[str, Any]] = {}

    def start_compute(i, now):
        """Client i fetches the current model and schedules its upload."""
        gen = rng_lib.fold_in(base, counter[0])
        counter[0] += 1
        tau = float(arrival.sample(rs, 1)[0])
        clients[i] = {"arrival": now + tau, "version": version[0],
                      "x": x_now[0], "rng": gen,
                      "lost": bool(arrival.dropped(rs, 1)[0])}

    for i in range(n):
        start_compute(i, 0.0)

    target = n * rounds
    applied = dropped = discarded = 0
    wall_clock = 0.0
    ages: list = []
    gns_round = []
    while applied < target:
        i = min(clients, key=lambda c: clients[c]["arrival"])
        ev = clients[i]
        now = ev["arrival"]
        if ev["lost"]:                      # dropout: never arrived
            dropped += 1
            start_compute(i, now)
            continue
        age = version[0] - ev["version"]
        if staleness_cap is not None and age > staleness_cap:
            discarded += 1                   # too stale: refetch, recompute
            start_compute(i, now)
            continue
        # the client's EF update against the model it saw
        grads = problem.stoch_grad(ev["x"], ev["rng"], batch_size,
                                   range(i, i + 1))
        grads = {k: v[0] for k, v in grads.items()}
        msg, states[i] = method.update(
            grads, states[i], rng_lib.fold_in(ev["rng"], 1), eta=eta)
        g_server = ef_lib.tree_add(
            g_server, ef_lib.tree_map(lambda c: c / n, msg))
        x_now[0] = {k: p - gamma * g_server[k] for k, p in x_now[0].items()}
        version[0] += 1
        applied += 1
        wall_clock = now
        ages.append(age)
        if applied % n == 0:
            gns_round.append(ef_lib.tree_norm_sq(problem.full_grad(x_now[0])))
        start_compute(i, now)

    ages_arr = np.asarray(ages, dtype=np.int64)
    hist = np.bincount(ages_arr) if ages_arr.size else np.zeros(1, np.int64)
    gns = torch.stack(gns_round).cpu().numpy() if gns_round \
        else np.zeros(0, np.float32)
    return {
        "wall_clock": wall_clock,
        "rounds": rounds,
        "arrivals_applied": applied,
        "arrivals_dropped": dropped,
        "arrivals_discarded": discarded,
        "stale_age_hist": hist,
        "max_staleness": int(ages_arr.max()) if ages_arr.size else 0,
        "mean_staleness": float(ages_arr.mean()) if ages_arr.size else 0.0,
        "grad_norm_sq_per_round": gns,
        "grad_norm_sq": float(gns[-1]) if gns.size else float("nan"),
        "loss": float(problem.loss(x_now[0])),
        "x_final": {k: v.cpu().numpy() for k, v in x_now[0].items()},
        "sync_wall_clock": sync_barrier_wallclock(arrival, n, rounds,
                                                  seed=seed + 1),
    }
