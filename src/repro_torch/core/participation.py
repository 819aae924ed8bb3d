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

``mode='async'`` names the reference's event-driven simulator
(``run_async``), which arrives with the simulator slice of the port
(ROADMAP Queue 1); the synchronous runtime refuses it.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, Tuple

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
