"""Random streams of the port (counterpart of the reference's threaded
``jax.random`` keys).

The reference threads one PRNG key through a round and derives every other
stream from it by ``fold_in``: the per-leaf keys of a compressor, the
downlink's (``DOWNLINK_FOLD``), each pod's cross hop (``CROSS_FOLD``), each
group of a schedule. The port threads a ``torch.Generator`` instead and
derives the same tree of streams as sub-seeds: :func:`fold_in` gives a new
generator, on the parent's device, seeded with a hash of the parent's seed
and the folded value. Nothing is drawn to derive a stream, so deriving one
never waits for the device. A round's generator is a pure function of
``(seed, step)`` (:func:`round_generator`), as the reference's
``fold_in(PRNGKey(seed), step)`` is, so a resumed run replays the same
stream. The streams are the port's own: threefry keys do not carry over,
and randomized runs are held to the reference statistically.
"""
from __future__ import annotations

from typing import Optional

import torch

_MASK64 = (1 << 64) - 1
# the stream of a run's initial gradients (Alg 1 line 2), folded off the
# run's base generator beyond any step or compute index
INIT_FOLD = 1 << 40


def _mix(z: int) -> int:
    """SplitMix64's finalizer: a bijection of 64-bit words that spreads
    every input bit over the output."""
    z = (z + 0x9E3779B97F4A7C15) & _MASK64
    z = ((z ^ (z >> 30)) * 0xBF58476D1CE4E5B9) & _MASK64
    z = ((z ^ (z >> 27)) * 0x94D049BB133111EB) & _MASK64
    return z ^ (z >> 31)


def derive(seed: int, *data: int) -> int:
    """The sub-seed of ``seed`` folded with each of ``data`` in turn, a
    63-bit word (every device's generator takes it)."""
    s = _mix(int(seed) & _MASK64)
    for d in data:
        s = _mix(s ^ _mix(int(d) & _MASK64))
    return s >> 1


def generator(seed: int, device=None) -> torch.Generator:
    """A generator on ``device`` (the CPU when None) seeded with ``seed``."""
    dev = torch.device("cpu" if device is None else device)
    return torch.Generator(device=dev).manual_seed(int(seed))


def fold_in(gen: Optional[torch.Generator], data: int
            ) -> Optional[torch.Generator]:
    """``jax.random.fold_in``: a new, independent stream derived from
    ``gen``'s seed and ``data``, on ``gen``'s device; None stays None (no
    stream to fold). ``gen`` itself is not advanced."""
    if gen is None:
        return None
    return generator(derive(gen.initial_seed(), data), gen.device)


def round_generator(seed: int, step: int, device=None) -> torch.Generator:
    """The stream of round ``step`` of a run seeded ``seed``."""
    return generator(derive(seed, step), device)
