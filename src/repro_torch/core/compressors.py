"""Compression operators (counterpart of src/repro/core/compressors.py).

Compressors act on flat 1-D tensors and return a dense tensor of the same
shape, C(x); the TopK family also exposes ``sparse()``, the fixed-size
(values, indices) form. This slice ports the six deterministic compressors
of the reference. ``randk`` and ``natural`` draw randomness inside
``__call__``: they arrive with the slice that threads a ``torch.Generator``
through ``ef_round`` (ROADMAP Queue 1), and naming one raises
``NotImplementedError``.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch

from repro_torch.kernels import ops


def _k_for(size: int, ratio: float, k: Optional[int]) -> int:
    if k is not None:
        return max(1, min(int(k), size))
    return max(1, min(size, int(round(ratio * size))))


def top_order(ab: torch.Tensor, k: int) -> torch.Tensor:
    """Indices of the k largest entries of each row of ``ab`` in
    ``lax.top_k``'s order: by value, the lower index first among equal
    values (a stable sort; ``torch.topk`` promises no order among ties)."""
    return torch.sort(ab, dim=-1, descending=True, stable=True).indices[..., :k]


@dataclasses.dataclass(frozen=True)
class Compressor:
    """Base class. Subclasses implement ``__call__``."""

    def __call__(self, x: torch.Tensor) -> torch.Tensor:
        raise NotImplementedError

    def alpha(self, d: int) -> float:
        """Contraction parameter α for a d-dimensional input (1 = lossless)."""
        return 1.0

    @property
    def is_contractive(self) -> bool:
        return True

    @property
    def has_sparse_carrier(self) -> bool:
        return False

    @property
    def needs_rng(self) -> bool:
        """True iff ``__call__`` draws randomness — such compressors cannot
        ride the deterministic wire formats (the carriers degrade to dense)."""
        return False

    def batched(self, x: torch.Tensor) -> torch.Tensor:
        """C applied to each row of an (n, d) tensor (one client a row)."""
        return torch.stack([self(r) for r in x])


@dataclasses.dataclass(frozen=True)
class Identity(Compressor):
    """C(x) = x. α = 1; EF21-SGDM with Identity reduces to plain SGDM."""

    def __call__(self, x):
        return x

    def batched(self, x):
        return x


@dataclasses.dataclass(frozen=True)
class TopK(Compressor):
    """Greedy TopK: keep the K largest |x|. α = K/d. ``__call__`` is the
    threshold mask (ties at the K-th magnitude are all kept)."""

    ratio: float = 0.01
    k: Optional[int] = None

    def _k(self, d: int) -> int:
        return _k_for(d, self.ratio, self.k)

    def alpha(self, d: int) -> float:
        return self._k(d) / d

    @property
    def has_sparse_carrier(self) -> bool:
        return True

    def sparse(self, x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        """(values, int32 indices) of the K largest |x|, in ``lax.top_k``
        order."""
        idx = top_order(x.abs(), self._k(x.numel()))
        return x[idx], idx.to(torch.int32)

    def __call__(self, x):
        ax = x.abs()
        thresh = torch.topk(ax, self._k(x.numel())).values[-1]
        return torch.where(ax >= thresh, x, torch.zeros_like(x))


@dataclasses.dataclass(frozen=True)
class BlockTopK(Compressor):
    """Exact TopK *within* contiguous blocks (the reference's DESIGN.md §4):
    Definition 1 with α = K_b/B. ``__call__`` keeps, per block, every entry
    whose magnitude reaches the kb-th largest (ties at the threshold are all
    kept: the reference's threshold-mask rule, not exactly-k)."""

    ratio: float = 0.01
    block: int = 1024
    k_per_block: Optional[int] = None

    def geom(self, d: int) -> Tuple[int, int, int]:
        """(nb, block_eff, kb): a leaf smaller than one block is one block of
        its own size with a proportional budget; larger leaves use the
        configured block."""
        block = min(self.block, max(1, int(d)))
        if self.k_per_block is not None:
            kb = max(1, min(self.k_per_block, block))
        else:
            kb = max(1, min(block, int(round(self.ratio * block))))
        nb = -(-d // block) if d > 0 else 1
        return nb, block, kb

    def alpha(self, d: int) -> float:
        _, block, kb = self.geom(d)
        return kb / block

    @property
    def has_sparse_carrier(self) -> bool:
        return True

    def _blocks(self, x: torch.Tensor) -> torch.Tensor:
        nb, block, _ = self.geom(x.numel())
        return torch.nn.functional.pad(
            x.reshape(-1), (0, nb * block - x.numel())).reshape(nb, block)

    def sparse(self, x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        """(values, flat int32 indices) of the kb largest |x| per block, in
        ``lax.top_k`` order."""
        xb = self._blocks(x)
        _, block, kb = self.geom(x.numel())
        idx = top_order(xb.abs(), kb)
        vals = torch.gather(xb, 1, idx)
        gidx = idx + torch.arange(xb.shape[0], device=x.device)[:, None] * block
        return vals.reshape(-1), gidx.reshape(-1).to(torch.int32)

    def __call__(self, x):
        xb = self._blocks(x)
        ab = xb.abs()
        thresh = torch.topk(ab, self.geom(x.numel())[2], dim=1).values[:, -1:]
        out = torch.where(ab >= thresh, xb, torch.zeros_like(xb))
        return out.reshape(-1)[: x.numel()].reshape(x.shape)


@dataclasses.dataclass(frozen=True)
class HardThreshold(Compressor):
    """C(x) = x·1{|x| ≥ λ}: an *absolute* compressor (Definition 2) with
    Δ = λ√d, used by EF21-SGDM-abs (Algorithm 4)."""

    lam: float = 1e-3

    @property
    def is_contractive(self) -> bool:
        return False

    def delta(self, d: int) -> float:
        return self.lam * (d ** 0.5)

    def __call__(self, x):
        return torch.where(x.abs() >= self.lam, x, torch.zeros_like(x))

    def batched(self, x):
        return self(x)


@dataclasses.dataclass(frozen=True)
class Rank1(Compressor):
    """PowerSGD-style rank-1 approximation: one power iteration on the
    (r × m) reshape of x, r = min(rows, d)."""

    rows: int = 64

    def alpha(self, d: int) -> float:
        return 1.0 / max(2, min(self.rows, d // max(1, self.rows)))

    def __call__(self, x):
        d = x.numel()
        r = min(self.rows, d)
        m = -(-d // r)
        M = torch.nn.functional.pad(x.reshape(-1), (0, r * m - d)).reshape(r, m)
        v = torch.ones((m,), dtype=x.dtype, device=x.device) / torch.sqrt(
            torch.tensor(float(m), dtype=x.dtype))
        u = M @ v
        u = u / torch.clamp(torch.linalg.vector_norm(u), min=1e-12)
        v = M.T @ u
        return torch.outer(u, v).reshape(-1)[:d].reshape(x.shape)


@dataclasses.dataclass(frozen=True)
class BlockQuant(Compressor):
    """Per-block absmax quantization as a compressor: C(x) =
    dequantize(quantize(x)) with ``bits``-bit mantissas and one f32 scale per
    ``block`` elements, through the K5/K6 codec (kernels/ops.py). Biased;
    contractive with α = 1 − block/(4·qmax²) when that is positive."""

    bits: int = 8
    block: int = 256

    def alpha(self, d: int) -> float:
        qmax = 2 ** (self.bits - 1) - 1
        return max(0.0, 1.0 - min(self.block, d) / (4.0 * qmax * qmax))

    @property
    def is_contractive(self) -> bool:
        return self.alpha(self.block) > 0.0

    def __call__(self, x):
        d = x.numel()
        nb = -(-d // self.block)
        xb = torch.nn.functional.pad(x.reshape(-1).float(),
                                     (0, nb * self.block - d))
        q, scales = ops.block_quantize(xb.reshape(nb, self.block), self.bits)
        deq = ops.block_dequantize(q, scales, self.bits, self.block)
        return deq.reshape(-1)[:d].reshape(x.shape).to(x.dtype)


REGISTRY = {
    "identity": Identity,
    "topk": TopK,
    "block_topk": BlockTopK,
    "hard_threshold": HardThreshold,
    "rank1": Rank1,
    "block_quant": BlockQuant,
}

# compressors that draw randomness: they wait for the rng plumbing
_LATER = ("randk", "natural")


def make(name: str, **kwargs) -> Compressor:
    if name in _LATER:
        raise NotImplementedError(
            f"compressor {name!r} draws randomness and is not ported yet "
            f"(this port runs {sorted(REGISTRY)}); it arrives with the later "
            "slice that threads a torch.Generator through ef_round "
            "(ROADMAP Queue 1)")
    if name not in REGISTRY:
        raise ValueError(f"unknown compressor {name!r}; have "
                         f"{sorted(REGISTRY)}")
    return REGISTRY[name](**kwargs)
