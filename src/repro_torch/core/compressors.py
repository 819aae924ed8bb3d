"""Compression operators (counterpart of src/repro/core/compressors.py).

This slice ports the ``Compressor`` base and ``BlockTopK``, the compressor of
the EF21-SGDM main path; the other seven compressors of the reference
arrive with a later slice (ROADMAP Queue 1). Compressors act on flat 1-D
tensors and return a dense tensor of the same shape, C(x).
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch


@dataclasses.dataclass(frozen=True)
class Compressor:
    """Base class. Subclasses implement ``__call__``."""

    def __call__(self, x: torch.Tensor) -> torch.Tensor:
        raise NotImplementedError

    def alpha(self, d: int) -> float:
        """Contraction parameter α for a d-dimensional input (1 = lossless)."""
        return 1.0


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

    def _blocks(self, x: torch.Tensor) -> torch.Tensor:
        nb, block, _ = self.geom(x.numel())
        return torch.nn.functional.pad(
            x.reshape(-1), (0, nb * block - x.numel())).reshape(nb, block)

    def sparse(self, x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        """(values, flat int32 indices) of the kb largest |x| per block, in
        magnitude order; among equal magnitudes the lower index comes first
        (``lax.top_k``'s order — a stable sort, since ``torch.topk`` promises
        no order among ties)."""
        xb = self._blocks(x)
        _, block, kb = self.geom(x.numel())
        idx = torch.sort(xb.abs(), dim=1, descending=True,
                         stable=True).indices[:, :kb]
        vals = torch.gather(xb, 1, idx)
        gidx = idx + torch.arange(xb.shape[0], device=x.device)[:, None] * block
        return vals.reshape(-1), gidx.reshape(-1).to(torch.int32)

    def __call__(self, x: torch.Tensor) -> torch.Tensor:
        xb = self._blocks(x)
        ab = xb.abs()
        thresh = torch.topk(ab, self.geom(x.numel())[2], dim=1).values[:, -1:]
        out = torch.where(ab >= thresh, xb, torch.zeros_like(xb))
        return out.reshape(-1)[: x.numel()].reshape(x.shape)


REGISTRY = {"block_topk": BlockTopK}


def make(name: str, **kwargs) -> Compressor:
    if name not in REGISTRY:
        raise NotImplementedError(
            f"compressor {name!r} is not ported yet (this port runs "
            f"{sorted(REGISTRY)}); it arrives with a later slice "
            "(ROADMAP Queue 1)")
    return REGISTRY[name](**kwargs)
