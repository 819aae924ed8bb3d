"""Compression operators (counterpart of src/repro/core/compressors.py).

Compressors act on flat 1-D tensors and return a dense tensor of the same
shape, C(x); the TopK family also exposes ``sparse()``, the fixed-size
(values, indices) form. Randomized compressors (``RandK``,
``NaturalCompression``) draw from the ``torch.Generator`` they are given,
on the tensor's device (core/rng.py); deterministic ones ignore it.
``batched`` applies C to each row of an (n, d) stack of clients in one
pass, and a randomized compressor draws all the rows' randomness in one
call.
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


def _uniform(shape, rng: torch.Generator, device, rows=None
             ) -> torch.Tensor:
    """U[0, 1) of ``shape`` from ``rng``. ``rows=(n, row)`` with a ``shape``
    of one row: row ``row`` of an (n, *shape[1:]) draw, the uniforms a
    batched call for n clients gives that client (the whole draw is taken
    from the stream, only the row is kept)."""
    if rows is None:
        return torch.rand(shape, generator=rng, device=device)
    n, row = rows
    return torch.rand((n, *shape[1:]), generator=rng,
                      device=device)[row:row + 1]


@dataclasses.dataclass(frozen=True)
class Compressor:
    """Base class. Subclasses implement ``__call__``."""

    def __call__(self, x: torch.Tensor,
                 rng: Optional[torch.Generator] = None) -> torch.Tensor:
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

    def batched(self, x: torch.Tensor,
                rng: Optional[torch.Generator] = None) -> torch.Tensor:
        """C applied to each row of an (n, d) tensor (one client a row), in
        one pass (``torch.func.vmap``; a compressor that launches a kernel
        or draws randomness folds the rows itself)."""
        return torch.func.vmap(self)(x)


@dataclasses.dataclass(frozen=True)
class Identity(Compressor):
    """C(x) = x. α = 1; EF21-SGDM with Identity reduces to plain SGDM."""

    def __call__(self, x, rng=None):
        return x

    def batched(self, x, rng=None):
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

    def __call__(self, x, rng=None):
        ax = x.abs()
        thresh = torch.topk(ax, self._k(x.numel())).values[-1]
        return torch.where(ax >= thresh, x, torch.zeros_like(x))

    def batched(self, x, rng=None):
        # each row's threshold mask, as __call__ on the row
        ax = x.abs()
        thresh = torch.topk(ax, self._k(x.shape[1]), dim=1).values[:, -1:]
        return torch.where(ax >= thresh, x, torch.zeros_like(x))


@dataclasses.dataclass(frozen=True)
class RandK(Compressor):
    """Uniformly random K-sparsification: K coordinates drawn without
    replacement. ``scaled=False`` is contractive with α = K/d;
    ``scaled=True`` multiplies the kept values by d/K, which makes C
    unbiased (E‖C(x) − x‖² = (d/K − 1)‖x‖², not contractive for K < d/2).
    A row's K coordinates are those of its K largest uniform keys, so all
    rows of a batch draw in one call."""

    ratio: float = 0.01
    k: Optional[int] = None
    scaled: bool = False

    def _k(self, d: int) -> int:
        return _k_for(d, self.ratio, self.k)

    def alpha(self, d: int) -> float:
        return self._k(d) / d if not self.scaled else 0.0

    @property
    def is_contractive(self) -> bool:
        return not self.scaled

    @property
    def has_sparse_carrier(self) -> bool:
        return True

    @property
    def needs_rng(self) -> bool:
        return True

    def _draw(self, x: torch.Tensor, rng, rows=None
              ) -> Tuple[torch.Tensor, torch.Tensor]:
        """(values, int64 indices), each (n, K), of an (n, d) stack
        (``rows``: see :func:`_uniform`)."""
        if rng is None:
            raise ValueError("RandK draws its coordinates: pass a "
                             "torch.Generator")
        n, d = x.shape
        k = self._k(d)
        keys = _uniform((n, d), rng, x.device, rows)
        idx = torch.topk(keys, k, dim=1, sorted=False).indices
        vals = torch.gather(x, 1, idx)
        if self.scaled:
            vals = vals * torch.tensor(d / k, dtype=x.dtype)
        return vals, idx

    def sparse(self, x: torch.Tensor, rng=None
               ) -> Tuple[torch.Tensor, torch.Tensor]:
        """(values, int32 indices) of K coordinates of a flat x."""
        vals, idx = self._draw(x.reshape(1, -1), rng)
        return vals[0], idx[0].to(torch.int32)

    def __call__(self, x, rng=None):
        return self.batched(x.reshape(1, -1), rng).reshape(x.shape)

    def batched(self, x, rng=None, rows=None):
        vals, idx = self._draw(x, rng, rows)
        return torch.zeros_like(x).scatter_(1, idx, vals)


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

    def __call__(self, x, rng=None):
        return self.batched(x.reshape(1, -1)).reshape(x.shape)

    def batched(self, x, rng=None):
        # every row's blocks folded into the rows of one threshold mask
        n, d = x.shape
        nb, block, kb = self.geom(d)
        xb = torch.nn.functional.pad(x, (0, nb * block - d)).reshape(
            n * nb, block)
        ab = xb.abs()
        thresh = torch.topk(ab, kb, dim=1).values[:, -1:]
        out = torch.where(ab >= thresh, xb, torch.zeros_like(xb))
        return out.reshape(n, nb * block)[:, :d]


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

    def __call__(self, x, rng=None):
        return torch.where(x.abs() >= self.lam, x, torch.zeros_like(x))

    def batched(self, x, rng=None):
        return self(x)


@dataclasses.dataclass(frozen=True)
class NaturalCompression(Compressor):
    """Natural compression: |x| rounded at random to one of the two powers
    of two around it, with the probabilities that make C unbiased (sign
    and exponent kept, the mantissa dropped: 9 bits a coordinate). E‖C(x) −
    x‖² ≤ ‖x‖²/8, so Definition 1 holds with α = 7/8."""

    def alpha(self, d: int) -> float:
        return 7.0 / 8.0

    @property
    def needs_rng(self) -> bool:
        return True

    def __call__(self, x, rng=None, rows=None):
        if rng is None:
            raise ValueError("NaturalCompression rounds at random: pass a "
                             "torch.Generator")
        ax = x.abs()
        lo = torch.where(ax > 0, torch.exp2(torch.floor(torch.log2(
            torch.clamp(ax, min=1e-38)))), torch.zeros_like(ax))
        hi = 2.0 * lo
        p_hi = torch.where(lo > 0, (ax - lo) / torch.clamp(hi - lo, min=1e-38),
                           torch.zeros_like(ax))
        u = _uniform(x.shape, rng, x.device, rows)
        mag = torch.where(u < p_hi, hi, lo)
        return (torch.sign(x) * mag).to(x.dtype)

    def batched(self, x, rng=None, rows=None):
        return self(x, rng, rows)


@dataclasses.dataclass(frozen=True)
class Rank1(Compressor):
    """PowerSGD-style rank-1 approximation: one power iteration on the
    (r × m) reshape of x, r = min(rows, d)."""

    rows: int = 64

    def alpha(self, d: int) -> float:
        return 1.0 / max(2, min(self.rows, d // max(1, self.rows)))

    def __call__(self, x, rng=None):
        return self.batched(x.reshape(1, -1)).reshape(x.shape)

    def batched(self, x, rng=None):
        # the products as broadcast multiplies and sums, whose order does
        # not depend on the number of rows: a row's result is the same
        # alone or among others (a batched matmul may sum otherwise)
        n, d = x.shape
        r = min(self.rows, d)
        m = -(-d // r)
        M = torch.nn.functional.pad(x, (0, r * m - d)).reshape(n, r, m)
        v = torch.ones((n, 1, m), dtype=x.dtype, device=x.device) / \
            torch.sqrt(torch.tensor(float(m), dtype=x.dtype))
        u = (M * v).sum(-1, keepdim=True)                      # (n, r, 1)
        u = u / torch.clamp(torch.linalg.vector_norm(u, dim=1, keepdim=True),
                            min=1e-12)
        v = (M * u).sum(-2, keepdim=True)                      # (n, 1, m)
        return (u * v).reshape(n, r * m)[:, :d]


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

    def __call__(self, x, rng=None):
        return self.batched(x.reshape(1, -1)).reshape(x.shape)

    def batched(self, x, rng=None):
        # the codec works row by row, so the n rows' blocks fold into the
        # rows of one K5 and one K6 launch
        n, d = x.shape
        nb = -(-d // self.block)
        xb = torch.nn.functional.pad(x.float(), (0, nb * self.block - d))
        q, scales = ops.block_quantize(xb.reshape(n * nb, self.block),
                                       self.bits)
        deq = ops.block_dequantize(q, scales, self.bits, self.block)
        return deq.reshape(n, nb * self.block)[:, :d].to(x.dtype)


@dataclasses.dataclass(frozen=True)
class ClientRow(Compressor):
    """A randomized compressor as client ``row`` of ``n`` sees it inside a
    batched draw: the generator yields the whole (n, d) stack's uniforms,
    as the single-device round's one call for all n clients does, and this
    client's one row is compressed with its row of them. The sharded
    runtime wraps a compressor that draws in it, so the client a rank holds
    compresses with exactly the stream the single-device round gives that
    client; only the uniforms are drawn n times over, not the compression."""

    base: Compressor = Identity()
    n: int = 1
    row: int = 0

    def __call__(self, x, rng=None):
        return self.batched(x.reshape(1, -1), rng).reshape(x.shape)

    def alpha(self, d: int) -> float:
        return self.base.alpha(d)

    @property
    def needs_rng(self) -> bool:
        return self.base.needs_rng

    def batched(self, x, rng=None):
        if x.shape[0] != 1:
            raise ValueError(f"ClientRow compresses one client's row, got "
                             f"{tuple(x.shape)}")
        return self.base.batched(x, rng, rows=(self.n, self.row))


REGISTRY = {
    "identity": Identity,
    "topk": TopK,
    "randk": RandK,
    "block_topk": BlockTopK,
    "hard_threshold": HardThreshold,
    "natural": NaturalCompression,
    "rank1": Rank1,
    "block_quant": BlockQuant,
}


def make(name: str, **kwargs) -> Compressor:
    if name not in REGISTRY:
        raise ValueError(f"unknown compressor {name!r}; have "
                         f"{sorted(REGISTRY)}")
    return REGISTRY[name](**kwargs)
