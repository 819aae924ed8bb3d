"""Wire carriers (counterpart of src/repro/core/carriers.py): how the
compressed innovation c of one EF round travels, for the uplink (clients →
server) and the downlink (server → clients) alike.

  DenseCarrier       ``dense``: c ships as a dense d-word tensor; the mean
                     over clients is ``sum(0)/n``.
  SparseBlockCarrier ``sparse``: (values, block-local int32 indices) of the
                     TopK family, 2·nb·kb words a client; the mean is a
                     scatter-ADD over clients.
  FusedPallasCarrier ``fused``: dense wire, and the whole EF21-SGD(M) client
                     chain runs as one launch of the K2 kernel per leaf
                     (kernels/ops.py::ef21_sgdm_update).
  QuantCarrier       ``quant8`` / ``quant4``: per-row absmax scale + int8 or
                     packed-uint4 mantissas through the K5/K6 codec kernels
                     (ops.block_quantize / block_dequantize). The TopK family
                     ships its (nb, kb) selected values quantized with
                     block-local indices (the sparse payload); every other
                     deterministic compressor ships C(δ) quantized in rows of
                     ``qblock`` (the dense payload). Aggregation dequantizes,
                     then means: mantissas under different scales do not add.
  FusedQuantCarrier  ``fused_quant8`` / ``fused_quant4``: the one-launch
                     uplink (K3, ef21_sgdm_topk_quant) ships the block-dense
                     quantized innovation; on the downlink the same payload
                     is integrated by the K4 kernel (dequant_add). Where the
                     mega-kernel does not apply it runs the unfused quantized
                     wire of QuantCarrier.

Plans — ``carrier.plan(method, eta)``: 'dense' (the method's own update,
then the dense mean), 'wire' (pre_compress, then per leaf encode → local_c →
aggregate, then post_compress), 'fused' (K2) and 'fused_wire' (K3).

Wires may carry a leading client axis: ``encode`` takes a flat (d,) leaf or
an (n, d) stack of clients and folds the clients into kernel rows, so one
K5 launch quantizes one leaf for all clients; ``decode`` keeps the leading
axis and ``aggregate`` means over it. Each client's flat leaf is padded to
whole blocks first, so client boundaries and row boundaries coincide. The
fused carriers update the client EF state IN PLACE: the kernels write v' and
g' over v and g (each element is read before its own lane writes it), which
is what keeps the state of eight full-width clients inside one card's
memory. That state is f32 or bfloat16: the fused kernels read and write it
in its dtype (K2's c comes back in it too), and the unfused wires encode
the innovation in f32 and decode to the delta's dtype, as the reference
casts.
"""
from __future__ import annotations

import dataclasses
import functools
import math
from typing import Dict, List, Tuple

import torch

from repro_torch.core import compressors as comp_lib
from repro_torch.kernels import ops

Tree = Dict[str, torch.Tensor]


def _pad_rows(x: torch.Tensor, dp: int, d: int, nb: int, block: int
              ) -> Tuple[torch.Tensor, bool]:
    """(dp·nb, block) row view of a (dp, ...) leaf; pads each client's flat
    leaf to nb·block. Returns (rows, copied) — a view when no pad is needed."""
    flat = x.reshape(dp, d)
    pad = nb * block - d
    if pad == 0:
        return flat.reshape(dp * nb, block), False
    return torch.nn.functional.pad(flat, (0, pad)).reshape(dp * nb, block), True


def _rows(x: torch.Tensor, nb: int, block: int) -> torch.Tensor:
    """The contiguous (n·nb, block) f32 row view of a (..., d) tensor, each
    of its n flat rows padded to nb·block."""
    d = x.shape[-1]
    n = x.numel() // d if d else 1
    return _pad_rows(x.float(), n, d, nb, block)[0].contiguous()


def _unrows(rows: torch.Tensor, lead: torch.Size, d: int) -> torch.Tensor:
    """Inverse of :func:`_rows`: (*lead, d), the pad dropped."""
    n = math.prod(lead)
    return rows.reshape(n, -1)[:, :d].reshape(*lead, d)


def _fused_leaves(method, grads: Tree, state: Dict[str, Tree], eta, launch):
    """Run one fused kernel launch per leaf, clients folded into rows:
    ``launch(grad, v, g, eta=, k=, v_out=, g_out=)`` on (dp·nb, block) rows at
    the kernel geometry, with v' and g' landing in ``state`` IN PLACE (each
    element is read before its own lane writes it; a leaf that needed
    padding is written back from its padded copy). Yields
    (key, grad, block, rest) with ``rest`` the kernel's outputs after
    (v', g')."""
    if method.name == "ef21_sgd":
        eta_f, v_tree = 1.0, state["g"]             # v' = grad exactly
    else:
        eta_f = float(eta) if eta is not None else float(method.eta)
        v_tree = state["v"]
    for key in sorted(grads):
        grad, v, g = grads[key], v_tree[key], state["g"][key]
        dp, d = grad.shape[0], grad[0].numel()
        nb, block, kb = FusedPallasCarrier._kernel_geom(method.compressor, d)
        g_rows, g_copied = _pad_rows(g, dp, d, nb, block)
        v_rows, v_copied = _pad_rows(v, dp, d, nb, block)
        # EF21-SGD keeps no momentum: its v' goes to a scratch tensor
        v_dst = None if method.name == "ef21_sgd" else v_rows
        out = launch(_pad_rows(grad, dp, d, nb, block)[0], v_rows, g_rows,
                     eta=eta_f, k=kb, v_out=v_dst, g_out=g_rows)
        for rows, copied, dst in ((g_rows, g_copied, g),
                                  (v_dst, v_copied, v)):
            if rows is not None and copied:
                dst.copy_(rows.reshape(dp, -1)[:, :d].reshape(dst.shape))
        yield key, grad, block, out[2:]


# ---------------------------------------------------------------------------
# the TopK-family block wire, shared by the sparse and quantized carriers
# ---------------------------------------------------------------------------

def has_block_wire(comp) -> bool:
    """True for the compressors with a deterministic fixed-size (values,
    block-local indices) wire: the TopK family."""
    return (comp.has_sparse_carrier
            and isinstance(comp, (comp_lib.TopK, comp_lib.BlockTopK)))


def sparse_geom(comp, d: int) -> Tuple[int, int, int]:
    """(nb, block, kb) of the fixed-size TopK-family wire for a flat (d,)
    leaf: BlockTopK's d-aware geometry; plain TopK is one block spanning the
    leaf (exact global TopK)."""
    if isinstance(comp, comp_lib.BlockTopK):
        return comp.geom(d)
    if isinstance(comp, comp_lib.TopK):
        return 1, d, comp._k(d)
    raise ValueError(f"no fixed-size sparse wire for {type(comp).__name__}")


def sparse_select(comp, delta: torch.Tensor
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Pad each (d,) row of ``delta`` (d,) or (n, d) to whole blocks and take
    the kb largest |·| per block. Returns (vals, idx), both (*lead, nb, kb),
    idx block-LOCAL (int64) in ``lax.top_k`` order — not
    ``BlockTopK.sparse``, whose indices are global."""
    d, lead = delta.shape[-1], delta.shape[:-1]
    nb, block, kb = sparse_geom(comp, d)
    xb = _rows(delta, nb, block)
    idx = comp_lib.top_order(xb.abs(), kb)
    vals = torch.gather(xb, 1, idx)
    return vals.reshape(*lead, nb, kb), idx.reshape(*lead, nb, kb)


def scatter_blocks(vals: torch.Tensor, idx: torch.Tensor, *, nb: int,
                   block: int, d: int, dtype) -> torch.Tensor:
    """Scatter (*lead, nb, kb) block-wire values back to (*lead, d) — the
    shared decode of the block-sparse wires. ``set`` semantics: indices are
    unique within one wire (the mean over clients scatter-ADDs instead)."""
    lead, kb = vals.shape[:-2], vals.shape[-1]
    n = math.prod(lead)
    buf = torch.zeros((n * nb, block), dtype=dtype, device=vals.device)
    buf.scatter_(1, idx.reshape(n * nb, kb).long(),
                 vals.reshape(n * nb, kb).to(dtype))
    return _unrows(buf, lead, d)


def _scatter_mean(vals: torch.Tensor, idx: torch.Tensor, *, nb: int,
                  block: int, d: int, dtype) -> torch.Tensor:
    """meanᵢ of the clients' (n, nb, kb) block wires as a flat (d,): one
    scatter-add over all clients, then / n. On the CPU the adds run in index
    order (client 0 first); on a card ``index_add_`` uses atomics, so the
    f32 sum order of colliding slots varies from run to run."""
    n = vals.shape[0]
    base = torch.arange(nb, device=vals.device)[None, :, None] * block
    buf = torch.zeros(nb * block, dtype=dtype, device=vals.device)
    buf.index_add_(0, (idx.long() + base).reshape(-1),
                   vals.reshape(-1).to(dtype))
    return (buf / n)[:d]


# ---------------------------------------------------------------------------
# base
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class Carrier:
    name: str = "abstract"

    def plan_with_reason(self, method, eta=None) -> Tuple[str, str]:
        """(plan, reason): plan ∈ 'dense' | 'wire' | 'fused' | 'fused_wire';
        the reason is empty when the carrier's native plan runs."""
        return "dense", "abstract base carrier has no wire format"

    def plan(self, method, eta=None) -> str:
        return self.plan_with_reason(method, eta)[0]

    def plan_down_with_reason(self, comp) -> Tuple[str, str]:
        return "dense", "abstract base carrier has no wire format"

    def plan_down(self, comp) -> str:
        return self.plan_down_with_reason(comp)[0]

    def encode(self, comp, delta: torch.Tensor):
        """delta: flat (d,) or (n, d) clients. Returns the wire of C(delta)."""
        raise NotImplementedError

    def decode(self, comp, wire, *, d: int, dtype) -> torch.Tensor:
        """The dense decode of a wire, (d,) or (n, d). ``local_c`` IS this
        decode, so client state and server aggregate agree on exactly what
        was shipped."""
        raise NotImplementedError

    def local_c(self, comp, delta: torch.Tensor, wire) -> torch.Tensor:
        return self.decode(comp, wire, d=delta.shape[-1], dtype=delta.dtype)

    def local_c_and_mean(self, comp, delta: torch.Tensor, wire, dp: int
                         ) -> Tuple[torch.Tensor, torch.Tensor]:
        """(local_c, aggregate) of the wire of dp clients' (dp, d) deltas."""
        return (self.local_c(comp, delta, wire),
                self.aggregate(comp, wire, d=delta.shape[-1],
                               dtype=delta.dtype, dp=dp))

    def decode_add(self, comp, wire, base: torch.Tensor, *, d: int, dtype
                   ) -> torch.Tensor:
        """``base + decode(wire)`` for a flat (d,) base — the downlink's
        h-integration."""
        return base + self.decode(comp, wire, d=d, dtype=dtype)

    def aggregate(self, comp, wire, *, d: int, dtype, dp: int
                  ) -> torch.Tensor:
        """meanᵢ(cᵢ), a flat (d,), from the wires of dp clients (leading
        axis)."""
        raise NotImplementedError

    def wire_words(self, comp, d: int) -> float:
        """Words one client puts on the wire per message of dimension d."""
        raise NotImplementedError


# ---------------------------------------------------------------------------
# dense
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class DenseCarrier(Carrier):
    """Paper-faithful wire: the dense tensor C(δ) itself."""

    name: str = "dense"

    def plan_with_reason(self, method, eta=None):
        return "dense", ""

    def plan_down_with_reason(self, comp):
        return "dense", ""

    def wire_words(self, comp, d):
        return float(d)


# ---------------------------------------------------------------------------
# sparse block
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class SparseBlockCarrier(Carrier):
    """Fixed-size (values, block-local int32 indices) wire for the TopK
    family: 2·nb·kb words a client; the mean scatter-ADDs over clients."""

    name: str = "sparse"

    def plan_with_reason(self, method, eta=None):
        if not method.wire_is_msg:
            return "dense", (
                f"method {method.name!r} transmits a transform of c "
                "(wire_is_msg=False); a non-dense wire cannot ship it")
        if not self.supports(method.compressor):
            return "dense", (
                f"compressor {type(method.compressor).__name__} has no "
                "deterministic fixed-size (values, indices) wire")
        return "wire", ""

    def plan_down_with_reason(self, comp):
        if not self.supports(comp):
            return "dense", (
                f"compressor {type(comp).__name__} has no deterministic "
                "fixed-size (values, indices) wire")
        return "wire", ""

    def supports(self, comp) -> bool:
        return has_block_wire(comp)

    def encode(self, comp, delta):
        vals, idx = sparse_select(comp, delta)
        return vals.to(delta.dtype), idx.to(torch.int32)

    def decode(self, comp, wire, *, d, dtype):
        vals, idx = wire
        nb, block, _ = sparse_geom(comp, d)
        return scatter_blocks(vals, idx, nb=nb, block=block, d=d, dtype=dtype)

    def aggregate(self, comp, wire, *, d, dtype, dp):
        vals, idx = wire
        nb, block, _ = sparse_geom(comp, d)
        return _scatter_mean(vals, idx, nb=nb, block=block, d=d, dtype=dtype)

    def wire_words(self, comp, d):
        nb, _, kb = sparse_geom(comp, d)
        return 2.0 * nb * kb                             # values + int32 idx


# ---------------------------------------------------------------------------
# fused client update (K2)
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class FusedPallasCarrier(DenseCarrier):
    """Dense wire + the EF21-SGD(M) client chain in one K2 launch per leaf."""

    name: str = "fused"

    _LANES = 128          # the reference's TPU lane rounding (changes padding)

    @classmethod
    def _kernel_geom(cls, comp, d: int) -> Tuple[int, int, int]:
        """The selection geometry with a single-block leaf's launch block
        rounded up to whole 128-lane rows (the reference's padding, which
        the wire words depend on); zeros in the pad never outrank a value."""
        nb, block, kb = comp.geom(d)
        if nb == 1:
            block = -(-block // cls._LANES) * cls._LANES
        return nb, block, kb

    def plan_with_reason(self, method, eta=None):
        if method.name not in ("ef21_sgdm", "ef21_sgd"):
            return "dense", (
                f"the fused kernel implements the EF21-SGD(M) client chain "
                f"only, not {method.name!r}")
        if not isinstance(method.compressor, comp_lib.BlockTopK):
            return "dense", (
                f"the fused kernel compresses with BlockTopK only, not "
                f"{type(method.compressor).__name__}")
        return "fused", ""

    def plan_down_with_reason(self, comp):
        return "dense", (
            "the fused kernel fuses the UPLINK client update; the downlink "
            "broadcast has no fused path — use dense, sparse or quant")

    def fused_update(self, method, grads: Tree, state: Dict[str, Tree], *,
                     eta=None) -> Tuple[Tree, Dict[str, Tree]]:
        """One K2 launch per leaf, clients folded into rows. ``state`` is
        updated in place and returned; returns (c_tree, state)."""
        c_out: Tree = {}
        for key, grad, _, (c,) in _fused_leaves(method, grads, state, eta,
                                                ops.ef21_sgdm_update):
            c_out[key] = c.reshape(grad.shape[0], -1)[:, :grad[0].numel()] \
                .reshape(grad.shape)
        return c_out, state


# ---------------------------------------------------------------------------
# quantized wires (K5 encode, K6 decode)
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class QuantCarrier(Carrier):
    """Block-quantized wire: per-row absmax scale (1 f32 word) + ``bits``-bit
    mantissas, in one of two payloads:

      sparse  for the TopK family: each block's kb selected values,
              quantized against one scale, with block-local indices (int16
              when the block fits, else int32) —
              nb·(1 + kb·(bits/32 + idx_words)) words a client;
      dense   for every other deterministic compressor: C(δ) quantized in
              rows of ``qblock`` — nbq·(1 + qblock·bits/32) words a client.

    ``local_c`` is the decode of the wire, so EF re-sends the quantization
    error in later rounds. Encode launches K5 once per leaf with the clients
    folded into rows; decode and aggregate launch K6, and the wire plan's
    ``local_c_and_mean`` takes both from one K6 launch; the dense payload's
    ``decode_add`` runs K4 (dequantize + add in one launch)."""

    name: str = "quant8"
    bits: int = 8
    qblock: int = 256          # dense-payload quantization row (even)

    def plan_with_reason(self, method, eta=None):
        if not method.wire_is_msg:
            return "dense", (
                f"method {method.name!r} transmits a transform of c "
                "(wire_is_msg=False); a non-dense wire cannot ship it")
        if method.compressor.needs_rng:
            return "dense", (
                f"compressor {type(method.compressor).__name__} draws "
                "randomness inside encode; the quantized wire ships "
                "deterministic compressors only")
        return "wire", ""

    def plan_down_with_reason(self, comp):
        if comp.needs_rng:
            return "dense", (
                f"compressor {type(comp).__name__} draws randomness inside "
                "encode; the quantized wire ships deterministic compressors "
                "only")
        return "wire", ""

    def _payload(self, comp, d: int) -> Tuple[bool, int, int, int]:
        """(sparse, nb, block, cols) of a (d,) leaf's wire: the sparse
        payload quantizes each of nb blocks' kb selected values (cols = kb);
        the dense payload quantizes C(δ) padded to nb rows of cols = block =
        ``qblock``."""
        if has_block_wire(comp):
            nb, block, kb = sparse_geom(comp, d)
            return True, nb, block, kb
        return False, -(-d // self.qblock), self.qblock, self.qblock

    @staticmethod
    def _idx_dtype(block: int) -> torch.dtype:
        return torch.int16 if block <= 2 ** 15 - 1 else torch.int32

    def _dequantize(self, comp, wire, d: int) -> torch.Tensor:
        """K6 on a wire's rows, clients folded in: (rows, cols) f32."""
        q, scales = wire[0], wire[1]
        return ops.block_dequantize(q.reshape(-1, q.shape[-1]),
                                    scales.reshape(-1), self.bits,
                                    self._payload(comp, d)[3])

    def _spread(self, comp, wire, vals, d: int) -> torch.Tensor:
        """The f32 (*lead, d) decode from the wire's dequantized rows."""
        sparse, nb, block, _ = self._payload(comp, d)
        if sparse:
            idx = wire[2]
            return scatter_blocks(vals.reshape(idx.shape), idx, nb=nb,
                                  block=block, d=d, dtype=torch.float32)
        return _unrows(vals, wire[1].shape[:-1], d)

    # -- wire ---------------------------------------------------------------
    def encode(self, comp, delta):
        d, lead = delta.shape[-1], delta.shape[:-1]
        sparse, nb, block, cols = self._payload(comp, d)
        if sparse:
            vals, idx = sparse_select(comp, delta)
            q, scales = ops.block_quantize(vals.reshape(-1, cols), self.bits)
            return (q.reshape(*lead, nb, -1), scales.reshape(*lead, nb),
                    idx.to(self._idx_dtype(block)))
        c = comp.batched(delta.reshape(-1, d))   # C(δ) per client
        q, scales = ops.block_quantize(_rows(c, nb, block), self.bits)
        return q.reshape(*lead, nb, -1), scales.reshape(*lead, nb)

    def decode(self, comp, wire, *, d, dtype):
        vals = self._dequantize(comp, wire, d)
        return self._spread(comp, wire, vals, d).to(dtype)

    def decode_add(self, comp, wire, base, *, d, dtype):
        sparse, _, block, _ = self._payload(comp, d)
        if sparse:                     # the scatter decode has no fused add
            return super().decode_add(comp, wire, base, d=d, dtype=dtype)
        q, scales = wire               # dense payload: K4
        out = ops.dequant_add(q, scales, base.float().contiguous(),
                              block=block, bits=self.bits)
        return out.to(dtype)

    def aggregate(self, comp, wire, *, d, dtype, dp):
        return self._mean(comp, wire, self._dequantize(comp, wire, d), d,
                          dp).to(dtype)

    def local_c_and_mean(self, comp, delta, wire, dp):
        """Both from one K6 launch on the wire; the dense payload's mean is
        the clients' decodes summed."""
        d = delta.shape[-1]
        vals = self._dequantize(comp, wire, d)
        c = self._spread(comp, wire, vals, d)
        mean = (self._mean(comp, wire, vals, d, dp)
                if self._payload(comp, d)[0] else c.sum(0) / dp)
        return c.to(delta.dtype), mean.to(delta.dtype)

    def _mean(self, comp, wire, vals, d: int, dp: int) -> torch.Tensor:
        """meanᵢ of the clients' decodes, f32 (d,), from the dequantized
        rows: the sparse payload scatter-adds, the dense one sums."""
        sparse, nb, block, _ = self._payload(comp, d)
        if sparse:
            idx = wire[2]
            return _scatter_mean(vals.reshape(idx.shape), idx, nb=nb,
                                 block=block, d=d, dtype=torch.float32)
        return self._spread(comp, wire, vals, d).sum(0) / dp

    # -- accounting ---------------------------------------------------------
    def wire_words(self, comp, d):
        frac = self.bits / 32.0                          # 4-bit = 1/8 word
        sparse, nb, block, cols = self._payload(comp, d)
        if sparse:
            idx_words = 0.5 if block <= 2 ** 15 - 1 else 1.0
            return nb * (1.0 + cols * (frac + idx_words))
        return nb * (1.0 + block * frac)

    def quant_eps(self, comp, d: int) -> float:
        """Relative per-message quantization error bound: B elements a scale
        give ‖Q(x) − x‖² ≤ B/(4·qmax²)·‖x‖²."""
        qmax = 2 ** (self.bits - 1) - 1
        if has_block_wire(comp):
            per_scale = sparse_geom(comp, d)[2]
        else:
            per_scale = min(self.qblock, d)
        return per_scale / (4.0 * qmax * qmax)

    def composed_err_factor(self, comp, d: int) -> float:
        """Definition-1 constant of decode∘Q∘C: (√(1−α) + √ε)²."""
        root = ((1.0 - comp.alpha(d)) ** 0.5
                + self.quant_eps(comp, d) ** 0.5)
        return root * root


# ---------------------------------------------------------------------------
# fused quantized wires (K3 up, K4 down)
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class FusedQuantCarrier(QuantCarrier):
    """Quantized wire + the whole uplink client round in one K3 launch.

    Payload for the TopK family: the block-dense quantized innovation at the
    selection geometry, q (nb, block·bits/8 bytes) + one f32 scale per
    selection block — nb·(1 + block·bits/32) words per client. The
    quantization row IS the selection block, so this payload decodes
    bit-identically to the sparse (values, indices) payload. Other
    compressors ship QuantCarrier's dense payload. Where the mega-kernel
    does not apply (another method or compressor, an odd block at 4 bits)
    the plan degrades to the unfused 'wire' plan."""

    name: str = "fused_quant8"

    def _fused_geom(self, comp, d: int) -> Tuple[int, int, int]:
        """The mega-kernel's launch geometry (FusedPallasCarrier._kernel_geom);
        plain TopK is one block spanning the leaf, lane-rounded the same
        way."""
        if isinstance(comp, comp_lib.BlockTopK):
            return FusedPallasCarrier._kernel_geom(comp, d)
        nb, block, kb = sparse_geom(comp, d)
        if nb == 1:
            lanes = FusedPallasCarrier._LANES
            block = -(-block // lanes) * lanes
        return nb, block, kb

    def plan_with_reason(self, method, eta=None):
        plan, reason = super().plan_with_reason(method, eta)
        if plan != "wire":
            return plan, reason                          # dense degradation
        if method.name not in ("ef21_sgdm", "ef21_sgd"):
            return "wire", (
                f"the fused wire kernel implements the EF21-SGD(M) client "
                f"chain only, not {method.name!r}; running the unfused "
                "quantized wire")
        if not isinstance(method.compressor, comp_lib.BlockTopK):
            return "wire", (
                f"the fused wire kernel compresses with BlockTopK only, not "
                f"{type(method.compressor).__name__}; running the unfused "
                "quantized wire")
        if self.bits == 4 and method.compressor.block % 2:
            return "wire", ("uint4 packing needs an even BlockTopK block; "
                            "running the unfused quantized wire")
        return "fused_wire", ""

    def _payload(self, comp, d):
        """The TopK family ships the block-dense payload at the selection
        geometry (a threshold mask, quantized a selection block a row)."""
        if not has_block_wire(comp):
            return super()._payload(comp, d)
        nb, block, _ = self._fused_geom(comp, d)
        return False, nb, block, block

    # -- the one-launch round ------------------------------------------------
    def fused_wire_round(self, method, grads: Tree, state: Dict[str, Tree],
                         *, eta=None) -> Tuple[Tree, Dict[str, Tree]]:
        """The 'fused_wire' plan on clients folded into rows: one K3 launch
        per leaf produces (v', g', wire) with g' = g + decode(wire), then
        one K6 launch dequantizes the wire and the clients are meaned.
        ``state`` is updated in place and returned; returns
        (msg_mean_tree, state)."""
        msg: Tree = {}
        launch = functools.partial(ops.ef21_sgdm_topk_quant, bits=self.bits)
        for key, grad, block, (q, scales) in _fused_leaves(
                method, grads, state, eta, launch):
            dp, d = grad.shape[0], grad[0].numel()
            vals = ops.block_dequantize(q, scales, self.bits, block)
            msg[key] = (vals.reshape(dp, -1)[:, :d].sum(0) / dp).reshape(
                grad.shape[1:]).to(grad.dtype)
        return msg, state


# ---------------------------------------------------------------------------
# the 'wire' plan
# ---------------------------------------------------------------------------

def wire_round_batched(carrier: Carrier, comp, deltas: Tree, dp: int
                       ) -> Tuple[Tree, Tree]:
    """encode → (local_c, aggregate) per leaf, the dp clients on a leading
    axis folded into the codec's kernel rows; one decode of the wire serves
    both. Returns (c_tree, msg_mean_tree)."""
    c_out: Tree = {}
    agg_out: Tree = {}
    for key in sorted(deltas):
        leaf = deltas[key]
        d = leaf[0].numel()
        flat = leaf.reshape(dp, d)
        wire = carrier.encode(comp, flat)
        c, mean = carrier.local_c_and_mean(comp, flat, wire, dp)
        c_out[key] = c.reshape(leaf.shape)
        agg_out[key] = mean.reshape(leaf.shape[1:])
    return c_out, agg_out


# ---------------------------------------------------------------------------
# downlink (server → client broadcast)
# ---------------------------------------------------------------------------

def downlink_encode(carrier: Carrier, comp, delta: Tree) -> List:
    """The per-leaf wires of one broadcast (sorted leaf order): the
    carrier's encode of C(δ) on the 'wire' plan, the dense C(δ) otherwise."""
    plan = carrier.plan_down(comp)
    wires = []
    for key in sorted(delta):
        flat = delta[key].reshape(-1)
        wires.append(carrier.encode(comp, flat) if plan == "wire"
                     else comp(flat).to(flat.dtype))
    return wires


def downlink_apply(carrier: Carrier, comp, wires: List, h: Tree) -> Tree:
    """h' = h + decode(wire), per leaf, through ``Carrier.decode_add``."""
    plan = carrier.plan_down(comp)
    out: Tree = {}
    for wire, key in zip(wires, sorted(h)):
        hl = h[key]
        flat_h = hl.reshape(-1)
        if plan == "wire":
            new = carrier.decode_add(comp, wire, flat_h, d=flat_h.numel(),
                                     dtype=hl.dtype)
        else:
            new = flat_h + wire.to(hl.dtype)
        out[key] = new.reshape(hl.shape).to(hl.dtype)
    return out


def downlink_round_integrate(carrier: Carrier, comp, delta: Tree, h: Tree
                             ) -> Tree:
    return downlink_apply(carrier, comp, downlink_encode(carrier, comp, delta),
                          h)


def downlink_words(carrier: Carrier, comp, d: int) -> float:
    if carrier.plan_down(comp) == "wire":
        return carrier.wire_words(comp, d)
    return float(d)


# ---------------------------------------------------------------------------
# registry
# ---------------------------------------------------------------------------

REGISTRY = {
    "dense": DenseCarrier,
    "sparse": SparseBlockCarrier,
    "fused": FusedPallasCarrier,
    "quant8": lambda: QuantCarrier(name="quant8", bits=8),
    "quant4": lambda: QuantCarrier(name="quant4", bits=4),
    "fused_quant8": lambda: FusedQuantCarrier(name="fused_quant8", bits=8),
    "fused_quant4": lambda: FusedQuantCarrier(name="fused_quant4", bits=4),
}


def make(name) -> Carrier:
    if isinstance(name, Carrier):
        return name
    if name not in REGISTRY:
        raise ValueError(f"unknown carrier {name!r}; have {sorted(REGISTRY)}")
    return REGISTRY[name]()
