"""Wire carriers (counterpart of src/repro/core/carriers.py): how the
compressed innovation c of one EF round travels, for the uplink (clients →
server) and the downlink (server → clients) alike.

This slice ports:

  DenseCarrier       ``dense``: c ships as a dense d-word tensor; the mean
                     over clients is ``sum(0)/n``.
  FusedPallasCarrier ``fused``: dense wire, and the whole EF21-SGD(M) client
                     chain runs as one launch of the K2 kernel per leaf
                     (kernels/ops.py::ef21_sgdm_update).
  FusedQuantCarrier  ``fused_quant8`` / ``fused_quant4``: the one-launch
                     uplink (K3, ef21_sgdm_topk_quant) ships the block-dense
                     quantized innovation; on the downlink the same payload
                     is integrated by the K4 kernel (dequant_add).

The carriers ``sparse``, ``quant8`` and ``quant4`` arrive with a later slice
(ROADMAP Queue 1); naming one raises ``NotImplementedError``.

Leaves with a leading client axis ("batched", the single-device runtime)
fold the clients into kernel rows: each client's flat leaf is padded to
whole blocks first, so client boundaries and row boundaries coincide and
one launch covers one leaf for all clients. The fused carriers update the
client EF state IN PLACE: the kernels write v' and g' over v and g (each
element is read before its own lane writes it), which is what keeps the
state of eight full-width clients inside one card's memory.
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Dict, List, Tuple

import torch

from repro_torch.core import compressors as comp_lib
from repro_torch.kernels import ops
from repro_torch.kernels import ref as kref

Tree = Dict[str, torch.Tensor]

_LATER = ("sparse", "quant8", "quant4")


def _pad_rows(x: torch.Tensor, dp: int, d: int, nb: int, block: int
              ) -> Tuple[torch.Tensor, bool]:
    """(dp·nb, block) row view of a (dp, ...) leaf; pads each client's flat
    leaf to nb·block. Returns (rows, copied) — a view when no pad is needed."""
    flat = x.reshape(dp, d)
    pad = nb * block - d
    if pad == 0:
        return flat.reshape(dp * nb, block), False
    return torch.nn.functional.pad(flat, (0, pad)).reshape(dp * nb, block), True


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


@dataclasses.dataclass(frozen=True)
class Carrier:
    name: str = "abstract"

    def plan_with_reason(self, method, eta=None) -> Tuple[str, str]:
        """(plan, reason): plan ∈ 'dense' | 'fused' | 'fused_wire'; the
        reason is empty when the carrier's native plan runs."""
        return "dense", "abstract base carrier has no wire format"

    def plan(self, method, eta=None) -> str:
        return self.plan_with_reason(method, eta)[0]

    def plan_down_with_reason(self, comp) -> Tuple[str, str]:
        return "dense", "abstract base carrier has no wire format"

    def plan_down(self, comp) -> str:
        return self.plan_down_with_reason(comp)[0]

    def wire_words(self, comp, d: int) -> float:
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
# fused quantized wires (K3 up, K4 down)
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class FusedQuantCarrier(Carrier):
    """Quantized wire + the whole uplink client round in one K3 launch.

    Payload: the block-dense quantized innovation at the selection geometry,
    q (nb, block·bits/8 bytes) + one f32 scale per selection block —
    nb·(1 + block·bits/32) words per client. The quantization row IS the
    selection block, so this payload decodes bit-identically to the sparse
    (values, indices) payload. Aggregation dequantizes, then means over
    clients in f32 (mantissas under different scales do not add)."""

    name: str = "fused_quant8"
    bits: int = 8

    def _fused_geom(self, comp, d: int) -> Tuple[int, int, int]:
        return FusedPallasCarrier._kernel_geom(comp, d)

    def plan_with_reason(self, method, eta=None):
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

    def plan_down_with_reason(self, comp):
        return "wire", ""          # the broadcast IS the compressed innovation

    # -- wire (block-dense payload at the BlockTopK selection geometry) -------
    def encode(self, comp, delta):
        nb, block, _ = self._fused_geom(comp, delta.numel())
        c = comp(delta).float()                       # threshold-mask C(δ)
        cb = torch.nn.functional.pad(c, (0, nb * block - c.numel()))
        return kref.block_quantize_ref(cb.reshape(nb, block), self.bits)

    def decode(self, comp, wire, *, d, dtype):
        q, scales = wire
        _, block, _ = self._fused_geom(comp, d)
        vals = kref.block_dequantize_ref(q, scales, bits=self.bits,
                                         cols=block)
        return vals.reshape(-1)[:d].to(dtype)

    def decode_add(self, comp, wire, base, *, d, dtype):
        """h + decode(wire) in one K4 launch (the plain version on CPU)."""
        q, scales = wire
        _, block, _ = self._fused_geom(comp, d)
        out = ops.dequant_add(q, scales, base.float().contiguous(),
                              block=block, bits=self.bits)
        return out.to(dtype)

    def wire_words(self, comp, d):
        nb, block, _ = self._fused_geom(comp, d)
        return nb * (1.0 + block * self.bits / 32.0)

    # -- the one-launch round ------------------------------------------------
    def fused_wire_round(self, method, grads: Tree, state: Dict[str, Tree],
                         *, eta=None) -> Tuple[Tree, Dict[str, Tree]]:
        """The 'fused_wire' plan on clients folded into rows: one K3 launch
        per leaf produces (v', g', wire) with g' = g + decode(wire), then
        the wire is dequantized and meaned over clients. ``state`` is updated
        in place and returned; returns (msg_mean_tree, state)."""
        msg: Tree = {}
        launch = functools.partial(ops.ef21_sgdm_topk_quant, bits=self.bits)
        for key, grad, block, (q, scales) in _fused_leaves(
                method, grads, state, eta, launch):
            dp, d = grad.shape[0], grad[0].numel()
            vals = kref.block_dequantize_ref(q, scales, bits=self.bits,
                                             cols=block)
            msg[key] = (vals.reshape(dp, -1)[:, :d].sum(0) / dp).reshape(
                grad.shape[1:]).to(grad.dtype)
        return msg, state


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
    "fused": FusedPallasCarrier,
    "fused_quant8": lambda: FusedQuantCarrier(name="fused_quant8", bits=8),
    "fused_quant4": lambda: FusedQuantCarrier(name="fused_quant4", bits=4),
}


def make(name: str) -> Carrier:
    if name in _LATER:
        raise NotImplementedError(
            f"carrier {name!r} is not ported yet (this port runs "
            f"{sorted(REGISTRY)}); it arrives with a later slice "
            "(ROADMAP Queue 1)")
    if name not in REGISTRY:
        raise ValueError(f"unknown carrier {name!r}; have {sorted(REGISTRY)}")
    return REGISTRY[name]()
