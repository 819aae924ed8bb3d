"""RunSpec: the declarative, serializable name of one experiment
(counterpart of src/repro/launch/spec.py, a copy of its schema, not an
import).

The port's RunSpec has the reference's field names, defaults and JSON
(schema v5), so ``results/specs/*.json`` load as they are. It accepts only
what the port runs — smollm-360m, seven EF methods, the six deterministic
compressors, the seven carriers (``fused`` uplink only), the single-device
"smoke" mesh and plain SGD — and rejects everything else loudly at
construction. ``compressor_kw`` must map names to JSON scalars; which names
the compressor takes is checked where it is built (launch/build.py).
``spec_hash`` parity with the reference waits for a later slice.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
from typing import Any, Dict, List, Optional

from repro_torch.configs import base as cb

SCHEMA_VERSION = 5

METHODS = frozenset({"ef21_sgd", "ef21_sgdm", "ef21_sgd2m", "ef21_sgdm_abs",
                     "ef14_sgd", "sgdm", "sgd"})
COMPRESSORS = frozenset({"identity", "topk", "block_topk", "hard_threshold",
                         "rank1", "block_quant"})
FUSED_CARRIERS = frozenset({"fused", "fused_quant8", "fused_quant4"})
CARRIERS = frozenset({"dense", "sparse", "quant8", "quant4"}) | FUSED_CARRIERS
# the fused kernel fuses the uplink client update: no fused downlink
DOWN_CARRIERS = CARRIERS - {"fused"}
OPTIMIZERS = frozenset({"sgd"})
MAX_FUSED_BLOCK = 1024    # widest row of the fused kernels (kernels/ops.py)
_JSON_SCALARS = (bool, int, float, str, type(None))

_LATER = "arrives with a later slice of the port (ROADMAP Queue 1)"


@dataclasses.dataclass(frozen=True)
class RunSpec:
    """The reference's RunSpec fields and defaults; see the module doc for
    what this slice accepts."""

    version: int = SCHEMA_VERSION
    arch: str = "smollm-360m"
    smoke: bool = False
    shape: Optional[str] = None
    seq_len: int = 256
    global_batch: int = 16
    mesh: str = "smoke"
    client_granularity: str = "group"
    state_sharding: str = "client"
    ef_state_dtype: Optional[str] = None
    clients: int = 8
    method: str = "ef21_sgdm"
    compressor: str = "block_topk"
    ratio: float = 0.05
    eta: float = 0.1
    carrier: str = "dense"
    downlink_carrier: str = "dense"
    downlink_ratio: float = 0.05
    groups: List[Dict[str, Any]] = dataclasses.field(default_factory=list)
    overlap: bool = False
    participation: Dict[str, Any] = dataclasses.field(default_factory=dict)
    hops: Dict[str, Any] = dataclasses.field(default_factory=dict)
    method_kw: Dict[str, Any] = dataclasses.field(default_factory=dict)
    compressor_kw: Dict[str, Any] = dataclasses.field(default_factory=dict)
    tp_pad_heads: int = 0
    moe_impl: str = "dispatch"
    optimizer: str = "sgd"
    lr: float = 0.5
    heterogeneity: float = 0.5
    seed: int = 0
    ckpt_dir: Optional[str] = None
    ckpt_every: int = 0

    def __post_init__(self):
        errs: List[str] = []
        if self.version != SCHEMA_VERSION:
            errs.append(f"schema version {self.version} unsupported (this "
                        f"port reads v{SCHEMA_VERSION})")
        for field, val, allowed in [
                ("arch", self.arch, cb.ARCH_ALIASES),
                ("method", self.method, METHODS),
                ("compressor", self.compressor, COMPRESSORS),
                ("carrier", self.carrier, CARRIERS),
                ("downlink_carrier", self.downlink_carrier, DOWN_CARRIERS),
                ("optimizer", self.optimizer, OPTIMIZERS),
                ("mesh", self.mesh, ("smoke",)),
                ("client_granularity", self.client_granularity, ("group",)),
                ("state_sharding", self.state_sharding, ("client",)),
                ("ef_state_dtype", self.ef_state_dtype, (None,)),
                ("moe_impl", self.moe_impl, ("dispatch",)),
                ("shape", self.shape, (None,)),
                ("tp_pad_heads", self.tp_pad_heads, (0,))]:
            if val not in allowed:
                errs.append(f"{field}={val!r} is not ported (have "
                            f"{sorted(map(repr, allowed))}); it {_LATER}")
        for field in ("groups", "participation", "hops", "method_kw"):
            if getattr(self, field):
                errs.append(f"{field}={getattr(self, field)!r}: only the "
                            f"default is ported; the rest {_LATER}")
        if self.overlap:
            errs.append(f"overlap=True {_LATER}")
        kw = self.compressor_kw
        fused = {self.carrier, self.downlink_carrier} & FUSED_CARRIERS
        if not isinstance(kw, dict) or not all(
                isinstance(k, str) and isinstance(v, _JSON_SCALARS)
                for k, v in kw.items()):
            errs.append(f"compressor_kw must map str keys to JSON scalars, "
                        f"got {kw!r}")
        elif fused:
            block = kw.get("block", 1024)
            if not isinstance(block, int) or not 1 <= block <= MAX_FUSED_BLOCK:
                errs.append(f"block {block!r}: the fused kernels take blocks "
                            f"of 1..{MAX_FUSED_BLOCK}")
            elif block % 2 and "fused_quant4" in fused:
                errs.append("uint4 packing needs an even BlockTopK block")
        if self.seq_len <= 0 or self.global_batch <= 0 or self.clients < 1:
            errs.append("seq_len, global_batch and clients must be positive")
        elif self.global_batch % self.clients:
            errs.append(f"global batch {self.global_batch} not divisible by "
                        f"the {self.clients} EF clients")
        if not 0.0 < self.eta <= 1.0:
            errs.append(f"eta must be in (0, 1], got {self.eta}")
        for field in ("ratio", "downlink_ratio"):
            if not 0.0 < getattr(self, field) <= 1.0:
                errs.append(f"{field} must be in (0, 1]")
        if not 0.0 <= self.heterogeneity <= 1.0:
            errs.append(f"heterogeneity must be in [0, 1], got "
                        f"{self.heterogeneity}")
        if errs:
            raise ValueError("invalid RunSpec:\n  - " + "\n  - ".join(errs))

    def to_dict(self) -> Dict[str, Any]:
        return dataclasses.asdict(self)

    def to_json(self, indent: Optional[int] = None) -> str:
        return json.dumps(self.to_dict(), sort_keys=True, indent=indent)

    @classmethod
    def from_dict(cls, d: Dict[str, Any]) -> "RunSpec":
        unknown = sorted(set(d) - {f.name for f in dataclasses.fields(cls)})
        if unknown:
            raise ValueError(f"unknown RunSpec keys {unknown} — refusing to "
                             "silently drop experiment-defining fields")
        if "version" not in d:
            raise ValueError("spec dict has no 'version' key")
        return cls(**d)

    @classmethod
    def from_json(cls, s: str) -> "RunSpec":
        return cls.from_dict(json.loads(s))


# (flag, field, type) — the reference's flag names for the fields this
# slice runs; dest is the field name
_FLAGS = [
    ("--arch", "arch", str), ("--smoke", "smoke", bool),
    ("--seq", "seq_len", int), ("--global-batch", "global_batch", int),
    ("--clients", "clients", int), ("--method", "method", str),
    ("--compressor", "compressor", str),
    ("--ratio", "ratio", float), ("--eta", "eta", float),
    ("--carrier", "carrier", str),
    ("--downlink-carrier", "downlink_carrier", str),
    ("--downlink-ratio", "downlink_ratio", float),
    ("--compressor-kw", "compressor_kw", json.loads),
    ("--lr", "lr", float), ("--heterogeneity", "heterogeneity", float),
    ("--seed", "seed", int),
]


def add_flags(ap: argparse.ArgumentParser) -> None:
    """The RunSpec flags; unset flags parse as None and never override."""
    ap.add_argument("--spec", dest="spec_file", default=None, metavar="FILE",
                    help="JSON RunSpec used as the base; flags override it")
    for flag, field, kind in _FLAGS:
        if kind is bool:
            ap.add_argument(flag, dest=field, action="store_true",
                            default=None)
        else:
            ap.add_argument(flag, dest=field, type=kind, default=None)


def from_args(args: argparse.Namespace) -> RunSpec:
    base = RunSpec()
    if getattr(args, "spec_file", None):
        with open(args.spec_file) as f:
            base = RunSpec.from_json(f.read())
    overrides = {field: getattr(args, field) for _, field, _ in _FLAGS
                 if getattr(args, field, None) is not None}
    return dataclasses.replace(base, **overrides) if overrides else base
