"""RunSpec: the declarative, serializable name of one experiment
(counterpart of src/repro/launch/spec.py, a copy of its schema, not an
import).

The port's RunSpec has the reference's field names, defaults and JSON
(schema v5), so ``results/specs/*.json`` load as they are, and its
``spec_hash`` is the reference's (the same sparse canonical form), so a
checkpoint written by either package names its experiment for both. It
accepts only what the port runs — smollm-360m, seven EF methods, the six
deterministic compressors, the seven carriers (``fused`` uplink only), the
single-device "smoke" mesh, f32 or bfloat16 EF state, SGD and AdamW — and
rejects everything else loudly at construction. ``compressor_kw`` and
``method_kw`` must map names to JSON scalars; which names the compressor
and the method take is checked where they are built (launch/build.py).
"""
from __future__ import annotations

import argparse
import dataclasses
import hashlib
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
OPTIMIZERS = frozenset({"sgd", "adamw"})
EF_STATE_DTYPES = (None, "bfloat16")
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
                ("ef_state_dtype", self.ef_state_dtype, EF_STATE_DTYPES),
                ("moe_impl", self.moe_impl, ("dispatch",)),
                ("shape", self.shape, (None,)),
                ("tp_pad_heads", self.tp_pad_heads, (0,))]:
            if val not in allowed:
                errs.append(f"{field}={val!r} is not ported (have "
                            f"{sorted(map(repr, allowed))}); it {_LATER}")
        for field in ("groups", "participation", "hops"):
            if getattr(self, field):
                errs.append(f"{field}={getattr(self, field)!r}: only the "
                            f"default is ported; the rest {_LATER}")
        if self.overlap:
            errs.append(f"overlap=True {_LATER}")
        for kw_name, kw in [("method_kw", self.method_kw),
                            ("compressor_kw", self.compressor_kw)]:
            if not isinstance(kw, dict) or not all(
                    isinstance(k, str) and isinstance(v, _JSON_SCALARS)
                    for k, v in kw.items()):
                errs.append(f"{kw_name} must map str keys to JSON scalars, "
                            f"got {kw!r}")
        kw = self.compressor_kw
        fused = {self.carrier, self.downlink_carrier} & FUSED_CARRIERS
        if isinstance(kw, dict) and fused:
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
        if self.ckpt_every < 0:
            errs.append(f"ckpt_every must be >= 0, got {self.ckpt_every}")
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

    def spec_hash(self) -> str:
        """The reference's hash of the experiment-defining fields, in SPARSE
        canonical form: only fields that differ from their defaults are
        hashed, and ``version`` and the checkpoint policy (ckpt_dir,
        ckpt_every) never are — moving a checkpoint directory keeps its
        hash. 16 hex digits of a sha256."""
        base = dataclasses.asdict(_DEFAULT)
        sparse = {k: v for k, v in self.to_dict().items()
                  if k not in ("version", "ckpt_dir", "ckpt_every")
                  and v != base.get(k)}
        return hashlib.sha256(
            json.dumps(sparse, sort_keys=True).encode()).hexdigest()[:16]

    def diff(self, other: "RunSpec") -> List[str]:
        """The differing fields, one ``name: a != b`` line each (for the
        resume refusal)."""
        out = []
        for f in dataclasses.fields(self):
            a, b = getattr(self, f.name), getattr(other, f.name)
            if a != b:
                out.append(f"{f.name}: {a!r} != {b!r}")
        return out


_DEFAULT = RunSpec()            # the defaults spec_hash leaves out


# (flag, field, type) — the reference's flag names for the fields this
# slice runs; dest is the field name
_FLAGS = [
    ("--arch", "arch", str), ("--smoke", "smoke", bool),
    ("--seq", "seq_len", int), ("--global-batch", "global_batch", int),
    ("--ef-state-dtype", "ef_state_dtype", str),
    ("--clients", "clients", int), ("--method", "method", str),
    ("--compressor", "compressor", str),
    ("--ratio", "ratio", float), ("--eta", "eta", float),
    ("--carrier", "carrier", str),
    ("--downlink-carrier", "downlink_carrier", str),
    ("--downlink-ratio", "downlink_ratio", float),
    ("--method-kw", "method_kw", json.loads),
    ("--compressor-kw", "compressor_kw", json.loads),
    ("--optimizer", "optimizer", str),
    ("--lr", "lr", float), ("--heterogeneity", "heterogeneity", float),
    ("--seed", "seed", int),
    ("--ckpt-dir", "ckpt_dir", str), ("--ckpt-every", "ckpt_every", int),
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


def explicit_fields(args: argparse.Namespace, ignore=()) -> List[str]:
    """The RunSpec fields set on the command line (an unset flag parses as
    None, so a flag equal to its default still counts)."""
    return [field for _, field, _ in _FLAGS
            if field not in ignore and getattr(args, field, None) is not None]


def from_args(args: argparse.Namespace) -> RunSpec:
    base = RunSpec()
    if getattr(args, "spec_file", None):
        with open(args.spec_file) as f:
            base = RunSpec.from_json(f.read())
    overrides = {field: getattr(args, field)
                 for field in explicit_fields(args)}
    return dataclasses.replace(base, **overrides) if overrides else base
