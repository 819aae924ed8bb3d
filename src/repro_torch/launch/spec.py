"""RunSpec: the declarative, serializable name of one experiment
(counterpart of src/repro/launch/spec.py, a copy of its schema, not an
import).

The port's RunSpec has the reference's field names, defaults and JSON
(schema v5), so ``results/specs/*.json`` load as they are, and its
``spec_hash`` is the reference's (the same sparse canonical form), so a
checkpoint written by either package names its experiment for both. It
accepts the eight attention archs (smollm-360m, h2o-danube-3-4b,
granite-34b, gemma2-9b, musicgen-medium, internvl2-76b, olmoe-1b-7b,
grok-1-314b) with either ``moe_impl``, the ten EF methods, the eight compressors, the seven
carriers (``fused`` uplink only), f32 or bfloat16 EF state, SGD and AdamW,
per-parameter-group schedules (``groups``), the participation modes
(``async`` names the event-driven simulator, which ``build`` refuses as
the reference's does), the two-tier hierarchy (``hops``), the meshes
``smoke``, ``pod`` and ``multi_pod`` with ``overlap``, and a named
``shape`` (an ``INPUT_SHAPES`` entry, hashed and checked, which training
ignores as the reference's does), with the reference's grammars, previews
and cross-field refusals. Client granularity ``group`` or ``pod`` and
state sharding ``client`` or ``zero`` are taken as the reference takes
them (a ``zero`` training state the reference cannot build is refused
where the Session builds it, launch/shardings.py). ``tp_pad_heads``
pads the attention heads for the ``model`` axis, as the reference's does.
``compressor_kw`` and ``method_kw`` must map names to JSON
scalars; which names the compressor and the method take is checked where
they are built (launch/build.py).

The flag surface is the reference's (``_FLAGS`` in its order, with its
choices and help; ``RunSpec.to_flags``/``from_flags`` round-trip), and so
is the emitter: ``python -m repro_torch.launch.spec --print`` (or ``--out
FILE``) prints the canonical JSON byte for byte as the reference's does,
and ``--regen-goldens --goldens-dir DIR`` writes ``GOLDEN_SPECS``, the
definitions of ``results/specs/*.json``.
"""
from __future__ import annotations

import argparse
import dataclasses
import hashlib
import json
from typing import Any, Dict, List, Optional, Tuple

from repro_torch.configs import base as cb

SCHEMA_VERSION = 5

METHODS = frozenset({
    "ef21_sgdm_ideal", "ef21_sgd", "ef21_sgdm", "ef21_sgd2m", "ef21_sgdm_abs",
    "ef21_storm", "ef14_sgd", "sgdm", "sgd", "neolithic",
})
COMPRESSORS = frozenset({
    "identity", "topk", "randk", "block_topk", "hard_threshold", "natural",
    "rank1", "block_quant",
})
FUSED_CARRIERS = frozenset({"fused", "fused_quant8", "fused_quant4"})
FUSED_WIRE_CARRIERS = frozenset({"fused_quant8", "fused_quant4"})
CARRIERS = frozenset({"dense", "sparse", "quant8", "quant4"}) | FUSED_CARRIERS
# the fused kernel fuses the uplink client update: no fused downlink
DOWN_CARRIERS = CARRIERS - {"fused"}
OPTIMIZERS = frozenset({"sgd", "adamw"})
EF_STATE_DTYPES = (None, "bfloat16")
MOE_IMPLS = ("dispatch", "dense")
_JSON_SCALARS = (bool, int, float, str, type(None))

# the keys one ``groups`` entry may carry, the per-group EF-state dtypes
# and the characters the --schedule grammar reserves (core/schedule.py)
GROUP_KEYS = frozenset({"pattern", "carrier", "compressor", "ratio",
                        "compressor_kw", "downlink_carrier", "downlink_ratio",
                        "ef_state_dtype", "cross_carrier", "cross_ratio"})
GROUP_STATE_DTYPES = (None, "bfloat16", "float32")
PATTERN_RESERVED = set("=,:@")
# participation (core/participation.py): 'async' names the event-driven
# simulator (participation.run_async), which launch/build.py refuses
PART_MODES = ("full", "sampled", "async")
PART_KEYS = frozenset({"mode", "fraction", "seed"})
# the two-tier hierarchy (core/hierarchy.py): the cross hop is one message
# a pod, integrated like a broadcast, so it takes the downlink's carriers
HOP_KEYS = frozenset({"pods", "cross_carrier", "cross_ratio"})
CROSS_CARRIERS = DOWN_CARRIERS

# the carriers' plan rules by name (core/carriers.py plan_with_reason):
# methods whose message is a transform of c, compressors that draw
# randomness (no quantized wire ships them), compressors with the block
# wire, and what the fused kernels implement
WIRE_IS_NOT_MSG = frozenset({"ef21_sgdm_ideal", "ef21_sgdm_abs", "neolithic"})
NEEDS_RNG = frozenset({"randk", "natural"})
SPARSE_WIRE_OK = frozenset({"topk", "block_topk"})
FUSED_METHODS = frozenset({"ef21_sgdm", "ef21_sgd"})
FUSED_COMPRESSORS = frozenset({"block_topk"})

MESHES = ("smoke", "pod", "multi_pod")
# geometry mirror of launch/mesh.py (PROD_DATA/PROD_MODEL/PROD_PODS)
MESH_GEOM: Dict[str, Dict[str, int]] = {
    "smoke": {"data": 1, "model": 1},
    "pod": {"data": 16, "model": 16},
    "multi_pod": {"pod": 2, "data": 16, "model": 16},
}
GRANULARITIES = ("group", "pod")
STATE_SHARDINGS = ("client", "zero")


def pattern_token_errors(pattern: str) -> List[str]:
    """An empty ``|`` token matches every leaf; an embedded ``'*'`` token
    would shadow every later group (``core.schedule.pattern_token_errors``)."""
    toks = pattern.split("|")
    errs = []
    if any(not t for t in toks):
        errs.append("empty '|' token (matches every leaf)")
    if "*" in toks and pattern != "*":
        errs.append("'*' may only be the standalone catch-all pattern")
    return errs


def plan_preview(method: str, compressor: str, carrier: str,
                 block: Optional[int] = None) -> Tuple[str, str]:
    """(plan, reason) of ``Carrier.plan_with_reason`` by name: the plan in
    {'dense', 'wire', 'fused', 'fused_wire'}, the reason non-empty iff the
    carrier degraded. ``block`` is the BlockTopK block when the spec sets
    one (fused_quant4's packing needs it even)."""
    if carrier == "dense":
        return "dense", ""
    if method in WIRE_IS_NOT_MSG:
        return "dense", (
            f"method {method!r} transmits a transform of c "
            "(wire_is_msg=False); a non-dense wire cannot ship it")
    if carrier == "sparse":
        if compressor not in SPARSE_WIRE_OK:
            return "dense", (
                f"compressor {compressor!r} has no deterministic fixed-size "
                "(values, indices) wire")
        return "wire", ""
    if carrier == "fused":
        if method not in FUSED_METHODS:
            return "dense", ("the fused kernel implements the EF21-SGD(M) "
                             f"client chain only, not {method!r}")
        if compressor not in FUSED_COMPRESSORS:
            return "dense", ("the fused kernel compresses with BlockTopK "
                             f"only, not {compressor!r}")
        return "fused", ""
    # quant8 / quant4 / fused_quant8 / fused_quant4
    if compressor in NEEDS_RNG:
        return "dense", (
            f"compressor {compressor!r} draws randomness inside encode; the "
            "quantized wire ships deterministic compressors only")
    if carrier in FUSED_WIRE_CARRIERS:
        if method not in FUSED_METHODS:
            return "wire", (
                "the fused wire kernel implements the EF21-SGD(M) client "
                f"chain only, not {method!r}; running the unfused quantized "
                "wire")
        if compressor not in FUSED_COMPRESSORS:
            return "wire", (
                "the fused wire kernel compresses with BlockTopK only, not "
                f"{compressor!r}; running the unfused quantized wire")
        if carrier == "fused_quant4" and block is not None and block % 2:
            return "wire", (
                "uint4 packing needs an even BlockTopK block; running the "
                "unfused quantized wire")
        return "fused_wire", ""
    return "wire", ""                                   # quant8 / quant4


def downlink_plan_preview(compressor: str, carrier: str) -> Tuple[str, str]:
    """(plan, reason) of ``Carrier.plan_down_with_reason`` by name: the
    broadcast ships C(g − h), so only the compressor gates the wire."""
    if carrier == "dense":
        return "dense", ""
    if carrier == "fused":
        return "dense", (
            "the fused kernel fuses the UPLINK client update; the downlink "
            "broadcast has no fused path — use dense, sparse or quant")
    if carrier == "sparse":
        if compressor not in SPARSE_WIRE_OK:
            return "dense", (
                f"compressor {compressor!r} has no deterministic fixed-size "
                "(values, indices) wire")
        return "wire", ""
    if compressor in NEEDS_RNG:                    # quant8 / quant4
        return "dense", (
            f"compressor {compressor!r} draws randomness inside encode; the "
            "quantized wire ships deterministic compressors only")
    return "wire", ""


# ---------------------------------------------------------------------------
# per-group schedule: grammar and previews
# ---------------------------------------------------------------------------

def parse_schedule_flag(s: str) -> List[Dict[str, Any]]:
    """The ``--schedule`` value as a ``groups`` list: the grammar
    ``"embed=dense,norm|bias=dense,*=quant4:0.05"`` (comma-separated
    ``pattern=carrier[:ratio][@compressor]``; ``dense`` with no compressor
    ships uncompressed), or a JSON ``[...]`` list of group dicts for the
    knobs the grammar cannot express. ``format_schedule_flag`` inverts it."""
    if s.lstrip().startswith("["):
        return json.loads(s)
    out: List[Dict[str, Any]] = []
    for part in s.split(","):
        part = part.strip()
        pattern, sep, rhs = part.partition("=")
        if not sep or not pattern or not rhs:
            raise ValueError(
                f"bad --schedule entry {part!r}: want "
                "'pattern=carrier[:ratio][@compressor]'")
        comp = None
        if "@" in rhs:
            rhs, comp = rhs.split("@", 1)
        carrier, sep, ratio = rhs.partition(":")
        entry: Dict[str, Any] = {"pattern": pattern, "carrier": carrier}
        if sep:
            entry["ratio"] = float(ratio)
        if comp is not None:
            entry["compressor"] = comp
        out.append(entry)
    return out


def format_schedule_flag(groups: List[Dict[str, Any]]) -> str:
    """The canonical ``--schedule`` value: the grammar when every entry fits
    it, JSON otherwise."""
    parts = []
    for e in groups:
        if not ({"pattern", "carrier"} <= set(e)
                and set(e) <= {"pattern", "carrier", "ratio", "compressor"}):
            return json.dumps(groups, sort_keys=True)
        s = f"{e['pattern']}={e['carrier']}"
        if "ratio" in e:
            s += f":{e['ratio']}"
        if "compressor" in e:
            s += f"@{e['compressor']}"
        parts.append(s)
    return ",".join(parts)


def resolved_groups(spec: "RunSpec") -> List[Dict[str, Any]]:
    """The spec's schedule with every per-group default filled in. Empty
    ``groups`` is the one-group schedule of the single-knob fields; an
    entry's absent key defaults from the spec, except ``compressor``
    (``identity`` for a ``dense`` group, the spec's otherwise) and
    ``compressor_kw`` (the spec's only when the group runs the spec's
    compressor). The cross fields default from ``hops``."""
    hop_car = spec.hops.get("cross_carrier", "dense") \
        if isinstance(spec.hops, dict) else "dense"
    hop_ratio = spec.hops.get("cross_ratio", spec.ratio) \
        if isinstance(spec.hops, dict) else spec.ratio
    if not spec.groups:
        return [{"pattern": "*", "carrier": spec.carrier,
                 "compressor": spec.compressor, "ratio": spec.ratio,
                 "compressor_kw": dict(spec.compressor_kw),
                 "downlink_carrier": spec.downlink_carrier,
                 "downlink_ratio": spec.downlink_ratio,
                 "ef_state_dtype": spec.ef_state_dtype,
                 "cross_carrier": hop_car, "cross_ratio": hop_ratio}]
    out = []
    for e in spec.groups:
        carrier = e.get("carrier", "dense")
        comp = e.get("compressor",
                     "identity" if carrier == "dense" else spec.compressor)
        kw = e.get("compressor_kw",
                   dict(spec.compressor_kw) if comp == spec.compressor
                   else {})
        out.append({
            "pattern": e.get("pattern"),
            "carrier": carrier,
            "compressor": comp,
            "ratio": e.get("ratio", spec.ratio),
            "compressor_kw": kw,
            "downlink_carrier": e.get("downlink_carrier",
                                      spec.downlink_carrier),
            "downlink_ratio": e.get("downlink_ratio", spec.downlink_ratio),
            "ef_state_dtype": e.get("ef_state_dtype", spec.ef_state_dtype),
            "cross_carrier": e.get("cross_carrier", hop_car),
            "cross_ratio": e.get("cross_ratio", hop_ratio),
        })
    return out


def _block(kw) -> Optional[int]:
    blk = kw.get("block") if isinstance(kw, dict) else None
    return blk if isinstance(blk, int) else None


def schedule_preview(spec: "RunSpec") -> List[Dict[str, Any]]:
    """One row per resolved group with the uplink and downlink plans that
    would run (``plan_preview``, ``downlink_plan_preview``)."""
    rows = []
    for g in resolved_groups(spec):
        plan, reason = plan_preview(spec.method, g["compressor"],
                                    g["carrier"], _block(g["compressor_kw"]))
        dplan, dreason = downlink_plan_preview(g["compressor"],
                                               g["downlink_carrier"])
        rows.append({**g, "plan": plan, "plan_reason": reason,
                     "downlink_plan": dplan, "downlink_reason": dreason})
    return rows


# ---------------------------------------------------------------------------
# participation and hops: grammars and previews
# ---------------------------------------------------------------------------

def parse_participation_flag(s: str) -> Dict[str, Any]:
    """The ``--participation`` value: ``"sampled:0.25:7"``
    (``mode[:fraction[:seed]]``) or a JSON ``{...}`` dict."""
    if s.lstrip().startswith("{"):
        return json.loads(s)
    parts = s.split(":")
    if len(parts) > 3 or not parts[0]:
        raise ValueError(f"bad --participation value {s!r}: want "
                         "'mode[:fraction[:seed]]' or a JSON dict")
    out: Dict[str, Any] = {"mode": parts[0]}
    if len(parts) >= 2:
        out["fraction"] = float(parts[1])
    if len(parts) == 3:
        out["seed"] = int(parts[2])
    return out


def format_participation_flag(p: Dict[str, Any]) -> str:
    """The canonical ``--participation`` value: the grammar when the keys
    are a prefix of (mode, fraction, seed), JSON otherwise."""
    keys = set(p)
    if keys == {"mode"}:
        return str(p["mode"])
    if keys == {"mode", "fraction"}:
        return f"{p['mode']}:{p['fraction']}"
    if keys == {"mode", "fraction", "seed"}:
        return f"{p['mode']}:{p['fraction']}:{p['seed']}"
    return json.dumps(p, sort_keys=True)


def participation_preview(spec: "RunSpec") -> Dict[str, Any]:
    """Mode, fraction and seed with defaults filled in, the spec's n and the
    cohort size m = max(1, round(fraction·n)) (``Participation.
    cohort_size``'s arithmetic)."""
    p = spec.participation
    mode = p.get("mode", "full") if p else "full"
    fraction = float(p.get("fraction", 1.0)) if p else 1.0
    seed = int(p.get("seed", 0)) if p else 0
    n = spec.n_clients_preview()
    cohort = n if mode == "full" else max(1, int(round(fraction * n)))
    return {"mode": mode, "fraction": fraction, "seed": seed,
            "n": n, "cohort": cohort}


def parse_hops_flag(s: str) -> Dict[str, Any]:
    """The ``--hops`` value: ``"pods=2,cross=quant4:0.05"``
    (``pods=<int>`` and ``cross=carrier[:ratio]``) or a JSON ``{...}``
    dict."""
    if s.lstrip().startswith("{"):
        return json.loads(s)
    out: Dict[str, Any] = {}
    for part in s.split(","):
        part = part.strip()
        key, sep, rhs = part.partition("=")
        if not sep or not rhs:
            raise ValueError(f"bad --hops entry {part!r}: want "
                             "'pods=<int>' or 'cross=carrier[:ratio]'")
        if key == "pods":
            out["pods"] = int(rhs)
        elif key == "cross":
            carrier, sep, ratio = rhs.partition(":")
            out["cross_carrier"] = carrier
            if sep:
                out["cross_ratio"] = float(ratio)
        else:
            raise ValueError(f"bad --hops key {key!r}: want 'pods' or "
                             "'cross'")
    return out


def format_hops_flag(h: Dict[str, Any]) -> str:
    """The canonical ``--hops`` value: the grammar when the keys fit it,
    JSON otherwise."""
    if not set(h) <= HOP_KEYS:
        return json.dumps(h, sort_keys=True)
    parts = []
    if "pods" in h:
        parts.append(f"pods={h['pods']}")
    if "cross_carrier" in h:
        s = f"cross={h['cross_carrier']}"
        if "cross_ratio" in h:
            s += f":{h['cross_ratio']}"
        parts.append(s)
    elif "cross_ratio" in h:
        return json.dumps(h, sort_keys=True)
    return ",".join(parts)


def hops_preview(spec: "RunSpec") -> Dict[str, Any]:
    """Pods, cross carrier and ratio with defaults filled in, the clients a
    pod, and ``trivial_cross`` (a dense cross ships the exact pod target:
    the flat round, bit for bit)."""
    h = spec.hops
    pods = int(h.get("pods", 1)) if h else 1
    cross_carrier = h.get("cross_carrier", "dense") if h else "dense"
    cross_ratio = float(h.get("cross_ratio", spec.ratio)) if h else spec.ratio
    n = spec.n_clients_preview()
    return {"pods": pods, "cross_carrier": cross_carrier,
            "cross_ratio": cross_ratio, "n": n,
            "clients_per_pod": n // pods if pods and n % pods == 0 else None,
            "hierarchical": pods > 1,
            "trivial_cross": cross_carrier == "dense"}


def _fused_wire_users(spec: "RunSpec") -> List[str]:
    """The carrier and the groups that run the fused quantized wire."""
    bad = [f"carrier={spec.carrier!r}"] \
        if spec.carrier in FUSED_WIRE_CARRIERS else []
    for i, e in enumerate(spec.groups if isinstance(spec.groups, list)
                          else []):
        if isinstance(e, dict) and e.get("carrier") in FUSED_WIRE_CARRIERS:
            bad.append(f"groups[{i}] (pattern={e.get('pattern')!r})")
    return bad


@dataclasses.dataclass(frozen=True)
class RunSpec:
    """The reference's RunSpec fields and defaults; see the module doc for
    what the port accepts."""

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
                ("ef_state_dtype", self.ef_state_dtype, EF_STATE_DTYPES)]:
            if val not in allowed:
                errs.append(f"{field}={val!r} is not ported (have "
                            f"{sorted(map(repr, allowed))})")
        if self.mesh not in MESHES:
            errs.append(f"unknown mesh {self.mesh!r}; have {list(MESHES)}")
        for field, val, allowed in [
                ("client_granularity", self.client_granularity,
                 GRANULARITIES),
                ("state_sharding", self.state_sharding, STATE_SHARDINGS)]:
            if val not in allowed:
                errs.append(f"{field}={val!r} not in {list(allowed)}")
        if self.shape is not None and self.shape not in cb.INPUT_SHAPES:
            errs.append(f"unknown shape {self.shape!r}; have "
                        f"{sorted(cb.INPUT_SHAPES)}")
        if self.moe_impl not in MOE_IMPLS:
            errs.append(f"moe_impl={self.moe_impl!r} not in "
                        f"{list(MOE_IMPLS)}")
        if self.tp_pad_heads < 0:
            errs.append(f"tp_pad_heads must be >= 0, got {self.tp_pad_heads}")
        for kw_name, kw in [("method_kw", self.method_kw),
                            ("compressor_kw", self.compressor_kw)]:
            if not isinstance(kw, dict) or not all(
                    isinstance(k, str) and isinstance(v, _JSON_SCALARS)
                    for k, v in kw.items()):
                errs.append(f"{kw_name} must map str keys to JSON scalars, "
                            f"got {kw!r}")
        errs.extend(self._validate_groups())
        errs.extend(self._validate_participation())
        errs.extend(self._validate_hops())
        if self.seq_len <= 0 or self.global_batch <= 0 or self.clients < 1:
            errs.append("seq_len, global_batch and clients must be positive")
        elif self.mesh in MESHES \
                and self.client_granularity in GRANULARITIES:
            # both batch geometries a spec names: the training batch and,
            # when set, the named shape's (the reference's check)
            n = self.n_clients_preview()
            batches = [self.global_batch]
            if self.shape in cb.INPUT_SHAPES \
                    and cb.INPUT_SHAPES[self.shape].kind == "train":
                batches.append(cb.INPUT_SHAPES[self.shape].global_batch)
            for batch in batches:
                if batch % n:
                    errs.append(
                        f"global batch {batch} not divisible by the {n} EF "
                        f"clients of mesh={self.mesh!r} "
                        f"granularity={self.client_granularity!r}")
        # the fused misconfiguration of the spec's own carrier (the
        # reference's construction check; each group's is in
        # _validate_groups)
        if self.carrier in CARRIERS and self.method in METHODS \
                and self.compressor in COMPRESSORS:
            plan, reason = self.plan()
            if self.carrier == "fused" and plan != "fused":
                errs.append(
                    "carrier='fused' would silently run the UNFUSED dense "
                    f"plan: {reason}. Pick carrier='dense' or 'sparse' for "
                    f"method={self.method!r} compressor={self.compressor!r}")
            if self.carrier in FUSED_WIRE_CARRIERS and plan != "fused_wire":
                errs.append(
                    f"carrier={self.carrier!r} would silently run a "
                    f"DEGRADED plan ({plan!r}): {reason}. Pick "
                    "carrier='quant8'/'quant4' (the unfused quantized wire) "
                    f"for method={self.method!r} "
                    f"compressor={self.compressor!r}")
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

    def _validate_groups(self) -> List[str]:
        """The schedule's construction checks (the CompressionSchedule
        checks again in launch/build.py): keys, patterns, the catch-all
        last, the carriers, dtypes and ratios of each entry, and the fused
        misconfiguration of each group."""
        errs: List[str] = []
        if not isinstance(self.groups, list):
            return [f"groups must be a list of dicts, got {self.groups!r}"]
        if not self.groups:
            return errs
        seen = set()
        for i, e in enumerate(self.groups):
            if not isinstance(e, dict):
                errs.append(f"groups[{i}] must be a dict, got {e!r}")
                continue
            unknown = sorted(set(e) - GROUP_KEYS)
            if unknown:
                errs.append(f"groups[{i}]: unknown keys {unknown}; have "
                            f"{sorted(GROUP_KEYS)}")
            pat = e.get("pattern")
            if not pat or not isinstance(pat, str):
                errs.append(f"groups[{i}] needs a non-empty 'pattern'")
                continue
            bad = PATTERN_RESERVED & set(pat)
            if bad:
                errs.append(f"groups[{i}] pattern {pat!r} uses reserved "
                            f"characters {sorted(bad)}")
            errs.extend(f"groups[{i}] pattern {pat!r}: {err}"
                        for err in pattern_token_errors(pat))
            if pat in seen:
                errs.append(f"duplicate group pattern {pat!r}")
            seen.add(pat)
            if pat == "*" and i != len(self.groups) - 1:
                errs.append("the catch-all '*' must be the LAST group "
                            "(first-match-wins shadows everything after it)")
            carrier = e.get("carrier", "dense")
            if carrier not in CARRIERS:
                errs.append(f"groups[{i}]: unknown carrier {carrier!r}")
                continue
            comp = e.get("compressor",
                         "identity" if carrier == "dense"
                         else self.compressor)
            if comp not in COMPRESSORS:
                errs.append(f"groups[{i}]: compressor {comp!r} is not "
                            f"ported (have {sorted(COMPRESSORS)})")
                continue
            if e.get("downlink_carrier", "dense") not in DOWN_CARRIERS:
                errs.append(f"groups[{i}]: downlink carrier "
                            f"{e['downlink_carrier']!r} not in "
                            f"{sorted(DOWN_CARRIERS)}")
            if e.get("cross_carrier", "dense") not in CROSS_CARRIERS:
                errs.append(f"groups[{i}]: cross carrier "
                            f"{e['cross_carrier']!r} not in "
                            f"{sorted(CROSS_CARRIERS)}")
            if e.get("ef_state_dtype") not in GROUP_STATE_DTYPES:
                errs.append(f"groups[{i}]: ef_state_dtype "
                            f"{e['ef_state_dtype']!r} not in "
                            f"{list(GROUP_STATE_DTYPES)}")
            for key in ("ratio", "downlink_ratio", "cross_ratio"):
                if key in e and not (isinstance(e[key], (int, float))
                                     and 0.0 < e[key] <= 1.0):
                    errs.append(f"groups[{i}]: {key} must be in (0, 1], "
                                f"got {e[key]!r}")
            kw = e.get("compressor_kw", {})
            if not isinstance(kw, dict) or not all(
                    isinstance(k, str) and isinstance(v, _JSON_SCALARS)
                    for k, v in kw.items()):
                errs.append(f"groups[{i}]: compressor_kw must map str keys "
                            f"to JSON scalars, got {kw!r}")
            if self.method in METHODS:
                plan, reason = plan_preview(self.method, comp, carrier,
                                            _block(kw))
                if carrier == "fused" and plan != "fused":
                    errs.append(
                        f"groups[{i}] ({pat!r}): carrier='fused' would "
                        f"silently run the UNFUSED dense plan: {reason}")
                if carrier in FUSED_WIRE_CARRIERS and plan != "fused_wire":
                    errs.append(
                        f"groups[{i}] ({pat!r}): carrier={carrier!r} would "
                        f"silently run a DEGRADED plan ({plan!r}): {reason}")
        if isinstance(self.groups[-1], dict) \
                and self.groups[-1].get("pattern") != "*":
            errs.append("the last group must be the mandatory catch-all "
                        "'*' so every leaf lands in exactly one group")
        return errs

    def _validate_participation(self) -> List[str]:
        """Keys, mode, fraction and seed; a sampled or async cohort cannot
        ride the fused quantized wire."""
        p = self.participation
        if not isinstance(p, dict):
            return [f"participation must be a dict, got {p!r}"]
        if not p:
            return []
        errs: List[str] = []
        unknown = sorted(set(p) - PART_KEYS)
        if unknown:
            errs.append(f"participation: unknown keys {unknown}; have "
                        f"{sorted(PART_KEYS)}")
        mode = p.get("mode", "full")
        if mode not in PART_MODES:
            errs.append(f"participation: unknown mode {mode!r}; have "
                        f"{list(PART_MODES)}")
        frac = p.get("fraction", 1.0)
        if not (isinstance(frac, (int, float)) and not isinstance(frac, bool)
                and 0.0 < frac <= 1.0):
            errs.append(f"participation: fraction must be in (0, 1], got "
                        f"{frac!r}")
        seed = p.get("seed", 0)
        if not isinstance(seed, int) or isinstance(seed, bool):
            errs.append(f"participation: seed must be an int, got {seed!r}")
        bad = _fused_wire_users(self)
        if mode in ("sampled", "async") and bad:
            errs.append(
                f"participation mode {mode!r} cannot run the fused "
                f"quantized wire ({', '.join(bad)}): the kernel "
                "aggregates all clients inside, leaving no per-client "
                "wire to mask — use carrier='quant8'/'quant4'")
        return errs

    def _validate_hops(self) -> List[str]:
        """Keys, pods, the cross carrier and ratio; for pods > 1 the pods
        must divide the clients, and neither a sampled cohort nor the fused
        quantized wire composes with the pod tier."""
        h = self.hops
        if not isinstance(h, dict):
            return [f"hops must be a dict, got {h!r}"]
        if not h:
            return []
        errs: List[str] = []
        unknown = sorted(set(h) - HOP_KEYS)
        if unknown:
            errs.append(f"hops: unknown keys {unknown}; have "
                        f"{sorted(HOP_KEYS)}")
        pods = h.get("pods", 1)
        if not isinstance(pods, int) or isinstance(pods, bool) or pods < 1:
            errs.append(f"hops: pods must be an int >= 1, got {pods!r}")
            return errs
        cross = h.get("cross_carrier", "dense")
        if cross not in CROSS_CARRIERS:
            errs.append(f"hops: unknown cross carrier {cross!r}; have "
                        f"{sorted(CROSS_CARRIERS)}")
        ratio = h.get("cross_ratio", self.ratio)
        if not (isinstance(ratio, (int, float))
                and not isinstance(ratio, bool) and 0.0 < ratio <= 1.0):
            errs.append(f"hops: cross_ratio must be in (0, 1], got {ratio!r}")
        if pods == 1:
            return errs
        n = self.n_clients_preview() if self.mesh in MESHES else pods
        if n % pods != 0:
            errs.append(f"hops: pods={pods} must divide the {n} EF clients "
                        f"of mesh={self.mesh!r} "
                        f"granularity={self.client_granularity!r}")
        if self.mesh == "pod":
            errs.append("hops: mesh='pod' has no pod axis — hierarchical "
                        "aggregation (pods > 1) needs mesh='multi_pod' or "
                        "the single-device smoke mesh (vmap emulation)")
        if self.mesh == "multi_pod" \
                and pods != MESH_GEOM["multi_pod"]["pod"]:
            errs.append(f"hops: pods={pods} must equal the multi_pod mesh's "
                        f"pod axis ({MESH_GEOM['multi_pod']['pod']})")
        if self.client_granularity == "pod":
            errs.append("hops: client_granularity='pod' makes each pod ONE "
                        "client — there is no intra-pod hop left to "
                        "aggregate; use granularity='group'")
        mode = self.participation.get("mode", "full") \
            if isinstance(self.participation, dict) else "full"
        if mode in ("sampled", "async"):
            errs.append(
                f"hops: participation mode {mode!r} does not compose with "
                "hierarchical aggregation (a partial cohort breaks the "
                "pod-major client blocks) — use mode='full'")
        bad = _fused_wire_users(self)
        if bad:
            errs.append(
                f"hops: hierarchical aggregation cannot run the fused "
                f"quantized wire ({', '.join(bad)}): the kernel "
                "aggregates all clients inside, leaving no per-pod message "
                "— use carrier='quant8'/'quant4'")
        return errs

    def plan(self) -> Tuple[str, str]:
        """(execution plan, degradation reason) of this spec's carrier
        (:func:`plan_preview`)."""
        block = self.compressor_kw.get("block") \
            if isinstance(self.compressor_kw, dict) else None
        return plan_preview(self.method, self.compressor, self.carrier,
                            block if isinstance(block, int) else None)

    def downlink_plan(self) -> Tuple[str, str]:
        """(execution plan, degradation reason) of the downlink broadcast
        (:func:`downlink_plan_preview`)."""
        return downlink_plan_preview(self.compressor, self.downlink_carrier)

    def train_kind(self) -> str:
        """'train' | 'prefill' | 'decode' of the named shape (a custom
        geometry is always a train shape)."""
        if self.shape is not None:
            return cb.INPUT_SHAPES[self.shape].kind
        return "train"

    def train_batch(self) -> int:
        if self.shape is not None:
            return cb.INPUT_SHAPES[self.shape].global_batch
        return self.global_batch

    def n_clients_preview(self) -> int:
        """The paper's n for this spec (the reference's preview): the
        emulated clients on the one-device smoke mesh, else the production
        geometry's client count (``MESH_GEOM`` × granularity). A session
        takes n from the mesh it actually builds."""
        if self.mesh == "smoke":
            return self.clients
        geom = MESH_GEOM[self.mesh]
        if self.client_granularity == "pod":
            return geom.get("pod", 1)
        n = 1
        for ax in ("pod", "data"):
            n *= geom.get(ax, 1)
        return n

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

    def to_flags(self) -> List[str]:
        """CLI flags rebuilding this spec:
        ``RunSpec.from_flags(s.to_flags()) == s``."""
        out: List[str] = []
        for flag, field, kind in _FLAGS:
            val = getattr(self, field)
            if val == getattr(_DEFAULT, field):
                continue
            if kind == "bool":
                if val:
                    out.append(flag)
            else:
                out.extend([flag, _FORMATS.get(kind, str)(val)])
        return out

    @classmethod
    def from_flags(cls, argv: Optional[List[str]] = None) -> "RunSpec":
        ap = argparse.ArgumentParser(add_help=False)
        add_flags(ap)
        return cls.from_args(ap.parse_args(argv))

    @classmethod
    def from_args(cls, args: argparse.Namespace) -> "RunSpec":
        """A spec from parsed flags: ``--spec FILE`` (when in the namespace)
        is the base, and every flag passed overrides its field (an unset
        flag parses as None and never does)."""
        base = cls()
        spec_file = getattr(args, "spec_file", None)
        if spec_file:
            with open(spec_file) as f:
                base = cls.from_json(f.read())
        overrides = {field: getattr(args, field) for _, field, _ in _FLAGS
                     if getattr(args, field, None) is not None}
        return dataclasses.replace(base, **overrides) if overrides else base


_DEFAULT = RunSpec()            # the defaults spec_hash leaves out


# (flag, field, kind): the reference's flag surface in its order; dest is
# always the field name, so an argparse namespace maps onto RunSpec fields
_FLAGS: List[Tuple[str, str, str]] = [
    ("--arch", "arch", "str"),
    ("--smoke", "smoke", "bool"),
    ("--shape", "shape", "str"),
    ("--seq", "seq_len", "int"),
    ("--global-batch", "global_batch", "int"),
    ("--mesh", "mesh", "str"),
    ("--granularity", "client_granularity", "str"),
    ("--state-sharding", "state_sharding", "str"),
    ("--ef-state-dtype", "ef_state_dtype", "str"),
    ("--clients", "clients", "int"),
    ("--method", "method", "str"),
    ("--compressor", "compressor", "str"),
    ("--ratio", "ratio", "float"),
    ("--eta", "eta", "float"),
    ("--carrier", "carrier", "str"),
    ("--downlink-carrier", "downlink_carrier", "str"),
    ("--downlink-ratio", "downlink_ratio", "float"),
    ("--schedule", "groups", "schedule"),
    ("--overlap", "overlap", "bool"),
    ("--participation", "participation", "participation"),
    ("--hops", "hops", "hops"),
    ("--method-kw", "method_kw", "json"),
    ("--compressor-kw", "compressor_kw", "json"),
    ("--tp-pad-heads", "tp_pad_heads", "int"),
    ("--moe-impl", "moe_impl", "str"),
    ("--optimizer", "optimizer", "str"),
    ("--lr", "lr", "float"),
    ("--heterogeneity", "heterogeneity", "float"),
    ("--seed", "seed", "int"),
    ("--ckpt-dir", "ckpt_dir", "str"),
    ("--ckpt-every", "ckpt_every", "int"),
]

_FLAG_HELP = {
    "--smoke": "reduced per-arch config (CPU-sized)",
    "--shape": "named production InputShape for lower()/dryrun",
    "--carrier": "wire carrier for the EF sync (core/carriers.py): dense "
                 "all-reduce, sparse (values,indices) all-gather, the fused "
                 "client update kernel, block-quantized wires, or the "
                 "one-launch fused quantized wires (fused_quant8/4)",
    "--overlap": "comm/compute overlap: ring-transport gather-wire "
                 "aggregations on the sharded runtime, decoding each chunk "
                 "while the next is in flight; bit-identical to the "
                 "blocking gather",
    "--downlink-carrier": "wire carrier for the server → client broadcast: "
                          "'dense' keeps the implicit dense f32 broadcast; "
                          "sparse/quant8/quant4 add the EF21 server memory h "
                          "and ship C(g − h) as that carrier's wire",
    "--downlink-ratio": "compression budget of the downlink compressor (the "
                        "uplink compressor class, re-budgeted; like --ratio "
                        "it only applies to ratio-bearing compressors — "
                        "others reuse their compressor-kw budget unchanged)",
    "--schedule": "per-parameter-group compression schedule: "
                  "'pattern=carrier[:ratio][@compressor],…' entries matched "
                  "first-match-wins against param leaf paths, last must be "
                  "the catch-all '*' — e.g. "
                  "'norm|bias=dense,embed=quant4:0.05,*=sparse:0.02'; a JSON "
                  "[...] list unlocks per-group downlink / state-dtype knobs",
    "--participation": "partial participation: 'mode[:fraction[:seed]]' — "
                       "'full' (every client, every round), 'sampled:0.25:7' "
                       "(a seeded cohort of max(1, round(fraction·n)) "
                       "clients per round; non-sampled clients' EF state "
                       "stays frozen), or a JSON {...} dict; 'async' names "
                       "the event-driven simulator (core/participation.py) "
                       "and refuses the synchronous drivers",
    "--hops": "two-tier hierarchical aggregation: "
              "'pods=<int>,cross=carrier[:ratio]' — clients aggregate over "
              "the fast intra-pod links on the spec's carrier/schedule, "
              "then each pod's aggregator error-feeds one compressed "
              "innovation per round across the slow cross-pod links, e.g. "
              "'pods=2,cross=quant4:0.05'; 'cross=dense' (or pods=1) is "
              "bit-identical to the flat path; a JSON {...} dict also "
              "round-trips",
    "--clients": "emulated EF clients on the single-device mesh",
    "--method-kw": "JSON dict of extra Method kwargs (e.g. "
                   "'{\"gamma\": 0.01}')",
    "--compressor-kw": "JSON dict of extra Compressor kwargs (e.g. "
                       "'{\"block\": 1024, \"k_per_block\": 16}')",
}

_FLAG_CHOICES = {
    "--shape": sorted(cb.INPUT_SHAPES),
    "--mesh": list(MESHES),
    "--granularity": list(GRANULARITIES),
    "--state-sharding": list(STATE_SHARDINGS),
    "--ef-state-dtype": ["bfloat16"],
    "--method": sorted(METHODS),
    "--compressor": sorted(COMPRESSORS),
    "--carrier": sorted(CARRIERS),
    "--downlink-carrier": sorted(DOWN_CARRIERS),
    "--moe-impl": list(MOE_IMPLS),
    "--optimizer": sorted(OPTIMIZERS),
}

_TYPES = {"int": int, "float": float, "str": str, "json": json.loads,
          "schedule": parse_schedule_flag,
          "participation": parse_participation_flag,
          "hops": parse_hops_flag}
_FORMATS = {"json": lambda v: json.dumps(v, sort_keys=True),
            "schedule": format_schedule_flag,
            "participation": format_participation_flag,
            "hops": format_hops_flag}


def add_flags(ap: argparse.ArgumentParser) -> None:
    """The RunSpec flags, with the reference's help and choices. Every
    default is None, so an unset flag never overrides a ``--spec`` file."""
    ap.add_argument("--spec", dest="spec_file", default=None, metavar="FILE",
                    help="JSON RunSpec file used as the base; explicit flags "
                         "override its fields")
    for flag, field, kind in _FLAGS:
        kw: Dict[str, Any] = {"dest": field, "default": None,
                              "help": _FLAG_HELP.get(flag)}
        if kind == "bool":
            kw["action"] = "store_true"
            # --no-<flag> sets a truthy bool of a --spec file back to False
            ap.add_argument(flag.replace("--", "--no-", 1), dest=field,
                            action="store_false", default=None,
                            help=f"negate {flag}")
        else:
            kw["type"] = _TYPES[kind]
            if flag in _FLAG_CHOICES:
                kw["choices"] = _FLAG_CHOICES[flag]
        ap.add_argument(flag, **kw)


def explicit_fields(args: argparse.Namespace, ignore=()) -> List[str]:
    """The RunSpec fields set on the command line (an unset flag parses as
    None, so a flag equal to its default still counts), and ``spec_file``
    when ``--spec`` was given."""
    out = [field for _, field, _ in _FLAGS
           if field not in ignore and getattr(args, field, None) is not None]
    if getattr(args, "spec_file", None):
        out.append("spec_file")
    return out


def from_args(args: argparse.Namespace) -> RunSpec:
    """:meth:`RunSpec.from_args`."""
    return RunSpec.from_args(args)


# ---------------------------------------------------------------------------
# the golden fixtures (results/specs/*.json): their definitions, the
# reference's, so the files are written mechanically (``--regen-goldens``)
# ---------------------------------------------------------------------------

GOLDEN_SPECS: Dict[str, Dict[str, Any]] = {
    "train_smoke_ef21_sgdm": {"smoke": True},
    "fused_quickstart": {"carrier": "fused", "eta": 0.2,
                         "compressor_kw": {"block": 1024, "k_per_block": 16}},
    "dryrun_sparse_pod": {"arch": "gemma2-9b", "carrier": "sparse",
                          "compressor": "topk", "ratio": 0.01, "mesh": "pod",
                          "shape": "train_4k"},
    "quant4_multipod_zero": {"arch": "grok-1-314b", "carrier": "quant4",
                             "mesh": "multi_pod", "shape": "train_4k",
                             "client_granularity": "pod",
                             "state_sharding": "zero",
                             "ef_state_dtype": "bfloat16"},
    "bidir_quant4_down": {"smoke": True, "carrier": "quant4", "clients": 4,
                          "global_batch": 8, "seq_len": 64,
                          "downlink_carrier": "quant4",
                          "downlink_ratio": 0.02},
    # a mixed 3-group schedule: dense norms and biases, quant4 embeddings,
    # sparse everything else with a quant4 downlink on the catch-all
    "mixed_schedule": {"smoke": True, "clients": 4, "global_batch": 8,
                       "seq_len": 64,
                       "groups": [
                           {"pattern": "norm|bias", "carrier": "dense"},
                           {"pattern": "embed", "carrier": "quant4",
                            "ratio": 0.05},
                           {"pattern": "*", "carrier": "sparse",
                            "ratio": 0.02, "downlink_carrier": "quant4",
                            "downlink_ratio": 0.05},
                       ]},
    # the one-launch fused quantized wire with overlap on a production mesh
    "fused_quant8_overlap": {"carrier": "fused_quant8", "mesh": "pod",
                             "shape": "train_4k", "eta": 0.2,
                             "overlap": True,
                             "compressor_kw": {"block": 1024,
                                               "k_per_block": 16}},
    # a seeded quarter cohort a round (``--participation sampled:0.25:7``)
    "sampled_quarter": {"smoke": True, "clients": 4, "global_batch": 8,
                        "seq_len": 64,
                        "participation": {"mode": "sampled",
                                          "fraction": 0.25, "seed": 7}},
    # two pods of 4 clients: a dense intra hop, a quant4 cross-pod hop
    # (``--hops pods=2,cross=quant4:0.05``)
    "hierarchy_quant4_cross": {"smoke": True, "clients": 8, "global_batch": 8,
                               "seq_len": 64,
                               "hops": {"pods": 2,
                                        "cross_carrier": "quant4",
                                        "cross_ratio": 0.05}},
}


def regen_goldens(out_dir: str) -> List[str]:
    """Write every golden fixture of GOLDEN_SPECS into ``out_dir`` at the
    current schema, as the reference writes them; returns the paths."""
    import os
    os.makedirs(out_dir, exist_ok=True)
    paths = []
    for name in sorted(GOLDEN_SPECS):
        path = os.path.join(out_dir, f"{name}.json")
        with open(path, "w") as f:
            f.write(RunSpec(**GOLDEN_SPECS[name]).to_json(indent=1) + "\n")
        paths.append(path)
    return paths


def main(argv: Optional[List[str]] = None) -> None:
    """Validate a RunSpec and print or write its canonical JSON:

      python -m repro_torch.launch.spec --print --arch gemma2-9b --carrier sparse
      python -m repro_torch.launch.spec --out sweep/cell_017.json --method ef21_sgd
      python -m repro_torch.launch.spec --regen-goldens --goldens-dir /tmp/specs
    """
    ap = argparse.ArgumentParser(
        "repro_torch.launch.spec",
        description="validate and print/write a RunSpec as canonical JSON")
    add_flags(ap)
    ap.add_argument("--print", dest="do_print", action="store_true",
                    help="print the canonical JSON to stdout")
    ap.add_argument("--out", default=None, help="write the JSON to a file")
    ap.add_argument("--regen-goldens", dest="regen_goldens",
                    action="store_true",
                    help="write the golden fixtures of GOLDEN_SPECS under "
                         "--goldens-dir at the current schema, then exit")
    ap.add_argument("--goldens-dir", default="results/specs",
                    help="target directory for --regen-goldens")
    args = ap.parse_args(argv)
    if args.regen_goldens:
        for path in regen_goldens(args.goldens_dir):
            print(path)
        return
    spec = RunSpec.from_args(args)
    text = spec.to_json(indent=1)
    if args.out:
        import os
        os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
        with open(args.out, "w") as f:
            f.write(text + "\n")
    if args.do_print or not args.out:
        print(text)


if __name__ == "__main__":
    main()
