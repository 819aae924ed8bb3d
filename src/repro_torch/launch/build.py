"""RunSpec → EFConfig assembly with the authoritative carrier checks
(counterpart of the factories in src/repro/launch/session.py and of
src/repro/launch/build.py::default_ef_config), and the serving closures
``build_prefill``/``build_decode`` (one device, no mesh: what the
reference's placement specs do is the caller's ``.to(device)``).

A fused carrier whose (method, compressor) would silently run a degraded
plan is a hard error here, exactly as in the reference, for the spec's
carrier and for every group of a schedule; a ``sparse`` or ``quant*``
carrier that degrades to the dense plan runs, and says why in a
``PlanDegradationWarning``, once per (config, scope, reason). The schedule,
participation and hop topology are built from the spec (``make_schedule``,
``make_participation``, ``make_hops``) and checked against each other as
the reference's build does.
"""
from __future__ import annotations

import dataclasses
import warnings
from typing import Any, Dict, Optional

import torch

from repro_torch.core import carriers as carrier_lib
from repro_torch.core import compressors as comp_lib
from repro_torch.core import distributed as dist
from repro_torch.core import ef as ef_lib
from repro_torch.core import hierarchy as hier_lib
from repro_torch.core import participation as part_lib
from repro_torch.core import schedule as sched_lib
from repro_torch.launch import spec as spec_lib
from repro_torch.launch.spec import RunSpec
from repro_torch.models import model as model_lib

# the plan each fused carrier must run; anything else is a misconfiguration
_FUSED_PLANS = {"fused": "fused", "fused_quant8": "fused_wire",
                "fused_quant4": "fused_wire"}


class PlanDegradationWarning(UserWarning):
    """A carrier runs a less specialised plan than its native one."""


# (config, scope, reason) triples already warned: building the same
# experiment again does not warn again, a different experiment degrading
# for the same reason does
_WARNED: set = set()


def reset_plan_warnings() -> None:
    _WARNED.clear()


def _build_compressor(name: str, compressor_kw: Dict[str, Any],
                      ratio: float, where: str = "") -> comp_lib.Compressor:
    """A compressor by name: ``ratio`` flows in only when the class has a
    ratio field (HardThreshold takes ``lam``); ``compressor_kw`` overrides
    any field, and a key that names no field is an error."""
    cls = comp_lib.REGISTRY[name]                  # RunSpec checked the name
    fields = {f.name for f in dataclasses.fields(cls)}
    kw = dict(compressor_kw)
    if "ratio" in fields and "ratio" not in kw:
        kw["ratio"] = ratio
    unknown = sorted(set(kw) - fields)
    if unknown:
        raise ValueError(f"{where}compressor_kw keys {unknown} are not "
                         f"fields of {cls.__name__}; have {sorted(fields)}")
    return cls(**kw)


def make_compressor(spec: RunSpec) -> comp_lib.Compressor:
    """The spec's compressor (``_build_compressor``'s rules)."""
    return _build_compressor(spec.compressor, spec.compressor_kw, spec.ratio)


def make_down_compressor(spec: RunSpec) -> Optional[comp_lib.Compressor]:
    """None without a downlink; otherwise the uplink compressor class
    re-budgeted to ``downlink_ratio`` where it has a ratio field. The
    compressor_kw keys that name its fields carry over, except the
    absolute budgets k, k_per_block and ratio."""
    if spec.downlink_carrier == "dense":
        return None
    return _rebudgeted({"compressor": spec.compressor,
                        "compressor_kw": spec.compressor_kw,
                        "downlink_ratio": spec.downlink_ratio},
                       "downlink_ratio")


def make_method(spec: RunSpec) -> ef_lib.Method:
    """The spec's EF method: its compressor, its client state dtype, the
    spec's η for every method with an η field, then ``method_kw`` on top; a
    ``method_kw`` key that names no field of the method is an error."""
    cls = ef_lib.REGISTRY[spec.method]
    fields = {f.name for f in dataclasses.fields(cls)}
    kw = {"compressor": make_compressor(spec),
          "state_dtype": torch.bfloat16
          if spec.ef_state_dtype == "bfloat16" else None}
    if "eta" in fields:
        kw["eta"] = spec.eta
    kw.update(spec.method_kw)
    unknown = sorted(set(kw) - fields)
    if unknown:
        raise ValueError(f"method_kw keys {unknown} are not fields of "
                         f"{cls.__name__}; have {sorted(fields)}")
    return cls(**kw)


def _group_compressor(entry: Dict[str, Any]) -> comp_lib.Compressor:
    """The compressor of one resolved group entry (``spec.resolved_groups``),
    under ``make_compressor``'s rules."""
    return _build_compressor(entry["compressor"], entry["compressor_kw"],
                             entry["ratio"],
                             f"group {entry['pattern']!r}: ")


def _rebudgeted(entry: Dict[str, Any], ratio_key: str
                ) -> comp_lib.Compressor:
    """The group's compressor class re-budgeted to ``entry[ratio_key]``
    where it has a ratio field: its compressor_kw carries over, except the
    absolute budgets k, k_per_block and ratio (``make_down_compressor``'s
    rule, per group)."""
    cls = comp_lib.REGISTRY[entry["compressor"]]
    fields = {f.name for f in dataclasses.fields(cls)}
    kw = {k: v for k, v in entry["compressor_kw"].items()
          if k in fields and k not in ("k", "k_per_block", "ratio")}
    if "ratio" in fields:
        kw["ratio"] = entry[ratio_key]
    return cls(**kw)


def _group_down_compressor(entry: Dict[str, Any]
                           ) -> Optional[comp_lib.Compressor]:
    """None without a downlink carrier, else the group's compressor
    re-budgeted to its downlink_ratio."""
    if entry["downlink_carrier"] == "dense":
        return None
    return _rebudgeted(entry, "downlink_ratio")


def _group_cross_compressor(entry: Dict[str, Any]
                            ) -> Optional[comp_lib.Compressor]:
    """None for a dense cross carrier (the trivial cross), else the group's
    compressor re-budgeted to its cross_ratio."""
    if entry["cross_carrier"] == "dense":
        return None
    return _rebudgeted(entry, "cross_ratio")


def make_schedule(spec: RunSpec) -> Optional[sched_lib.CompressionSchedule]:
    """The spec's schedule, or None without explicit ``groups`` (the
    ungrouped round; a one-group schedule would be bit-identical)."""
    if not spec.groups:
        return None
    return sched_lib.CompressionSchedule(tuple(
        sched_lib.Group(
            pattern=e["pattern"], compressor=_group_compressor(e),
            carrier=e["carrier"], down_carrier=e["downlink_carrier"],
            down_compressor=_group_down_compressor(e),
            state_dtype=e["ef_state_dtype"],
            cross_carrier=e["cross_carrier"],
            cross_compressor=_group_cross_compressor(e))
        for e in spec_lib.resolved_groups(spec)))


def make_participation(spec: RunSpec) -> Optional[part_lib.Participation]:
    """The spec's participation, or None without one (the full path)."""
    if not spec.participation:
        return None
    p = spec.participation
    return part_lib.Participation(mode=p.get("mode", "full"),
                                  fraction=float(p.get("fraction", 1.0)),
                                  seed=int(p.get("seed", 0)))


def make_hops(spec: RunSpec) -> Optional[hier_lib.Hops]:
    """The spec's two-tier topology, or None when it is flat (pods 1). The
    cross compressor is the uplink compressor re-budgeted to cross_ratio
    (None for a dense cross carrier)."""
    h = spec_lib.hops_preview(spec)
    if not h["hierarchical"]:
        return None
    cross = None
    if h["cross_carrier"] != "dense":
        cross = _rebudgeted({"compressor": spec.compressor,
                             "compressor_kw": spec.compressor_kw,
                             "cross_ratio": h["cross_ratio"]}, "cross_ratio")
    return hier_lib.Hops(pods=h["pods"], cross_carrier=h["cross_carrier"],
                         cross_compressor=cross)


def _warn_degraded(config, scope: str, reason: str) -> None:
    key = (config, scope, reason)
    if key in _WARNED:
        return
    _WARNED.add(key)
    warnings.warn(f"{scope} degrades to the dense plan: {reason}",
                  PlanDegradationWarning, stacklevel=3)


def _check_group_plans(config, schedule, method, eta) -> None:
    """Per group: a fused carrier that would run another plan is a hard
    error; any other degradation warns once per (config, group, reason)."""
    for grp in schedule.groups:
        m_g = sched_lib.group_method(method, grp)
        plan, reason = carrier_lib.make(grp.carrier).plan_with_reason(m_g,
                                                                      eta)
        if grp.carrier == "fused" and plan != "fused":
            raise ValueError(
                f"group {grp.pattern!r}: carrier='fused' would silently run "
                f"the UNFUSED dense plan: {reason}")
        if grp.carrier in spec_lib.FUSED_WIRE_CARRIERS \
                and plan != "fused_wire":
            raise ValueError(
                f"group {grp.pattern!r}: carrier={grp.carrier!r} would "
                f"silently run a DEGRADED plan ({plan!r}): {reason}")
        if grp.carrier != "dense" and plan == "dense":
            _warn_degraded(config,
                           f"group {grp.pattern!r} carrier {grp.carrier}",
                           reason)
        if grp.has_downlink:
            dplan, dreason = carrier_lib.make(
                grp.down_carrier).plan_down_with_reason(grp.down_comp())
            if grp.down_carrier != "dense" and dplan == "dense":
                _warn_degraded(
                    config,
                    f"group {grp.pattern!r} downlink {grp.down_carrier}",
                    dreason)


def ef_config(spec: RunSpec, n: Optional[int] = None) -> dist.EFConfig:
    """The EFConfig of a spec, with the reference's authoritative checks:
    the carrier plans (per group under a schedule), then participation and
    the hop topology against its ``n`` clients (the mesh's on more than
    one rank; ``spec.clients`` by default)."""
    method = make_method(spec)
    down = make_down_compressor(spec)
    schedule = make_schedule(spec)
    participation = make_participation(spec)
    hops = make_hops(spec)
    config = (method, spec.carrier, spec.downlink_carrier, down, schedule)
    if schedule is not None:
        _check_group_plans(config, schedule, method, spec.eta)
        fused_wire = [f"group {g.pattern!r} carrier={g.carrier!r}"
                      for g in schedule.groups
                      if g.carrier in spec_lib.FUSED_WIRE_CARRIERS]
    else:
        fused_wire = [f"carrier={spec.carrier!r}"] \
            if spec.carrier in spec_lib.FUSED_WIRE_CARRIERS else []
        plan, reason = carrier_lib.make(spec.carrier).plan_with_reason(
            method, spec.eta)
        native = _FUSED_PLANS.get(spec.carrier)
        if native is not None and plan != native:
            raise ValueError(f"carrier={spec.carrier!r} would silently run "
                             f"a DEGRADED plan ({plan!r}): {reason}")
        if spec.carrier != "dense" and plan == "dense":
            _warn_degraded(config, f"carrier={spec.carrier!r}", reason)
        if down is not None:
            dplan, dreason = carrier_lib.make(
                spec.downlink_carrier).plan_down_with_reason(down)
            if dplan == "dense":
                _warn_degraded(config,
                               f"downlink_carrier={spec.downlink_carrier!r}",
                               dreason)
    if participation is not None and participation.mode == "async":
        raise ValueError(
            "participation mode 'async' does not build a synchronous step "
            "(every round is a barrier); drive the event-driven simulator "
            "instead: repro_torch.core.participation.run_async")
    sampling = participation is not None and participation.is_sampling
    if sampling and fused_wire:
        raise ValueError(
            f"sampled participation cannot run the fused quantized wire "
            f"({', '.join(fused_wire)}): the kernel aggregates all clients "
            "inside, leaving no per-client wire to mask — use "
            "carrier='quant8'/'quant4'")
    if hops is not None:
        hier_lib.check_pods(hops, spec.clients if n is None else n)
        if sampling:
            raise ValueError(
                "sampled participation cannot run under a hierarchical "
                "topology: a per-round cohort has no stable pod membership "
                "for the pod aggregator's EF memory")
        if fused_wire:
            raise ValueError(
                f"the fused quantized wire cannot run under a hierarchical "
                f"topology ({', '.join(fused_wire)}): its wire IS the global "
                "aggregation — there is no per-pod innovation to "
                "re-compress")
    return dist.EFConfig(method=method, carrier=spec.carrier,
                         down_carrier=spec.downlink_carrier,
                         down_compressor=down, schedule=schedule,
                         participation=participation, hops=hops)


def cache_len(prompt_len: int, decode_budget: int, n_prefix: int = 0) -> int:
    """Slots of a serving cache: the prefix, the prompt and the decode
    budget (the reference's ``_cache_shape``)."""
    return n_prefix + prompt_len + decode_budget


def build_prefill(cfg):
    """fn(params, batch, cache) -> (last-token logits, cache)."""
    def fn(params, batch, cache):
        return model_lib.prefill(cfg, params, batch, cache)
    return fn


def build_decode(cfg):
    """fn(params, cache, tokens, pos) -> (logits, cache)."""
    def fn(params, cache, tokens, pos):
        return model_lib.decode_step(cfg, params, cache, tokens, pos)
    return fn
