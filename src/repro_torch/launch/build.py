"""RunSpec → EFConfig assembly with the authoritative carrier checks
(counterpart of the factories in src/repro/launch/session.py and of
src/repro/launch/build.py::default_ef_config).

A fused carrier whose (method, compressor) would silently run a degraded
plan is a hard error here, exactly as in the reference; a ``sparse`` or
``quant*`` carrier that degrades to the dense plan runs, and says why in a
``PlanDegradationWarning``.
"""
from __future__ import annotations

import dataclasses
import warnings
from typing import Optional

from repro_torch.core import carriers as carrier_lib
from repro_torch.core import compressors as comp_lib
from repro_torch.core import distributed as dist
from repro_torch.core import ef as ef_lib
from repro_torch.launch.spec import RunSpec

# the plan each fused carrier must run; anything else is a misconfiguration
_FUSED_PLANS = {"fused": "fused", "fused_quant8": "fused_wire",
                "fused_quant4": "fused_wire"}


class PlanDegradationWarning(UserWarning):
    """A carrier runs a less specialised plan than its native one."""


def _compressor_class(spec: RunSpec):
    cls = comp_lib.REGISTRY[spec.compressor]       # RunSpec checked the name
    return cls, {f.name for f in dataclasses.fields(cls)}


def make_compressor(spec: RunSpec) -> comp_lib.Compressor:
    """The spec's compressor. ``ratio`` flows in only when the class has a
    ratio field (HardThreshold takes ``lam``); ``compressor_kw`` overrides
    any field, and a key that names no field is an error."""
    cls, fields = _compressor_class(spec)
    kw = dict(spec.compressor_kw)
    if "ratio" in fields and "ratio" not in kw:
        kw["ratio"] = spec.ratio
    unknown = sorted(set(kw) - fields)
    if unknown:
        raise ValueError(f"compressor_kw keys {unknown} are not fields of "
                         f"{cls.__name__}; have {sorted(fields)}")
    return cls(**kw)


def make_down_compressor(spec: RunSpec) -> Optional[comp_lib.Compressor]:
    """None without a downlink; otherwise the uplink compressor class
    re-budgeted to ``downlink_ratio`` where it has a ratio field. The
    compressor_kw keys that name its fields carry over, except the
    absolute budgets k, k_per_block and ratio."""
    if spec.downlink_carrier == "dense":
        return None
    cls, fields = _compressor_class(spec)
    kw = {k: v for k, v in spec.compressor_kw.items()
          if k in fields and k not in ("k", "k_per_block", "ratio")}
    if "ratio" in fields:
        kw["ratio"] = spec.downlink_ratio
    return cls(**kw)


def make_method(spec: RunSpec) -> ef_lib.Method:
    cls = ef_lib.REGISTRY[spec.method]
    kw = {"compressor": make_compressor(spec)}
    if "eta" in {f.name for f in dataclasses.fields(cls)}:
        kw["eta"] = spec.eta
    return cls(**kw)


def _degraded(scope: str, reason: str) -> None:
    warnings.warn(f"{scope} degrades to the dense plan: {reason}",
                  PlanDegradationWarning, stacklevel=3)


def ef_config(spec: RunSpec) -> dist.EFConfig:
    method = make_method(spec)
    plan, reason = carrier_lib.make(spec.carrier).plan_with_reason(method,
                                                                  spec.eta)
    native = _FUSED_PLANS.get(spec.carrier)
    if native is not None and plan != native:
        raise ValueError(f"carrier={spec.carrier!r} would silently run a "
                         f"DEGRADED plan ({plan!r}): {reason}")
    if spec.carrier != "dense" and plan == "dense":
        _degraded(f"carrier={spec.carrier!r}", reason)
    down = make_down_compressor(spec)
    if down is not None:
        dplan, dreason = carrier_lib.make(
            spec.downlink_carrier).plan_down_with_reason(down)
        if dplan == "dense":
            _degraded(f"downlink_carrier={spec.downlink_carrier!r}", dreason)
    return dist.EFConfig(method=method, carrier=spec.carrier,
                         down_carrier=spec.downlink_carrier,
                         down_compressor=down)
