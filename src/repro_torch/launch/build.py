"""RunSpec → EFConfig assembly with the authoritative carrier checks
(counterpart of the factories in src/repro/launch/session.py and of
src/repro/launch/build.py::default_ef_config).

A fused carrier whose (method, compressor) would silently run a degraded
plan is a hard error here, exactly as in the reference.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

from repro_torch.core import carriers as carrier_lib
from repro_torch.core import compressors as comp_lib
from repro_torch.core import distributed as dist
from repro_torch.core import ef as ef_lib
from repro_torch.launch.spec import RunSpec


def make_compressor(spec: RunSpec) -> comp_lib.Compressor:
    """The spec's compressor: ``ratio`` flows in unless compressor_kw sets
    it; compressor_kw overrides any field."""
    kw = dict(spec.compressor_kw)
    kw.setdefault("ratio", spec.ratio)
    return comp_lib.make(spec.compressor, **kw)


def make_down_compressor(spec: RunSpec) -> Optional[comp_lib.Compressor]:
    """None without a downlink; otherwise the uplink compressor re-budgeted
    to ``downlink_ratio`` (the absolute-budget keys k_per_block and ratio of
    compressor_kw are dropped, its geometry kept)."""
    if spec.downlink_carrier == "dense":
        return None
    kw = {k: v for k, v in spec.compressor_kw.items()
          if k not in ("k", "k_per_block", "ratio")}
    kw["ratio"] = spec.downlink_ratio
    return comp_lib.make(spec.compressor, **kw)


def make_method(spec: RunSpec) -> ef_lib.Method:
    cls = ef_lib.REGISTRY[spec.method]
    kw = {"compressor": make_compressor(spec)}
    if "eta" in {f.name for f in dataclasses.fields(cls)}:
        kw["eta"] = spec.eta
    return cls(**kw)


def ef_config(spec: RunSpec) -> dist.EFConfig:
    method = make_method(spec)
    plan, reason = carrier_lib.make(spec.carrier).plan_with_reason(method,
                                                                  spec.eta)
    native = {"dense": "dense", "fused": "fused", "fused_quant8": "fused_wire",
              "fused_quant4": "fused_wire"}[spec.carrier]
    if plan != native:
        raise ValueError(f"carrier={spec.carrier!r} would silently run a "
                         f"DEGRADED plan ({plan!r}): {reason}")
    down = make_down_compressor(spec)
    if down is not None:
        dplan, dreason = carrier_lib.make(
            spec.downlink_carrier).plan_down_with_reason(down)
        if dplan != "wire":
            raise ValueError(f"downlink_carrier={spec.downlink_carrier!r} "
                             f"degrades to {dplan!r}: {dreason}")
    return dist.EFConfig(method=method, carrier=spec.carrier,
                         down_carrier=spec.downlink_carrier,
                         down_compressor=down)
