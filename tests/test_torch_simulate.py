"""The port's simulator (repro_torch.core.simulate) against the reference's
(repro.core.simulate.run_numpy), on the CPU.

Every run here is free of randomness, so the two packages can be held to
each other step by step: full-batch subclasses of the reference's problems
(defined below for both packages: each client's gradient is its full-data
gradient, so no draw enters) and σ = 0 quadratics. Over 150 steps:

- ``grad_norm_sq``, ``loss`` and ``x_final`` within rtol 1e-4 (x against
  its largest entry), for every method on the dense plan and every method
  on the plans its carriers reach (wire, fused, fused_wire), the
  time-varying schedule, the downlink with and without memory, a two-group
  schedule, sampled participation 0.5 and a two-pod hierarchy;
- on a quantized wire the two packages round one mantissa to different
  grid steps once an f32 ulp differs (XLA contracts a*b+c into an FMA, the
  port rounds twice; PERF.md and ROADMAP.md standing facts): those runs are
  held within 1e-4 over the first 50 steps and within 1e-2 over all 150;
- every accounting key EXACTLY (at the reference's f32 output precision).

Then the simulator against a hand-rolled loop of the port's own
``ef_round``, bit for bit (the simulator runs the production round).
"""
import dataclasses

import jax
import numpy as np
import pytest
import torch

from repro.core import compressors as jax_comp
from repro.core import ef as jax_ef
from repro.core import hierarchy as jax_hier
from repro.core import participation as jax_part
from repro.core import problems as jax_prob
from repro.core import schedule as jax_sched
from repro.core import simulate as jax_sim
from repro_torch.core import compressors as pt_comp
from repro_torch.core import distributed as pt_dist
from repro_torch.core import ef as pt_ef
from repro_torch.core import hierarchy as pt_hier
from repro_torch.core import participation as pt_part
from repro_torch.core import problems as pt_prob
from repro_torch.core import schedule as pt_sched
from repro_torch.core import simulate as pt_sim
from test_torch_schedule import one_torch_thread  # noqa: F401 (autouse)

STEPS = 150
N = 4
RTOL = 1e-4
QUANT_EARLY = 50           # quantized wires: steps held within RTOL
QUANT_RTOL = 1e-2          # … and all steps within this


# ---------------------------------------------------------------------------
# full-batch problems (no draw enters a gradient)
# ---------------------------------------------------------------------------

class JaxLogistic(jax_prob.LogisticRegression):
    def stoch_grad(self, x, client, rng, B):
        a, y = self._A[client], self._Y[client]
        return jax.grad(lambda w: self._loss_client(w, a, y)
                        + self._reg(w))(x)


class JaxMLP(jax_prob.MLPClassification):
    def stoch_grad(self, x, client, rng, B):
        return jax.grad(self._loss_batch)(x, self._A[client],
                                          self._Y[client])


class _FullBatch:
    """Every client's draw is all of its data."""

    def draw(self, gen, B, clients):
        return torch.arange(self.m_per_client).expand(
            self._count(clients), -1)


class PtLogistic(_FullBatch, pt_prob.LogisticRegression):
    pass


class PtMLP(_FullBatch, pt_prob.MLPClassification):
    pass


LOGISTIC = dict(n=N, m_per_client=32, l=12, c=3, seed=1)
MLP = dict(n=N, m_per_client=16, in_dim=6, hidden=8, c=3, seed=2)
QUAD = dict(n=N, d=16, lam=0.05, sigma=0.0, seed=0)


def problems(kind):
    if kind == "logistic":
        return JaxLogistic(**LOGISTIC), PtLogistic(device="cpu", **LOGISTIC)
    if kind == "mlp":
        return JaxMLP(**MLP), PtMLP(device="cpu", **MLP)
    return (jax_prob.RandomQuadratics(**QUAD),
            pt_prob.RandomQuadratics(device="cpu", **QUAD))


# ---------------------------------------------------------------------------
# configs named once, built for each package
# ---------------------------------------------------------------------------

def comp(pkg, spec):
    if spec is None:
        return None
    name, kw = spec
    return pkg.REGISTRY[name](**kw)


TOPK = ("topk", {"k": 5})
BTK = ("block_topk", {"block": 16, "k_per_block": 3})


def build(side, method, compressor, cfg):
    """(method, SimConfig) of one package from the package-neutral cell."""
    comp_lib, ef_lib, sim, sched, part, hier = (
        (jax_comp, jax_ef, jax_sim, jax_sched, jax_part, jax_hier)
        if side == "jax" else
        (pt_comp, pt_ef, pt_sim, pt_sched, pt_part, pt_hier))
    kw = dict(cfg)
    if "down_compressor" in kw:
        kw["down_compressor"] = comp(comp_lib, kw["down_compressor"])
    if "schedule" in kw:
        kw["schedule"] = sched.CompressionSchedule(tuple(
            sched.Group(**dict(g, compressor=comp(comp_lib, g["compressor"]),
                               **({"down_compressor": comp(
                                   comp_lib, g["down_compressor"])}
                                  if "down_compressor" in g else {})))
            for g in kw["schedule"]))
    if "participation" in kw:
        kw["participation"] = part.Participation(*kw["participation"])
    if "hops" in kw:
        pods, car, cc = kw["hops"]
        kw["hops"] = hier.Hops(pods=pods, cross_carrier=car,
                               cross_compressor=comp(comp_lib, cc))
    m = ef_lib.REGISTRY[method](compressor=comp(comp_lib, compressor))
    return m, sim.SimConfig(n=N, gamma=0.1, steps=STEPS, **kw)


WIRE_METHODS = ("ef21_sgd", "ef21_sgdm", "ef21_sgd2m", "ef21_storm",
                "ef14_sgd", "sgdm", "sgd")
CELLS = (
    [pytest.param("logistic", m, TOPK, {}, False, id=f"dense-{m}")
     for m in sorted(pt_ef.REGISTRY) if m != "ef21_sgdm_ideal"]
    + [pytest.param("quadratics", "ef21_sgdm_ideal", TOPK, {}, False,
                    id="dense-ef21_sgdm_ideal")]
    + [pytest.param("logistic", m, TOPK, {"carrier": "sparse"}, False,
                    id=f"wire-sparse-{m}") for m in WIRE_METHODS]
    + [pytest.param("logistic", m, BTK, {"carrier": "quant8"}, True,
                    id=f"wire-quant8-{m}") for m in ("ef21_storm", "sgdm")]
    + [pytest.param("logistic", m, BTK, {"carrier": "fused"}, False,
                    id=f"fused-{m}") for m in ("ef21_sgd", "ef21_sgdm")]
    + [pytest.param("logistic", "ef21_sgdm", BTK, {"carrier": "fused_quant8"},
                    True, id="fused_wire-ef21_sgdm-q8"),
       pytest.param("logistic", "ef21_sgd", BTK, {"carrier": "fused_quant4"},
                    True, id="fused_wire-ef21_sgd-q4")]
    + [pytest.param("logistic", "ef21_sgdm", c, {"carrier": car,
                                                 "time_varying": True},
                    q, id=f"time_varying-{car}")
       for car, c, q in (("dense", TOPK, False), ("fused", BTK, False),
                         ("fused_quant8", BTK, True))]
    + [pytest.param("logistic", "ef21_sgdm", BTK, {
        "carrier": "fused", "down_carrier": dc,
        "down_compressor": ("block_topk", {"block": 16, "k_per_block": 4}),
        "down_memory": mem}, dc == "quant4",
        id=f"downlink-{dc}-{'memory' if mem else 'naive'}")
       for dc in ("sparse", "quant4") for mem in (True, False)]
    + [pytest.param("mlp", "ef21_sgdm", TOPK, {"schedule": [
        {"pattern": "w", "compressor": TOPK, "carrier": "sparse",
         "down_carrier": "sparse", "down_compressor": ("topk", {"k": 6})},
        {"pattern": "*", "compressor": ("identity", {}),
         "carrier": "dense"}], "down_memory": mem}, False,
        id=f"schedule-two-groups-{'memory' if mem else 'naive'}")
       for mem in (True, False)]
    + [pytest.param("logistic", m, c, {"carrier": car,
                                       "participation": ("sampled", 0.5, 3)},
                    False, id=f"sampled-{car}-{m}")
       for m, car, c in (("ef21_sgdm", "sparse", TOPK),
                         ("ef14_sgd", "dense", TOPK),
                         ("ef21_sgdm", "fused", BTK))]
    + [pytest.param("logistic", "ef21_sgdm", TOPK, {
        "carrier": up, "hops": (2, cross, cc)}, cross == "quant4",
        id=f"hops-{up}-{cross}")
       for up, cross, cc in (
           ("dense", "sparse", ("topk", {"k": 4})),
           ("sparse", "quant4", ("block_topk", {"block": 16,
                                                "k_per_block": 4})))]
)


def _rel(got, want):
    return np.abs(got - want) / np.maximum(np.abs(want), 1e-30)


def _hold(got, want, quantized, what):
    rel = _rel(np.asarray(got, np.float64), np.asarray(want, np.float64))
    if quantized:
        assert rel[:QUANT_EARLY].max() <= RTOL, (what, rel[:QUANT_EARLY].max())
        assert rel.max() <= QUANT_RTOL, (what, rel.max())
    else:
        assert rel.max() <= RTOL, (what, rel.max(), int(rel.argmax()))


@pytest.mark.parametrize("kind,method,compressor,cfg,quantized", CELLS)
def test_simulator_matches_reference(kind, method, compressor, cfg,
                                     quantized):
    jp, pp = problems(kind)
    jm, jcfg = build("jax", method, compressor, cfg)
    pm, pcfg = build("torch", method, compressor, cfg)
    want = jax_sim.run_numpy(jp, jm, jcfg, seed=0)
    got = pt_sim.run_numpy(pp, pm, pcfg, seed=0)
    for key in ("grad_norm_sq", "loss"):
        assert got[key].shape == (STEPS,) and got[key].dtype == np.float32
        _hold(got[key], want[key], quantized, key)
    xw = want["x_final"] if isinstance(want["x_final"], dict) \
        else {pt_prob.LEAF: want["x_final"]}
    assert sorted(got["x_final"]) == sorted(xw)
    for k, w in xw.items():
        w = np.asarray(w)
        err = np.abs(got["x_final"][k] - w).max() / np.abs(w).max()
        assert err <= (QUANT_RTOL if quantized else RTOL), (k, err)
    acct = {k: v for k, v in want.items()
            if k not in ("grad_norm_sq", "loss", "x_final")}
    assert sorted(k for k in got if k in acct or "words" in k
                  or "coords" in k) == sorted(acct)
    for k, w in acct.items():
        g = got[k]
        if isinstance(w, tuple):
            assert tuple(np.float32(v) for v in g) == \
                tuple(np.float32(v) for v in w), k
        else:
            assert np.float32(g) == np.float32(w), (k, g, w)


# ---------------------------------------------------------------------------
# the simulator runs the production round
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("up,down,down_comp", [
    ("dense", "dense", None),
    ("dense", "quant4", pt_comp.BlockTopK(block=16, k_per_block=4)),
    ("sparse", "sparse", pt_comp.BlockTopK(block=16, k_per_block=4)),
    ("fused_quant8", "fused_quant4",
     pt_comp.BlockTopK(block=16, k_per_block=4)),
], ids=["no-downlink", "dense-q4", "sparse-sparse", "fq8-fq4"])
def test_simulator_equals_a_loop_of_ef_round(up, down, down_comp):
    """The whole trajectory equals a hand-rolled loop over the port's
    ``ef_round`` (x steps with h, the server integrates the broadcast after
    the uplink aggregate), bit for bit."""
    _, prob = problems("logistic")
    gamma, steps = 0.1, 12
    method = pt_ef.EF21SGDM(compressor=pt_comp.BlockTopK(block=16,
                                                         k_per_block=3),
                            eta=0.2)
    cfg = pt_sim.SimConfig(n=N, gamma=gamma, steps=steps, carrier=up,
                           down_carrier=down, down_compressor=down_comp)
    out = pt_sim.run(prob, method, cfg, seed=0)

    x = prob.init_x()
    gen = torch.Generator()
    g0 = prob.stoch_grad(x, gen, 1, N)
    efc = pt_dist.EFConfig(method=method, carrier=up, down_carrier=down,
                           down_compressor=down_comp)
    st = pt_dist.init_ef_state(efc, x, N, init_grads=g0)
    g_use = st["h"] if efc.has_downlink else st["server"]
    gns = []
    for t in range(steps):
        x = {k: v - gamma * g_use[k] for k, v in x.items()}
        g_use, st = pt_dist.ef_round(efc, prob.stoch_grad(x, gen, 1, N), st,
                                     step=t)
        gns.append(pt_ef.tree_norm_sq(prob.full_grad(x)))
    assert torch.equal(out["grad_norm_sq"], torch.stack(gns))
    for k in x:
        assert torch.equal(out["x_final"][k], x[k])


def test_metrics_stay_on_the_device_until_the_end():
    """The per-step metrics come back stacked, as tensors, once."""
    _, prob = problems("logistic")
    out = pt_sim.run(prob, pt_ef.EF21SGDM(compressor=pt_comp.TopK(k=5)),
                     pt_sim.SimConfig(n=N, steps=5), seed=1)
    assert isinstance(out["grad_norm_sq"], torch.Tensor)
    assert out["grad_norm_sq"].shape == (5,)
    assert out["loss"].shape == (5,)


def test_async_and_sampled_hops_are_refused_as_the_reference():
    _, prob = problems("logistic")
    m = pt_ef.EF21SGDM(compressor=pt_comp.TopK(k=5))
    with pytest.raises(ValueError, match="run_async"):
        pt_sim.run(prob, m, pt_sim.SimConfig(
            n=N, steps=2, participation=pt_part.Participation("async")))
    with pytest.raises(ValueError, match="does not compose"):
        pt_sim.run(prob, m, pt_sim.SimConfig(
            n=N, steps=2, participation=pt_part.Participation("sampled", 0.5),
            hops=pt_hier.Hops(pods=2, cross_carrier="sparse",
                              cross_compressor=pt_comp.TopK(k=2))))


def test_ef_config_carries_every_axis():
    """Every field of the round's EFConfig comes from the SimConfig, but
    the sharded round's mesh axes (``client_axes``), which the simulator's
    single-device round never reads: it stays None."""
    sched = pt_sched.CompressionSchedule.uniform(pt_comp.TopK(k=2), "sparse")
    cfg = pt_sim.SimConfig(carrier="quant4", down_carrier="quant8",
                           down_compressor=pt_comp.TopK(k=3), schedule=sched,
                           participation=pt_part.Participation("sampled"),
                           hops=pt_hier.Hops(pods=2))
    m = pt_ef.EF21SGDM()
    efc = pt_sim.ef_config(cfg, m)
    assert efc == pt_dist.EFConfig(
        method=m, **{f.name: getattr(cfg, f.name)
                     for f in dataclasses.fields(pt_dist.EFConfig)
                     if f.name not in ("method", "client_axes")})
    assert efc.client_axes is None
