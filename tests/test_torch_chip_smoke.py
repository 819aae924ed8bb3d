"""The launch counts chip_smoke.py holds each training path to
(``expected_launches``: derived from the path's EF config, per group of a
schedule, per pod of a cross hop) against the wrappers' actual calls on the
CPU, where every wrapper runs its kernel's plain version: each call of a
wrapper is one launch on the card. Every training path of chip_smoke.py,
at smoke size, 2 steps."""
import functools
import importlib.util
import json
import os

import pytest

from repro_torch.kernels import ops
from repro_torch.launch import build as pt_build
from repro_torch.launch import session as pt_session
from repro_torch.launch import spec as pt_spec
from repro_torch.models import model as pt_model
from test_torch_schedule import one_torch_thread  # noqa: F401 (autouse)

ROOT = os.path.join(os.path.dirname(__file__), "..")
KERNELS = ("block_topk", "ef21_sgdm_update", "ef21_sgdm_topk_quant",
           "dequant_add", "block_quantize", "block_dequantize")


def _chip_smoke():
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(ROOT, "chip_smoke.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


CS = _chip_smoke()
PATHS = [
    pytest.param("fused_quickstart", {"carrier": "quant8",
                                      "downlink_carrier": "quant4"}, id="A"),
    pytest.param("fused_quickstart", {"carrier": "quant8",
                                      "downlink_carrier": "quant4",
                                      "compressor": "identity",
                                      "compressor_kw": {}}, id="B"),
    pytest.param("fused_quickstart", {"carrier": "fused_quant8",
                                      "downlink_carrier": "fused_quant4"},
                 id="fused_quant8"),
    pytest.param("fused_quickstart", {"carrier": "fused"}, id="fused"),
    pytest.param("fused_quickstart", CS.RESUME_PATH, id="resumable"),
    pytest.param("fused_quickstart", {"groups": CS.G_GROUPS}, id="G"),
    pytest.param("mixed_schedule", {}, id="M"),
    pytest.param("fused_quickstart", {"participation": {
        "mode": "sampled", "fraction": 0.25, "seed": 7}}, id="S"),
    pytest.param("hierarchy_quant4_cross", {}, id="H"),
    pytest.param("fused_quickstart", {"carrier": "dense",
                                      "compressor": "block_quant",
                                      "compressor_kw": {"bits": 8,
                                                        "block": 256},
                                      "downlink_carrier": "quant4"},
                 id="dense_block_quant"),
]


@pytest.mark.parametrize("name,overrides", PATHS)
def test_expected_launches_equal_the_wrapper_calls(monkeypatch, name,
                                                   overrides):
    calls = dict.fromkeys(KERNELS, 0)
    for kernel in KERNELS:
        def counted(*a, _fn=getattr(ops, kernel), _k=kernel, **kw):
            calls[_k] += 1
            return _fn(*a, **kw)
        monkeypatch.setattr(ops, kernel, counted)
    with open(os.path.join(ROOT, "results", "specs", f"{name}.json")) as f:
        spec = pt_spec.RunSpec.from_dict(dict(
            json.load(f), smoke=True, seq_len=32, **overrides))
    sess = pt_session.Session(spec, device="cpu")
    sess.params                                     # builds the state
    per_step = CS.expected_launches(pt_build.ef_config(spec), sess.params)
    for k in calls:
        calls[k] = 0
    sess.train(2, log_every=0)
    assert calls == {k: 2 * per_step.get(k, 0) for k in KERNELS}


def test_the_full_width_phases_launch_their_stated_counts():
    """G: K3, K6, K5 and K4 8 a step (the embedding and 7 matrices); M: K5
    and K6 8 a step; S: K2 11; H: K5 and K6 2 pods x 11 leaves."""
    want = {"G": {"ef21_sgdm_topk_quant": 8, "block_dequantize": 8,
                  "block_quantize": 8, "dequant_add": 8},
            "M": {"block_quantize": 8, "block_dequantize": 8},
            "S": {"ef21_sgdm_update": 11},
            "H": {"block_quantize": 22, "block_dequantize": 22}}
    for p in PATHS:
        if p.id in want:
            name, overrides = p.values
            with open(os.path.join(ROOT, "results", "specs",
                                   f"{name}.json")) as f:
                spec = pt_spec.RunSpec.from_dict(dict(json.load(f),
                                                      **overrides))
            sess = pt_session.Session(spec, device="cpu")
            tree = pt_model.init_params(sess.cfg, None, "meta")
            got = CS.expected_launches(pt_build.ef_config(spec), tree)
            assert {k: v for k, v in got.items() if v} == want[p.id], p.id


# ---------------------------------------------------------------------------
# phase P: the simulator's runs
# ---------------------------------------------------------------------------

# each cell's problem at a CPU size (the same class and client count)
P_SMALL = {"P-fig1": {},
           "P-exp1": dict(n=10, m_per_client=8, l=20, c=10),
           "P-exp3": dict(n=100, d=8),
           "P-exp4": dict(n=5, m_per_client=8, in_dim=40, hidden=24, c=10),
           "P-smoke": dict(n=4, d=64, sigma=0.0)}


def _p_runs():
    from repro_torch.core import compressors as comp_lib
    from repro_torch.core import ef as ef_lib
    from repro_torch.core import simulate
    return CS.p_runs(simulate, ef_lib, comp_lib)


@pytest.mark.parametrize("row", _p_runs(), ids=lambda r: f"{r[0]} {r[1]}")
def test_phase_p_counts_equal_the_simulator_calls(monkeypatch, row):
    """Each run of phase P, at a CPU size for 2 rounds: the wrappers'
    calls equal ``expected_launches`` of the run's EF config a round."""
    import dataclasses
    from repro_torch.core import problems, simulate
    cell, _, method, cfg = row
    calls = dict.fromkeys(KERNELS, 0)
    for kernel in KERNELS:
        def counted(*a, _fn=getattr(ops, kernel), _k=kernel, **kw):
            calls[_k] += 1
            return _fn(*a, **kw)
        monkeypatch.setattr(ops, kernel, counted)
    cls = CS.P_PROBLEMS.get(cell, ("RandomQuadratics",))[0]
    prob = getattr(problems, cls)(device="cpu", **P_SMALL[cell])
    sim = simulate.Simulation(prob, method,
                              dataclasses.replace(cfg, steps=2), seed=0)
    per_step = CS.expected_launches(sim.efc, sim.x)
    for k in calls:
        calls[k] = 0
    for _ in range(2):
        sim.step()
    assert calls == {k: 2 * per_step.get(k, 0) for k in KERNELS}


def test_phase_p_launches_its_stated_counts():
    """At the cells' full shapes: P-exp1 fused K2 once a round, quant4 K5
    and K6 once (one leaf); P-exp4 K3, K6, K5 and K4 once a leaf (6
    leaves); P-fig1 and P-exp3 none (TopK on the dense plan)."""
    import torch
    from repro_torch.core import simulate

    def meta(shapes):
        return {k: torch.empty(s, device="meta") for k, s in shapes.items()}
    e1, e4 = CS.P_EXP1, CS.P_EXP4
    trees = {"P-fig1": meta({"": (2,)}),
             "P-exp1": meta({"": (e1["c"], e1["l"] + 1)}),
             "P-exp3": meta({"": (CS.P_EXP3["d"],)}),
             "P-exp4": meta({"b1": (e4["hidden"],), "b2": (e4["hidden"],),
                             "b3": (e4["c"],),
                             "w1": (e4["in_dim"], e4["hidden"]),
                             "w2": (e4["hidden"], e4["hidden"]),
                             "w3": (e4["hidden"], e4["c"])})}
    want = {("P-exp1", "fused"): {"ef21_sgdm_update": 1},
            ("P-exp1", "quant4"): {"block_quantize": 1,
                                   "block_dequantize": 1},
            ("P-exp4", "fused_quant8"): {"ef21_sgdm_topk_quant": 6,
                                         "block_dequantize": 6,
                                         "block_quantize": 6,
                                         "dequant_add": 6}}
    assert sum(v.numel() for v in trees["P-exp4"].values()) == 10_510_346
    for cell, label, method, cfg in _p_runs():
        if cell not in trees:
            continue
        got = CS.expected_launches(simulate.ef_config(cfg, method),
                                   trees[cell])
        key = (cell, cfg.carrier)
        assert {k: v for k, v in got.items() if v} == want.get(key, {}), \
            (cell, label)


def _small_sim(row):
    from repro_torch.core import problems, simulate
    cell, _, method, cfg = row
    cls = CS.P_PROBLEMS.get(cell, ("RandomQuadratics",))[0]
    prob = getattr(problems, cls)(device="cpu", **P_SMALL[cell])
    return simulate.Simulation(prob, method, cfg, seed=0)


@pytest.mark.parametrize("row", [r for r in _p_runs()
                                 if r[0] in ("P-exp1", "P-exp4")],
                         ids=lambda r: f"{r[0]} {r[1]}")
def test_phase_p_round_check_covers_every_call(row):
    """The recorded round of each kernel-launching P run: every wrapper
    call is kept with its inputs and checked against the plain version
    (on the CPU the wrapper runs it, so all are equal), and the calls
    equal ``expected_launches`` a round."""
    from repro_torch.kernels import ref
    sim = _small_sim(row)
    sim.step()
    with CS.recorded_calls(ops) as calls:
        sim.step()
    per_step = CS.expected_launches(sim.efc, sim.x)
    names = [c[0] for c in calls]
    assert {k: names.count(k) for k in set(names)} == \
        {k: v for k, v in per_step.items() if v}
    shapes = CS.check_calls_plain(ref, row[1], calls)
    assert set(shapes) == set(names)
    for name in KERNELS:                        # the wrappers are restored
        assert getattr(ops, name).__module__ == ops.__name__


@pytest.mark.parametrize("kernel", ["ef21_sgdm_topk_quant", "dequant_add",
                                    "block_quantize", "block_dequantize"])
def test_phase_p_round_check_fails_on_a_wrong_kernel(monkeypatch, kernel):
    """A wrapper whose output is one ulp off at one value fails P-exp4's
    recorded-round check."""
    import torch
    from repro_torch.kernels import ref
    row = next(r for r in _p_runs() if r[0] == "P-exp4")
    sim = _small_sim(row)
    sim.step()

    fn = getattr(ops, kernel)

    @functools.wraps(fn)
    def off(*a, **kw):
        out = fn(*a, **kw)
        first = out[0] if isinstance(out, tuple) else out
        flat = first.view(-1)
        if first.dtype.is_floating_point:
            flat[0] = torch.nextafter(flat[0], flat[0] + 1)
        else:
            flat[0] ^= 1
        return out
    monkeypatch.setattr(ops, kernel, off)
    with CS.recorded_calls(ops) as calls:
        sim.step()
    with pytest.raises(SystemExit):
        CS.check_calls_plain(ref, "mutated", calls)
