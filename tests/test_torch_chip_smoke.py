"""The launch counts chip_smoke.py holds each training path to
(``expected_launches``: derived from the path's EF config, per group of a
schedule, per pod of a cross hop) against the wrappers' actual calls on the
CPU, where every wrapper runs its kernel's plain version: each call of a
wrapper is one launch on the card. Every training path of chip_smoke.py,
at smoke size, 2 steps."""
import dataclasses
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
    pytest.param("fused_quickstart", CS.W_PATH, id="W"),
    *[pytest.param("fused_quickstart", dict(CS.R_PATH, arch=arch,
                                            clients=clients), id=name)
      for name, arch, _, clients, _ in CS.D_CELLS if clients],
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
    and K6 8 a step; S: K2 11; H: K5 and K6 2 pods x 11 leaves; W: K3, K6,
    K5 and K4 11 (every leaf, at block 4096)."""
    want = {"G": {"ef21_sgdm_topk_quant": 8, "block_dequantize": 8,
                  "block_quantize": 8, "dequant_add": 8},
            "W": {"ef21_sgdm_topk_quant": 11, "block_dequantize": 11,
                  "block_quantize": 11, "dequant_add": 11},
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


def test_the_d_phases_launch_their_stated_counts():
    """R and the D phases at full width, cut as chip_smoke.py cuts them:
    K3, K6, K5 and K4 once a leaf a step (11 leaves; 12 with musicgen's
    frontend_proj, or olmoe's five MoE leaves in place of the MLP's four);
    K7 once a layer of the prefill only where the layer has no window, no
    soft cap and hd 32, 64 or 128: every layer of smollm-360m (32),
    granite-34b (1), musicgen-medium (6 of hd 64), olmoe-1b-7b and
    internvl2-76b (1 of hd 128), none of h2o-danube-3-4b (windows, hd 120)
    or gemma2-9b (windows and caps, hd 256); once an application of
    zamba2-1.2b's shared block (2 groups of 6 of its 13 layers), never in
    the attention-free falcon-mamba-7b (its 11 Mamba1 leaves; zamba2's 23
    are 12 stacked Mamba2 leaves and the shared block's 9). The
    serve-only D-internvl2 takes no step."""
    leaves = {"D-musicgen": 12, "D-olmoe": 12, "D-zamba2": 23}
    flash = {"R": 32, "D-granite": 1, "D-musicgen": 6, "D-olmoe": 1,
             "D-internvl2": 1, "D-zamba2": 2}
    cells = [("R", "smollm-360m", {}, 8)] + [
        (name, arch, cut, clients)
        for name, arch, cut, clients, _ in CS.D_CELLS]
    for name, arch, cut, clients in cells:
        with open(os.path.join(ROOT, "results", "specs",
                               "fused_quickstart.json")) as f:
            spec = pt_spec.RunSpec.from_dict(dict(
                json.load(f), arch=arch, **CS.R_PATH))
        sess = pt_session.Session(spec, device="cpu")
        cfg = dataclasses.replace(sess.cfg, **cut)
        assert pt_model.flash_layers(cfg) == flash.get(name, 0), name
        if clients is None:
            assert name == "D-internvl2"
            continue
        n = leaves.get(name, 11)
        tree = pt_model.init_params(cfg, None, "meta")
        assert len(tree) == n, name
        got = CS.expected_launches(pt_build.ef_config(spec), tree)
        assert {k: v for k, v in got.items() if v} == {
            "ef21_sgdm_topk_quant": n, "block_dequantize": n,
            "block_quantize": n, "dequant_add": n}, name


@pytest.mark.parametrize("name,params,cache_bytes,prefill", [
    ("D-musicgen", 232_017_408, 330_301_440, CS.FLASH_MUSICGEN),
    ("D-olmoe", 522_590_208, 69_206_016, CS.FLASH_OLMOE),
    ("D-internvl2", 1_973_444_608, 42_991_616, CS.FLASH_INTERNVL2),
    ("D-falcon-mamba", 371_646_464, 4_587_520, None),
    ("D-zamba2", 465_220_544, 250_099_712, CS.FLASH_ZAMBA2)])
def test_the_new_d_cells_are_their_stated_sizes(name, params, cache_bytes,
                                                prefill):
    """The cut configs' parameters (the meta tree, nothing drawn), their
    serve's cache bytes (the prefix at serving's padding, the prompt and
    the decode budget) and K7's (B, S, H, KV, hd) at their prefill (None:
    the attention-free falcon-mamba runs no K7)."""
    from repro_torch.data import pipeline as pipe_lib
    row = {r[0]: r for r in CS.D_CELLS}[name]
    _, arch, cut, _, serve = row
    cfg = dataclasses.replace(pt_session.Session(
        pt_spec.RunSpec(arch=arch), device="cpu").cfg, **cut)
    tree = pt_model.init_params(cfg, None, "meta")
    assert sum(t.numel() for t in tree.values()) == params
    n_prefix = pipe_lib.prefix_token_count(cfg, pipe_lib.PREFIX_PAD_SPEC)
    cache = pt_model.init_cache(cfg, serve["batch"], pt_build.cache_len(
        serve["prompt_len"], serve["decode_steps"], n_prefix), device="meta")
    assert sum(t.numel() * t.element_size()
               for t in cache.values()) == cache_bytes
    if prefill is None:
        assert pt_model.flash_layers(cfg) == 0
        assert name not in {n for _, _, n in CS.FLASH_D}
        return
    assert prefill == (serve["batch"], n_prefix + serve["prompt_len"],
                       cfg.num_heads, cfg.num_kv_heads, cfg.head_dim_)
    assert (name, prefill) in {(n, s) for _, s, n in CS.FLASH_D}


def _d_smoke_calls(arch):
    """A smoke-size Session of ``arch`` on the D phases' wire, 2 clients,
    one step with its K2-K6 calls recorded shape-only; and the step's
    ``expected_launches``."""
    with open(os.path.join(ROOT, "results", "specs",
                           "fused_quickstart.json")) as f:
        spec = pt_spec.RunSpec.from_dict(dict(
            json.load(f), smoke=True, seq_len=32, arch=arch, clients=2,
            global_batch=2, **CS.R_PATH))
    sess = pt_session.Session(spec, device="cpu")
    per_step = CS.expected_launches(pt_build.ef_config(spec), sess.params)
    with CS.recorded_calls(ops, CS.ROW_KERNELS, shapes_only=True) as calls:
        sess.train(1, log_every=0)
    return calls, {k: v for k, v in per_step.items() if v}


@pytest.mark.parametrize("arch", [a for _, a, _, c, _ in CS.D_CELLS if c])
def test_the_d_phases_plain_check_covers_every_call(monkeypatch, arch):
    """A D phase's shape-only record holds every kernel call of its steps
    (meta tensors, the in-place outputs by name), and each distinct call,
    run again on random inputs of its shapes, equals the plain version
    taken a few rows at a time: on the CPU the wrapper runs the plain
    version on the whole call, so this holds the row cuts (K4's flat base
    among them) to it."""
    import torch
    from repro_torch.kernels import ref
    monkeypatch.setattr(CS, "PLAIN_ROWS", 5)
    calls, per_step = _d_smoke_calls(arch)
    assert CS._call_counts(calls) == per_step
    for name, args, outs in calls:
        assert outs == ()
        assert all(t.device.type == "meta" for t in args.values()
                   if isinstance(t, torch.Tensor)), name
        if name == "ef21_sgdm_topk_quant":
            assert (args["v_out"], args["g_out"]) == ("v", "g")
    shapes = CS.check_shapes_plain(ops, ref, arch, calls, device="cpu")
    assert set(shapes) == set(per_step)
    for name in KERNELS:                        # the wrappers are restored
        assert getattr(ops, name).__module__ == ops.__name__


@pytest.mark.parametrize("kernel", ["ef21_sgdm_topk_quant", "dequant_add",
                                    "block_quantize", "block_dequantize"])
def test_the_d_phases_plain_check_fails_on_a_wrong_kernel(monkeypatch,
                                                          kernel):
    """A wrapper one ulp (or one bit) off at one value fails D-gemma2's
    check of its recorded calls."""
    from repro_torch.kernels import ref
    calls, _ = _d_smoke_calls("gemma2-9b")
    _off_by_one(monkeypatch, kernel)
    with pytest.raises(SystemExit):
        CS.check_shapes_plain(ops, ref, "mutated", calls, device="cpu")


def _no_card(monkeypatch):
    """chip_smoke.py's card calls as no-ops on the CPU."""
    import torch
    for name in ("synchronize", "reset_peak_memory_stats", "empty_cache"):
        monkeypatch.setattr(torch.cuda, name, lambda *a, **k: None)
    monkeypatch.setattr(torch.cuda, "max_memory_allocated", lambda *a: 0)
    monkeypatch.setattr(torch.Tensor, "cuda", lambda self, *a, **k: self)


def test_the_serve_only_phase_takes_no_training_step(monkeypatch, capsys):
    """D-internvl2's phase (serve_phase) at smoke size on the CPU: the
    Session serves its fresh init without building a training state
    (serve_phase fails if it does) and never steps; K7 once a layer, none
    in decode."""
    _no_card(monkeypatch)

    def no_step(self):
        raise AssertionError("a serve-only phase took a training step")
    monkeypatch.setattr(pt_session.Session, "step_once", no_step)

    def smoke_session(spec, device):
        return pt_session.Session(dataclasses.replace(spec, smoke=True),
                                  device="cpu")
    def counted(*a, _fn=ops.flash_attention, **kw):
        ops.launches["flash_attention"] += 1     # a launch on the card
        return _fn(*a, **kw)
    monkeypatch.setattr(ops, "flash_attention", counted)
    name, arch, cut, clients, _ = CS.D_CELLS[-1]
    assert (name, clients) == ("D-internvl2", None)
    from repro_torch.models import model as model_lib
    launches = CS.serve_phase(smoke_session, pt_spec, model_lib, ops, name,
                              arch, cut, dict(batch=2, prompt_len=24,
                                              decode_steps=3))
    assert {k: v for k, v in launches.items() if v} == {"flash_attention": 1}
    out = capsys.readouterr().out
    assert "serve only" in out and "cache_bytes" in out


@pytest.mark.parametrize("name,want", [("D-falcon-mamba", 0),
                                       ("D-zamba2", 6)])
def test_the_ssm_cells_serve_launches_k7_once_a_shared_block(
        monkeypatch, capsys, name, want):
    """D-falcon-mamba's and D-zamba2's rows through serve_phase at smoke
    size on the CPU (the rows' depth cut kept: zamba2's 13 smoke layers
    are 6 groups of 2 and a tail), each wrapper call counted as a launch
    on the card: K7 exactly ``model.flash_layers`` times in the prefill,
    once an application of the shared block and never in falcon-mamba;
    none in decode; the serve's cache bytes printed."""
    _no_card(monkeypatch)

    def smoke_session(spec, device):
        return pt_session.Session(dataclasses.replace(spec, smoke=True),
                                  device="cpu")

    def counted(*a, _fn=ops.flash_attention, **kw):
        ops.launches["flash_attention"] += 1     # a launch on the card
        return _fn(*a, **kw)
    monkeypatch.setattr(ops, "flash_attention", counted)
    _, arch, cut, clients, _ = {r[0]: r for r in CS.D_CELLS}[name]
    assert clients == 8
    cfg = dataclasses.replace(pt_session.Session(
        pt_spec.RunSpec(arch=arch, smoke=True), device="cpu").cfg, **cut)
    assert pt_model.flash_layers(cfg) == want
    from repro_torch.models import model as model_lib
    launches = CS.serve_phase(smoke_session, pt_spec, model_lib, ops, name,
                              arch, cut, dict(batch=2, prompt_len=64,
                                              decode_steps=3))
    assert {k: v for k, v in launches.items() if v} == (
        {"flash_attention": want} if want else {})
    assert "cache_bytes" in capsys.readouterr().out


def test_routed_drops_are_moe_apply_s_dropped_frac():
    """The drop fraction chip_smoke.py reads off captured routing equals
    the dropped_frac moe_apply computes, at capacities that drop and one
    that does not."""
    import torch
    from repro_torch.configs import base as cb
    from repro_torch.models import moe
    for cf in (0.5, 1.0, 4.0):
        cfg = dataclasses.replace(cb.get_smoke("olmoe-1b-7b"),
                                  moe_capacity_factor=cf)
        params = pt_model.init_params(cfg, torch.Generator().manual_seed(0))
        p = {k[len("layers/moe/"):]: t[0] for k, t in params.items()
             if k.startswith("layers/moe/")}
        x = torch.randn(3, 20, cfg.d_model,
                        generator=torch.Generator().manual_seed(1))
        with moe.capture_routing() as seen:
            _, aux = moe.moe_apply(p, x, k=cfg.num_experts_per_tok, cf=cf,
                                   eps=cfg.norm_eps)
        got, = CS.routed_drops(cfg, seen)
        assert abs(got - float(aux["dropped_frac"])) < 1e-6, cf


def _smoke_session(arch, **overrides):
    with open(os.path.join(ROOT, "results", "specs",
                           "fused_quickstart.json")) as f:
        spec = pt_spec.RunSpec.from_dict(dict(
            json.load(f), smoke=True, seq_len=32, arch=arch, clients=2,
            global_batch=4, **CS.R_PATH, **overrides))
    return pt_session.Session(spec, device="cpu")


def test_moe_step_aux_prints_the_step_s_aux(capsys):
    """D-olmoe's hook: the aux of the vmap forward (no gradients, block
    recompute on) is the aux of the step's own client pass."""
    from repro_torch.core import distributed as dist
    sess = _smoke_session("olmoe-1b-7b")
    sess.cfg = dataclasses.replace(sess.cfg, remat=True,
                                   moe_capacity_factor=1.0)
    assert CS.moe_step_aux(sess) is None
    out = capsys.readouterr().out
    _, aux, _ = dist.per_client_value_and_grad(
        lambda p, b: pt_model.train_loss(sess.cfg, p, b), sess.params,
        sess.batch_for(sess.step), sess.n_clients)
    assert f"(mean {float(aux['dropped_frac']):.5f})" in out
    assert f"load_balance mean {float(aux['load_balance']):.5f}" in out
    assert float(aux["dropped_frac"]) > 0


def test_frontend_hook_holds_frontend_proj_unchanged(monkeypatch):
    """D-musicgen's hook passes over real steps on the CPU, and fails when
    a step moves frontend_proj."""
    sess = _smoke_session("musicgen-medium")
    for _ in range(2):
        after = CS.frontend_unchanged(sess)
        sess.step_once()
        after()
    after = CS.frontend_unchanged(sess)
    sess.params["frontend_proj"].add_(1.0)
    with pytest.raises(SystemExit):
        after()


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


# ---------------------------------------------------------------------------
# phase F: the wire stream's publish and a replica's apply
# ---------------------------------------------------------------------------

F_PATHS = [
    pytest.param("fused_quickstart", CS.F_PATH, id="F"),
    pytest.param("fused_quickstart", {k: v for k, v in CS.F_TCP.items()
                                      if k not in ("smoke", "seq_len")},
                 id="F-tcp"),
    pytest.param("fused_quickstart", {"carrier": "quant8",
                                      "downlink_carrier": "quant4",
                                      "compressor": "identity",
                                      "compressor_kw": {}},
                 id="dense-payload"),
    pytest.param("mixed_schedule", {}, id="mixed_schedule"),
    pytest.param("fused_quickstart", {"carrier": "fused"}, id="no-downlink"),
]


def _published(name, overrides, tmp_path, steps=2):
    """A smoke-size Session publishing ``steps`` steps on the CPU, a replica
    at step 0, and the trainer's h before its last step."""
    from repro_torch.launch import fleet as fleet_lib
    with open(os.path.join(ROOT, "results", "specs", f"{name}.json")) as f:
        spec = pt_spec.RunSpec.from_dict(dict(
            json.load(f), smoke=True, seq_len=32, **overrides))
    sess = pt_session.Session(spec, device="cpu")
    sess.publish_to(str(tmp_path))
    rep = fleet_lib.ServeReplica(str(tmp_path), device="cpu")
    h_prev = None
    for _ in range(steps):
        h_prev = sess.ef_state.get("h")
        sess.step_once()
    return sess, rep, h_prev


@pytest.mark.parametrize("name,overrides", F_PATHS)
def test_phase_f_counts_equal_the_stream_calls(monkeypatch, tmp_path, name,
                                               overrides):
    """A published step calls the wrappers ``expected_launches`` plus
    ``stream_launches``' publish; a replica's apply its apply."""
    from repro_torch.launch import fleet as fleet_lib
    calls = dict.fromkeys(KERNELS, 0)
    for kernel in KERNELS:
        def counted(*a, _fn=getattr(ops, kernel), _k=kernel, **kw):
            calls[_k] += 1
            return _fn(*a, **kw)
        monkeypatch.setattr(ops, kernel, counted)
    sess, _, _ = _published(name, overrides, tmp_path, steps=0)
    efc = pt_build.ef_config(sess.spec)
    per_step = CS.expected_launches(efc, sess.params)
    pub, app = CS.stream_launches(efc, sess.params)
    for k in calls:
        calls[k] = 0
    sess.train(2, log_every=0)
    assert calls == {k: 2 * (per_step.get(k, 0) + pub.get(k, 0))
                     for k in KERNELS}
    rep = fleet_lib.ServeReplica(str(tmp_path), bootstrap_step=0,
                                 device="cpu")
    for k in calls:
        calls[k] = 0
    assert rep.sync() == 2
    assert calls == {k: 2 * app.get(k, 0) for k in KERNELS}
    if efc.has_downlink:
        assert sum(pub.values()) and sum(app.values())


@pytest.mark.parametrize("name,overrides", F_PATHS[:4])
def test_phase_f_call_check_covers_every_call(tmp_path, name, overrides):
    """Phase F's recorded publish (a republish: nothing written) and apply:
    every wrapper call kept with its inputs and held against the plain
    version (on the CPU the wrapper runs it, so all are equal); the calls
    equal ``stream_launches``; the replica lands one record further."""
    from repro_torch.kernels import ref
    sess, rep, h_prev = _published(name, overrides, tmp_path)
    records = os.path.join(str(tmp_path), "records")
    before = sorted(os.listdir(records))
    shapes = CS.publish_call_check(ops, ref, sess, h_prev, name)
    assert sorted(os.listdir(records)) == before
    assert CS.apply_call_check(ops, ref, rep, name)
    assert rep.step == 1
    pub, app = CS.stream_launches(pt_build.ef_config(sess.spec), sess.params)
    assert set(shapes) == {k for k, v in pub.items() if v}
    for name in KERNELS:                        # the wrappers are restored
        assert getattr(ops, name).__module__ == ops.__name__


def _off_by_one(monkeypatch, kernel):
    """Make ``ops.<kernel>`` return one ulp (or one bit) off at one value."""
    import torch
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


@pytest.mark.parametrize("kernel", ["block_quantize", "dequant_add"])
def test_phase_f_publish_refuses_a_wrong_kernel(monkeypatch, tmp_path,
                                                kernel):
    """A wrong K5 or K4 in the republish: its wires no longer integrate to
    the trainer's h, and the Publisher's verify refuses them."""
    from repro_torch.core import stream as stream_lib
    from repro_torch.kernels import ref
    sess, _, h_prev = _published("fused_quickstart", CS.F_PATH, tmp_path)
    _off_by_one(monkeypatch, kernel)
    with pytest.raises(stream_lib.StreamIntegrityError):
        CS.publish_call_check(ops, ref, sess, h_prev, "mutated")


@pytest.mark.parametrize("name,overrides,kernel", [
    pytest.param("fused_quickstart", CS.F_PATH, "dequant_add", id="K4"),
    pytest.param("fused_quickstart", F_PATHS[1].values[1],
                 "block_dequantize", id="K6")])
def test_phase_f_apply_check_fails_on_a_wrong_kernel(monkeypatch, tmp_path,
                                                     name, overrides,
                                                     kernel):
    """A wrong K4 (fused_quant4's dense payload) or K6 (quant4's sparse
    payload) in a replica's apply fails the recorded calls' check."""
    from repro_torch.kernels import ref
    _, rep, _ = _published(name, overrides, tmp_path)
    _off_by_one(monkeypatch, kernel)
    with pytest.raises(SystemExit):
        CS.apply_call_check(ops, ref, rep, "mutated")


def test_phase_f_launches_its_stated_counts():
    """At full width, phase F's fused_quant4 downlink: a publish K5 and K4
    once a leaf (11), an apply K4 11; its tcp smoke (quant4, the sparse
    payload): a publish K5 and K6 11, an apply K6 11."""
    for overrides, smoke, want_pub, want_app in (
            (CS.F_PATH, False, {"block_quantize": 11, "dequant_add": 11},
             {"dequant_add": 11}),
            ({k: v for k, v in CS.F_TCP.items() if k != "seq_len"}, True,
             {"block_quantize": 11, "block_dequantize": 11},
             {"block_dequantize": 11})):
        with open(os.path.join(ROOT, "results", "specs",
                               "fused_quickstart.json")) as f:
            spec = pt_spec.RunSpec.from_dict(dict(json.load(f),
                                                  **overrides))
        assert spec.smoke == smoke
        sess = pt_session.Session(spec, device="cpu")
        tree = pt_model.init_params(sess.cfg, None, "meta")
        pub, app = CS.stream_launches(pt_build.ef_config(spec), tree)
        assert ({k: v for k, v in pub.items() if v},
                {k: v for k, v in app.items() if v}) == (want_pub, want_app)


# ---------------------------------------------------------------------------
# phases MD1 and MD4: the multi-device runtime's CPU side
# ---------------------------------------------------------------------------

def _importable_chip_smoke(monkeypatch):
    """chip_smoke as an importable module (MD4's rank processes import
    their function by name)."""
    import importlib
    import sys
    monkeypatch.syspath_prepend(os.path.abspath(ROOT))
    sys.modules.pop("chip_smoke", None)
    return importlib.import_module("chip_smoke")


def test_phase_md1_on_a_gloo_world_of_one(monkeypatch, capsys):
    """MD1's comparison at smoke size on the CPU (gloo instead of NCCL):
    every path bit for bit the single-device round of one client, the
    launch check passing (a plain run counts none)."""
    cs = _importable_chip_smoke(monkeypatch)
    cs.md1_phase(ops, pt_spec, device="cpu", backend="gloo", smoke=True)
    out = capsys.readouterr().out
    for label, _ in cs.MD_PATHS:
        assert f"MD1 {label}: bit for bit" in out
    assert "MD1: gather_to_first on gloo bit for bit" in out
    import torch.distributed as dist
    assert not dist.is_initialized()                  # the world was left


def test_phase_md4_spawns_its_ranks_and_compares(monkeypatch, capsys):
    """MD4 at smoke size on the CPU: 4 spawned gloo ranks, each run's
    trajectory and digests equal on every rank and within MD_TOL of the
    single-process run, the ring's run bit for bit the blocking one's,
    each rank's recorded K3-K6 calls equal to ``expected_launches(...,
    gathered=)`` (md4_run fails otherwise), and every planted fault read
    above MD_TOL. MD4-pod-clients runs one client a pod on (pod 2, data
    2), its client state equal on each pod's data ranks, with the data
    group's all-reduce reported; its fault, the shares unreduced, is
    caught. MD4-publish publishes from the first rank (fused_quant4 down)
    and a single-device replica joined from the stream holds the
    trainer's params bit for bit (md4_phase fails otherwise)."""
    cs = _importable_chip_smoke(monkeypatch)
    runs = [(label, name, dict(over, smoke=True, seq_len=32))
            for label, name, over in cs.MD4_RUNS
            if label != "MD4-multi_pod"]
    faults = [(label, name, dict(over, smoke=True, seq_len=32), fault)
              for label, name, over, fault in cs.MD4_FAULTS]
    label, name, over, steps, _ = cs.MD4_PUBLISH
    publish = (label, name, dict(over, smoke=True, seq_len=32), steps, None)
    cs.md4_phase(pt_session.Session, pt_spec, ops, runs=runs, device="cpu",
                 faults=faults, publish=publish, cut=None)
    out = capsys.readouterr().out
    # MD4-publish: its replica joined from the 4-rank stream, bit for bit
    assert f"{label}: {steps} published step(s), record bytes " in out
    assert "params bit for bit the trainer's" in out
    for rank in range(cs.MD_RANKS):
        assert f"{label} rank {rank}: mesh {{'data': 4, 'model': 1}}" in out
    assert "MD4: the overlap ring bit for bit the blocking gather" in out
    assert "MD4: every planted fault caught" in out
    for label, _, _, _ in faults:
        assert f"{label}: planted fault" in out
    assert "MD4-fault-pod-unreduced: planted fault 'pod-unreduced'" in out
    assert "MD4-pod-clients: client state equal on each pod's 2 data " \
        "ranks every step, one client a pod (2 pods)" in out
    for label, _, over in runs:
        assert f"{label}: loss/g_norm" in out
        pod = over.get("client_granularity") == "pod"
        mesh = "{'pod': 2, 'data': 2, 'model': 1} n 2" if pod \
            else "{'data': 4, 'model': 1} n 4"
        for rank in range(cs.MD_RANKS):
            assert f"{label} rank {rank}: mesh {mesh}" in out
            assert (f"{label} rank {rank}: the data group's all-reduce "
                    "of the gradient shares: ") in out or not pod


# what a rank of each MT run holds of the split dims at smoke size
MT_SMOKE_SPLIT = {
    "MT-padded": {"heads": 2}, "MT-replicated": {"heads": 3},
    "MT-falcon-mamba": {"d_inner": 128},
    "MT-zamba2": {"heads": 2, "d_inner": 128, "ssm_heads": 4}}


def test_phase_mt_spawns_its_ranks_and_checks(monkeypatch, capsys):
    """MT at smoke size on the CPU: 4 spawned gloo ranks on (data 2, model
    2), the padded and the unpadded smollm runs and the SSM runs; each
    rank's gradient shards within MT_GRAD_TOL of the unsharded pass and
    every planted fault of its run above it, every round's client state
    bit for bit the single-device round over the shard tree, loss and
    g_norm equal on every rank, the digests equal per 'model' coordinate
    (mt_phase fails otherwise); MT-pod-zero (pod clients and ZeRO on
    (pod 2, data 1, model 2)) bit for bit MT-padded's first step; then
    MT-single on one device. MT-serve: the unpadded smollm and the SSM
    runs serve on their 4 ranks after their step, against the
    single-device serve of the same params, each rank's cache its shard
    in the reference's layout; the unpadded smollm also serves one row
    (the sequence split over all four ranks)."""
    cs = _importable_chip_smoke(monkeypatch)
    _, losses, served = cs.mt_phase(ops, device="cpu", smoke=True,
                                    smoke_archs=(), smoke_pod=())
    cs.mt_single(pt_session.Session, pt_spec, losses, device="cpu",
                 smoke=True)
    out = capsys.readouterr().out
    assert sorted(MT_SMOKE_SPLIT) == sorted(r[0] for r in cs.MT_RUNS)
    for label, _, _, _, steps, faults in cs.MT_RUNS:
        assert f"{label}: loss/g_norm" in out
        assert len(losses[label]) == steps
        for fault in faults:
            assert f"{label}: planted fault {fault!r}" in out
        for d in range(2):
            for m in range(2):
                assert f"{label} rank {{'data': {d}, 'model': {m}}}: split " \
                    f"a rank {MT_SMOKE_SPLIT[label]}" in out
    assert "MT-single (one device, 2 clients, no 'model' axis): losses" \
        in out
    # MT-serve: each serving run's tokens equal on every rank and its
    # prefill against one device within the bound (mt_serve_checks fails
    # otherwise)
    B, S, steps = cs.MT_SERVE_SMOKE
    for label in cs.MT_SERVE:
        assert f"{label} serve: tokens equal on every rank; against one " \
            "device" in out
        for rank in range(4):
            assert f"{label} serve rank {rank}: B {B} × {S}, {steps} " \
                "decode steps" in out
    # MT-replicated's one-row serve: the sequence split over all four
    # ranks, each rank's cache its shard (mt_serve_checks fails otherwise)
    B, S, steps = cs.MT_SERVE_B1_SMOKE
    for label in cs.MT_SERVE_B1:
        assert f"{label} B1 serve: tokens equal on every rank" in out
        for rank in range(4):
            assert f"{label} B1 serve rank {rank}: B {B} × {S}, " \
                f"{steps} decode steps" in out
    assert sorted(served) == sorted(
        [*cs.MT_SERVE, *(label + " B1" for label in cs.MT_SERVE_B1)])
    assert losses["MT-pod-zero"] == losses["MT-padded"][:1]
    assert "MT-pod-zero: pod clients with state sharding 'zero' on " \
        "{'pod': 2, 'data': 1, 'model': 2}" in out
    for p in range(2):
        for m in range(2):
            assert f"MT-pod-zero rank {{'pod': {p}, 'data': 0, 'model': " \
                f"{m}}}: " in out


def _spec(name, overrides):
    with open(os.path.join(ROOT, "results", "specs", f"{name}.json")) as f:
        return pt_spec.RunSpec.from_dict(dict(json.load(f), smoke=True,
                                              seq_len=32, **overrides))


def test_sharded_launch_counts_add_the_gathered_decodes():
    """One rank of the sharded round: the sparse quantized payload decodes
    each gathered client's wire (one K6 more a leaf a client), the fused
    and dense payloads launch what the single-device round does, and a
    cross hop is its one pod's."""
    spec = _spec("fused_quickstart", {"carrier": "quant8",
                                      "downlink_carrier": "quant4"})
    efc = pt_build.ef_config(spec)
    tree = pt_model.init_params(pt_session.Session(spec, device="cpu").cfg,
                                None, "meta")
    flat = CS.expected_launches(efc, tree)
    sharded = CS.expected_launches(efc, tree, gathered=4)
    assert sharded["block_dequantize"] == flat["block_dequantize"] \
        + 4 * len(tree)
    assert sharded["block_quantize"] == flat["block_quantize"]
    spec = _spec("fused_quickstart", {"carrier": "fused_quant8",
                                      "downlink_carrier": "fused_quant4"})
    efc = pt_build.ef_config(spec)
    assert CS.expected_launches(efc, tree, gathered=4) == \
        CS.expected_launches(efc, tree)
    spec = _spec("hierarchy_quant4_cross", {})
    efc = pt_build.ef_config(spec)
    pods = efc.hops.pods
    flat = CS.expected_launches(efc, tree)
    sharded = CS.expected_launches(efc, tree, gathered=2)
    assert flat["block_quantize"] == pods * sharded["block_quantize"]


def test_staged_collectives_count_both_copies(monkeypatch, tmp_path):
    """The host route of core/comm.py (gloo's send/recv with a CUDA
    operand), forced on a CPU tensor in a gloo world of one for both
    collectives: the results are the direct route's, and each collective
    counts its operand's bytes to the host and its result's back."""
    import torch
    from repro_torch.core import comm
    from repro_torch.launch import mesh as mesh_lib
    from repro_torch.launch import multiproc
    multiproc.distributed_init(f"file://{tmp_path / 'store'}", 1, 0,
                               backend="gloo")
    try:
        axes = mesh_lib.make_production_mesh().axes(("data",))
        x = torch.arange(10, dtype=torch.float32)
        direct = (comm.all_reduce_sum(axes, x), comm.all_gather(axes, x))
        monkeypatch.setattr(comm, "_staged", lambda axes, t, op: True)
        comm.reset_stats()
        staged = (comm.all_reduce_sum(axes, x), comm.all_gather(axes, x))
        for a, b in zip(direct, staged):
            assert torch.equal(a, b)
        assert comm.STATS["staged_bytes"] == 2 * 40 + 2 * 40
        assert comm.STATS["collectives"] == 2
        assert comm.STATS["wire_bytes"] == 80
    finally:
        multiproc.shutdown()


def test_replicated_digest_sees_one_bit():
    import torch
    from repro_torch.launch import shardings as sh
    params = {"a": torch.randn(5, 3), "b": torch.randn(7).bfloat16()}
    ef = {"server": {"a": torch.randn(5, 3)}, "h": {"a": torch.zeros(5, 3)}}
    d = sh.replicated_digest(params, ef)
    assert d == sh.replicated_digest({k: v.clone() for k, v in
                                      params.items()}, ef)
    flipped = params["b"].clone()
    flipped.view(torch.int16)[3] ^= 1
    assert d != sh.replicated_digest(dict(params, b=flipped), ef)
    moved = ef["h"]["a"].clone()
    moved[0, 0], moved[1, 0] = 1.0, 0.0
    other = ef["h"]["a"].clone()
    other[1, 0] = 1.0
    assert sh.replicated_digest(params, {**ef, "h": {"a": moved}}) != \
        sh.replicated_digest(params, {**ef, "h": {"a": other}})
