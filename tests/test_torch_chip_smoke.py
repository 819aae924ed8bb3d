"""The launch counts chip_smoke.py holds each training path to
(``expected_launches``: derived from the path's EF config, per group of a
schedule, per pod of a cross hop) against the wrappers' actual calls on the
CPU, where every wrapper runs its kernel's plain version: each call of a
wrapper is one launch on the card. Every training path of chip_smoke.py,
at smoke size, 2 steps."""
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
