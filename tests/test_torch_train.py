"""The port's training trajectory against the reference's, from the same
weights: the JAX smoke Session (carrier fused_quant8, downlink
fused_quant4) saves its initial state to npz, the port's Session restores
it (``Session.restore_from``: one layout for both packages), and both train
3 steps on the same pipeline batches.

Both run their activations in float32, so the comparison tests the
algorithm rather than two frameworks' bfloat16 roundings. Loss and g_norm
must agree per step within rtol 1e-4. The one thing that can cross it is a
near-tie in a Block-TopK selection: the two packages round the momentum
update differently by an ulp (see test_torch_kernels.py), which can move a
value across the threshold or a mantissa by one step.
"""
import dataclasses
import json
import os

import numpy as np
import pytest
import torch

from repro.launch import session as jax_session
from repro.launch import spec as jax_spec
from repro_torch.launch import session as pt_session
from repro_torch.launch import spec as pt_spec

ROOT = os.path.join(os.path.dirname(__file__), "..")
SPEC = os.path.join(ROOT, "results", "specs", "fused_quickstart.json")
OVERRIDES = {"smoke": True, "seq_len": 64, "carrier": "fused_quant8",
             "downlink_carrier": "fused_quant4"}


def _spec_dict():
    with open(SPEC) as f:
        return dict(json.load(f), **OVERRIDES)


def test_three_steps_match_reference_through_npz_bridge(tmp_path):
    jsess = jax_session.Session(jax_spec.RunSpec.from_dict(_spec_dict()))
    # f32 activations: the reference Session reads its arch config here
    jsess.cfg = dataclasses.replace(jsess.cfg, dtype="float32")
    ckpt = jsess.save(str(tmp_path / "step_0.npz"))
    want = jsess.train(3, log_every=1)

    psess = pt_session.Session(pt_spec.RunSpec.from_dict(_spec_dict()),
                               device="cpu", dtype="float32")
    psess.restore_from(ckpt)
    assert psess.step == 0
    got = psess.train(3, log_every=1)

    assert [r["step"] for r in got] == [r["step"] for r in want] == [0, 1, 2]
    for key in ("loss", "g_norm"):
        np.testing.assert_allclose([r[key] for r in got],
                                   [r[key] for r in want], rtol=1e-4,
                                   err_msg=key)


@pytest.mark.parametrize("compressor", ["block_topk", "identity"])
def test_quantized_wire_tracks_reference_through_npz_bridge(tmp_path,
                                                            compressor):
    """The unfused quantized wire, quant8 up and quant4 down: Block-TopK
    ships the sparse payload (K5/K6 on the selected values), Identity the
    dense payload (K5/K6 on rows of 256, K4 on the downlink). Same weights,
    EF state and batches; loss and g_norm within rtol 1e-4 over 3 steps."""
    overrides = {"carrier": "quant8", "downlink_carrier": "quant4"}
    if compressor == "identity":
        overrides.update(compressor="identity", compressor_kw={})
    spec = dict(_spec_dict(), **overrides)
    jsess = jax_session.Session(jax_spec.RunSpec.from_dict(spec))
    jsess.cfg = dataclasses.replace(jsess.cfg, dtype="float32")
    ckpt = jsess.save(str(tmp_path / "step_0.npz"))
    want = jsess.train(3, log_every=1)

    psess = pt_session.Session(pt_spec.RunSpec.from_dict(spec), device="cpu",
                               dtype="float32")
    psess.restore_from(ckpt)
    got = psess.train(3, log_every=1)
    for key in ("loss", "g_norm"):
        np.testing.assert_allclose([r[key] for r in got],
                                   [r[key] for r in want], rtol=1e-4,
                                   err_msg=key)


def test_bridge_reads_every_leaf_of_the_reference_checkpoint(tmp_path):
    """A checkpoint the reference's checkpoint module wrote reads back
    through the port's ``checkpoint.restore`` leaf for leaf, nested trees
    and all; ``bridge.params_from_jax`` takes an in-memory pytree."""
    from repro.checkpoint import checkpoint as jax_ckpt
    from repro_torch.checkpoint import bridge
    from repro_torch.checkpoint import checkpoint as pt_ckpt
    rng = np.random.RandomState(0)
    tree = {"params": {"embed": rng.randn(4, 3).astype(np.float32),
                       "layers": {"attn": {"wq": rng.randn(2, 3, 1, 2)
                                           .astype(np.float32)}}},
            "opt_state": {},
            "ef_state": {"clients": {"g": {"embed": rng.randn(2, 4, 3)
                                           .astype(np.float32)}},
                         "server": {"embed": rng.randn(4, 3)
                                    .astype(np.float32)}}}
    path = str(tmp_path / "c.npz")
    jax_ckpt.save(path, tree, step=5)
    like = {"params": {"embed": torch.zeros(4, 3),
                       "layers/attn/wq": torch.zeros(2, 3, 1, 2)},
            "opt_state": {},
            "ef_state": {"clients": {"g": {"embed": torch.zeros(2, 4, 3)}},
                         "server": {"embed": torch.zeros(4, 3)}}}
    state, meta = pt_ckpt.restore(path, like)
    assert meta["step"] == 5
    assert sorted(state["params"]) == ["embed", "layers/attn/wq"]
    np.testing.assert_array_equal(state["params"]["layers/attn/wq"].numpy(),
                                  tree["params"]["layers"]["attn"]["wq"])
    np.testing.assert_array_equal(
        state["ef_state"]["clients"]["g"]["embed"].numpy(),
        tree["ef_state"]["clients"]["g"]["embed"])
    assert "h" not in state["ef_state"]
    flat = bridge.params_from_jax({"a/b": np.ones(2, np.float32)})
    assert torch.equal(flat["a/b"], torch.ones(2))
