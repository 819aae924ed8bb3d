"""Block recompute (models/remat.py) on the CPU: with ``cfg.remat`` the
clients' one batched pass (``per_client_value_and_grad``: vmap of
grad_and_value) gives the gradients and losses of the pass without it, bit
for bit, and so does the EF state of whole Session steps; the pass keeps
far fewer bytes alive at its peak; and 3 Session steps with
``remat=True`` on both packages track the reference within rtol 1e-4
(tests/test_torch_train.py's tolerance).
"""
import dataclasses
import json
import os
import weakref

import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten

from repro.launch import session as jax_session
from repro.launch import spec as jax_spec
from repro_torch.configs import base as pt_cb
from repro_torch.core import distributed as dist
from repro_torch.core import ef as pt_ef
from repro_torch.data import pipeline as pipe_lib
from repro_torch.launch import session as pt_session
from repro_torch.launch import spec as pt_spec
from repro_torch.models import model as pt_model
from repro_torch.models import remat
from test_torch_schedule import one_torch_thread  # noqa: F401 (autouse)

ROOT = os.path.join(os.path.dirname(__file__), "..")
ARCHS = ["smollm-360m", "h2o-danube-3-4b", "gemma2-9b"]


def _cfg(arch, remat_on, dtype="float32"):
    return dataclasses.replace(pt_cb.get_smoke(arch), remat=remat_on,
                               dtype=dtype)


def _batch(cfg, S=160, B=4):
    return pipe_lib.SyntheticTokens(pipe_lib.DataConfig(
        vocab_size=cfg.vocab_size, seq_len=S, global_batch=B,
        dp_groups=2)).batch(0)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", ARCHS)
def test_client_pass_is_bit_identical_with_recompute(arch, dtype):
    """The real client pass, 2 clients, a sequence past the smoke window:
    gradients of every leaf and the mean loss, torch.equal."""
    out = {}
    for on in (False, True):
        cfg = _cfg(arch, on, dtype)
        params = pt_model.init_params(cfg, torch.Generator().manual_seed(0))
        out[on] = dist.per_client_value_and_grad(
            lambda p, b, cfg=cfg: pt_model.train_loss(cfg, p, b), params,
            _batch(cfg), 2)
    assert torch.equal(out[True][0], out[False][0])
    for k, g in out[False][2].items():
        assert torch.equal(out[True][2][k], g), k


def test_session_steps_are_bit_identical_with_recompute():
    """Two fused_quant8/fused_quant4 steps of gemma2-9b's smoke config:
    params, optimizer state and every EF state leaf equal bit for bit."""
    with open(os.path.join(ROOT, "results", "specs",
                           "fused_quickstart.json")) as f:
        d = dict(json.load(f), arch="gemma2-9b", smoke=True, seq_len=160,
                 global_batch=8, clients=4, carrier="fused_quant8",
                 downlink_carrier="fused_quant4")
    flat = {}
    for on in (False, True):
        sess = pt_session.Session(pt_spec.RunSpec.from_dict(d), device="cpu")
        sess.cfg = dataclasses.replace(sess.cfg, remat=on)
        sess.train(2, log_every=0)
        flat[on] = pt_ef.flatten({"params": sess.params,
                                  "opt_state": sess.opt_state,
                                  "ef_state": sess.ef_state})
    assert sorted(flat[True]) == sorted(flat[False])
    for k, t in flat[False].items():
        assert torch.equal(flat[True][k], t), k


class _LiveBytes(TorchDispatchMode):
    """The peak of the bytes held by the storages that operations create,
    each counted from the op that made it until it is freed: what the
    client pass keeps alive, under torch.func, on the CPU."""

    def __init__(self):
        super().__init__()
        self.live, self.now, self.peak = {}, 0, 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        for t in tree_flatten(out)[0]:
            if not isinstance(t, torch.Tensor):
                continue
            st = t.untyped_storage()
            key = st.data_ptr()
            if key in self.live or not st.nbytes():
                continue
            self.live[key] = st.nbytes()
            self.now += st.nbytes()
            self.peak = max(self.peak, self.now)
            weakref.finalize(st, self._free, key)
        return out

    def _free(self, key):
        self.now -= self.live.pop(key, 0)


@pytest.mark.parametrize("arch,vocab", [("smollm-360m", None),
                                        ("gemma2-9b", 8192)])
def test_client_pass_peak_falls_with_recompute(arch, vocab):
    """torch.func.grad keeps every saved tensor and every intermediate of
    the backward until the pass returns; the recomputed blocks (8 layers)
    and cross-entropy chunk must not be kept so. The live bytes' peak of
    the client pass (4 clients) falls by more than half with recompute
    (to 0.21 of it for smollm-360m, 0.25 for gemma2-9b at a vocabulary of
    8192, where the soft-capped f32 logits weigh most, when written)."""
    peak = {}
    for on in (False, True):
        cfg = dataclasses.replace(_cfg(arch, on), num_layers=8,
                                  vocab_size=vocab or 256)
        params = pt_model.init_params(cfg, torch.Generator().manual_seed(0))
        batch = _batch(cfg, S=128, B=8)
        with _LiveBytes() as mode:
            dist.per_client_value_and_grad(
                lambda p, b, cfg=cfg: pt_model.train_loss(cfg, p, b),
                params, batch, 4)
        peak[on] = mode.peak
    assert peak[True] < 0.5 * peak[False], peak


def test_checkpoint_takes_no_gradient_for_its_constants():
    a = torch.randn(3, requires_grad=True)
    c = torch.randn(3, requires_grad=True)
    y = remat.checkpoint(lambda a, c: (a * c).sin(), (a,), (c,))
    y.sum().backward()
    assert c.grad is None
    torch.testing.assert_close(a.grad, c * (a * c).cos(), rtol=0, atol=0)


def test_three_session_steps_with_recompute_match_reference(tmp_path):
    """remat=True on both packages' gemma2-9b smoke config (the reference
    checkpoints each [local, global] super-layer, the port recomputes
    it): 3 fused_quant8/fused_quant4 steps from the reference's npz, loss
    and g_norm within rtol 1e-4."""
    with open(os.path.join(ROOT, "results", "specs",
                           "fused_quickstart.json")) as f:
        d = dict(json.load(f), arch="gemma2-9b", smoke=True, seq_len=160,
                 global_batch=8, clients=4, carrier="fused_quant8",
                 downlink_carrier="fused_quant4")
    jsess = jax_session.Session(jax_spec.RunSpec.from_dict(d))
    jsess.cfg = dataclasses.replace(jsess.cfg, dtype="float32", remat=True)
    ckpt = jsess.save(str(tmp_path / "step_0.npz"))
    want = jsess.train(3, log_every=1)

    psess = pt_session.Session(pt_spec.RunSpec.from_dict(d), device="cpu",
                               dtype="float32")
    psess.cfg = dataclasses.replace(psess.cfg, remat=True)
    psess.restore_from(ckpt)
    got = psess.train(3, log_every=1)
    for key in ("loss", "g_norm"):
        np.testing.assert_allclose([r[key] for r in got],
                                   [r[key] for r in want], rtol=1e-4,
                                   err_msg=key)
