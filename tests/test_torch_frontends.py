"""The modality frontends on the port (musicgen-medium's audio stub and
internvl2-76b's vision stub) against the reference, on the CPU: the prefix
count and the zero ``prefix_embeds`` stub at both paddings, the projected
prefix before the tokens, the training loss on the token positions only,
prefill and decode after the prefix (with per-row prompt lengths), cache
bytes at the card phases' shapes, spec hashes, 3-step Session
trajectories, and the exactly zero gradient a zero prefix gives
``frontend_proj``.

Inputs are made with numpy from a seed, weights come from the reference's
``init_params`` (checkpoint/bridge.py) or its Session's npz. Tolerances:
f32 within 1e-5; bf16 within 2e-2 of each row's largest magnitude (the
serving tolerances of tests/test_torch_serve.py); the 3-step trajectories
within rtol 1e-4 (tests/test_torch_train.py).
"""
import dataclasses
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import base as jax_cb
from repro.data import pipeline as jax_pipe
from repro.launch import session as jax_session
from repro.launch import spec as jax_spec
from repro.models import model as jax_model
from repro_torch.checkpoint import bridge
from repro_torch.configs import base as pt_cb
from repro_torch.core import distributed as dist
from repro_torch.core.ef import flatten
from repro_torch.data import pipeline as pipe
from repro_torch.launch import build as pt_build
from repro_torch.launch import session as pt_session
from repro_torch.launch import spec as pt_spec
from repro_torch.models import model as pt_model
from test_torch_schedule import one_torch_thread  # noqa: F401 (autouse)

ROOT = os.path.join(os.path.dirname(__file__), "..")
ARCHS = ["musicgen-medium", "internvl2-76b"]
TOL = {"float32": 1e-5, "bfloat16": 2e-2}
TRAIN = {"smoke": True, "seq_len": 32, "global_batch": 8, "clients": 4,
         "carrier": "fused_quant8", "downlink_carrier": "fused_quant4"}


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(jnp.asarray(x, jnp.float32))


def _close(got, want, tol, msg="", rowwise=False):
    got, want = _np(got), _np(want)
    atol = tol * np.abs(want).max(-1, keepdims=True) if rowwise else tol
    bad = np.abs(got - want) > atol + tol * np.abs(want)
    assert got.shape == want.shape and not bad.any(), (
        f"{msg}: {int(bad.sum())} of {bad.size} outside tol {tol}; max abs "
        f"diff {np.abs(got - want).max()}")


def _configs(arch, dtype="float32", **kw):
    return (dataclasses.replace(jax_cb.get_smoke(arch), dtype=dtype, **kw),
            dataclasses.replace(pt_cb.get_smoke(arch), dtype=dtype, **kw))


def _params(jcfg, seed=0):
    jparams = jax_model.init_params(jcfg, jax.random.PRNGKey(seed))
    return jparams, bridge.params_from_jax(jax.device_get(jparams))


def _shipped(name="fused_quickstart", **overrides):
    with open(os.path.join(ROOT, "results", "specs", f"{name}.json")) as f:
        return dict(json.load(f), **overrides)


# ---------------------------------------------------------------------------
# the prefix
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", sorted(pt_cb.ARCH_ALIASES))
@pytest.mark.parametrize("smoke", [True, False])
def test_prefix_count_and_stub_are_the_reference_s(arch, smoke):
    """At both paddings (the training default PREFIX_PAD_MIN 8 and
    serving's PREFIX_PAD_SPEC 64): the count, and the stub's shape, dtype
    and zeros; an arch without a frontend gets its batch back as it is."""
    get = "get_smoke" if smoke else "get"
    pcfg, jcfg = getattr(pt_cb, get)(arch), getattr(jax_cb, get)(arch)
    assert (pipe.PREFIX_PAD_MIN, pipe.PREFIX_PAD_SPEC) == \
        (jax_pipe.PREFIX_PAD_MIN, jax_pipe.PREFIX_PAD_SPEC)
    tokens = np.zeros((3, 5), np.int32)
    for pad in (None, pipe.PREFIX_PAD_MIN, pipe.PREFIX_PAD_SPEC):
        kw = {} if pad is None else {"pad_to": pad}
        n = pipe.prefix_token_count(pcfg, **kw)
        assert n == jax_pipe.prefix_token_count(jcfg, **kw)
        batch = {"tokens": torch.from_numpy(tokens)}
        got = pipe.with_prefix_embeds(pcfg, batch, **kw)
        want = jax_pipe.with_prefix_embeds(
            jcfg, {"tokens": jnp.asarray(tokens)}, **kw)
        assert sorted(got) == sorted(want)
        if n == 0:
            assert got is batch
            continue
        pe = got["prefix_embeds"]
        assert tuple(pe.shape) == want["prefix_embeds"].shape == \
            (3, n, pcfg.d_model)
        assert pe.dtype == torch.bfloat16 and not pe.any()
    if pcfg.frontend == "audio":                 # musicgen: 0 tokens, padded
        assert pipe.prefix_token_count(pcfg) == 8
        assert pipe.prefix_token_count(pcfg, pipe.PREFIX_PAD_SPEC) == 64


def test_embed_projects_the_prefix_and_scales_only_the_tokens():
    """A random prefix through frontend_proj before the tokens; under
    gemma's embedding scale (a gemma config given a frontend) the prefix
    is not scaled. Bit for bit in f32 against the reference's _embed."""
    for arch in ("internvl2-76b", "gemma2-9b"):
        jcfg, pcfg = _configs(arch, frontend="vision")
        jparams, pparams = _params(jcfg)
        rs = np.random.RandomState(4)
        tokens = rs.randint(0, jcfg.vocab_size, (2, 7)).astype(np.int32)
        pe = rs.randn(2, 5, jcfg.d_model).astype(np.float32)
        want, n = jax_model._embed(jcfg, jparams, jnp.asarray(tokens),
                                   jnp.asarray(pe))
        got, m = pt_model._embed(pcfg, pparams, torch.tensor(tokens),
                                 torch.tensor(pe))
        assert n == m == 5
        _close(got, want, 1e-6, arch)


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("pad", [pipe.PREFIX_PAD_MIN, pipe.PREFIX_PAD_SPEC])
def test_train_loss_matches_reference(arch, pad):
    """The loss over the token positions only (the prefix rows dropped
    after the final norm, the mean over B x S of the tokens)."""
    jcfg, pcfg = _configs(arch)
    jparams, pparams = _params(jcfg)
    rs = np.random.RandomState(1)
    tokens, labels = (rs.randint(0, jcfg.vocab_size, (2, 40))
                      .astype(np.int32) for _ in range(2))
    want, _ = jax_model.train_loss(jcfg, jparams, jax_pipe.with_prefix_embeds(
        jcfg, {"tokens": jnp.asarray(tokens), "labels": jnp.asarray(labels)},
        pad_to=pad))
    got, aux = pt_model.train_loss(pcfg, pparams, pipe.with_prefix_embeds(
        pcfg, {"tokens": torch.tensor(tokens),
               "labels": torch.tensor(labels)}, pad_to=pad))
    np.testing.assert_allclose(float(got), float(want), rtol=1e-5)
    assert all(float(a) == 0 for a in aux.values())


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_and_decode_after_the_prefix(arch, dtype):
    """Serving's 64-row prefix (the smoke configs' 16 vision tokens padded
    to PREFIX_PAD_SPEC), a 40-token prompt with per-row lengths (the
    logits gathered at P + len - 1), then 3 decode steps at positions past
    the prefix; the cache against the reference's in f32."""
    jcfg, pcfg = _configs(arch, dtype)
    jparams, pparams = _params(jcfg)
    pparams = pt_model.cast_matrices(pcfg, pparams)
    B, S, steps = 2, 40, 3
    pad = pipe.PREFIX_PAD_SPEC
    P = pipe.prefix_token_count(pcfg, pad)
    tokens = np.random.RandomState(2).randint(
        0, jcfg.vocab_size, (B, S + steps)).astype(np.int32)
    lens = np.array([S - 5, S], np.int32)
    f32 = dtype == "float32"
    jcache = jax_model.init_cache(jcfg, B, P + S + steps,
                                  dtype=jnp.float32 if f32 else jnp.bfloat16)
    pcache = pt_model.init_cache(pcfg, B, pt_build.cache_len(S, steps, P),
                                 dtype=torch.float32 if f32 else
                                 torch.bfloat16)
    jb = jax_pipe.with_prefix_embeds(
        jcfg, {"tokens": jnp.asarray(tokens[:, :S]),
               "prompt_lens": jnp.asarray(lens)}, pad_to=pad)
    pb = pipe.with_prefix_embeds(
        pcfg, {"tokens": torch.tensor(tokens[:, :S]),
               "prompt_lens": torch.tensor(lens)}, pad_to=pad)
    want, jcache = jax.jit(lambda p, b, c: jax_model.prefill(jcfg, p, b, c))(
        jparams, jb, jcache)
    got, pcache = pt_model.prefill(pcfg, pparams, pb, pcache)
    tol = TOL[dtype]
    _close(got, want, tol, "prefill logits", rowwise=not f32)
    jdec = jax.jit(lambda p, c, t, q: jax_model.decode_step(jcfg, p, c, t, q))
    for i in range(steps):
        t = tokens[:, S + i:S + i + 1]
        want, jcache = jdec(jparams, jcache, jnp.asarray(t),
                            jnp.asarray(P + S + i, jnp.int32))
        got, pcache = pt_model.decode_step(pcfg, pparams, pcache,
                                           torch.tensor(t), P + S + i)
        _close(got, want, tol, f"decode step {i}", rowwise=not f32)
    if f32:
        for k in pcache:
            _close(pcache[k], jcache[k], tol, f"cache {k}")


@pytest.mark.parametrize("arch,layers,B,S,steps,want", [
    ("musicgen-medium", 12, 8, 1024, 32, 660_602_880),   # phase D-musicgen
    ("internvl2-76b", 1, 8, 1024, 32, 42_991_616),       # phase D-internvl2
    ("musicgen-medium", 2, 2, 40, 3, None)])
def test_cache_bytes_equal_the_reference(arch, layers, B, S, steps, want):
    """A serve's cache (the PREFIX_PAD_SPEC prefix, the prompt and the
    decode budget) against the reference's init_cache under
    jax.eval_shape, at the card phases' full-width shapes."""
    jcfg = dataclasses.replace(jax_cb.get(arch), num_layers=layers)
    pcfg = dataclasses.replace(pt_cb.get(arch), num_layers=layers)
    P = pipe.prefix_token_count(pcfg, pipe.PREFIX_PAD_SPEC)
    ref = jax.eval_shape(lambda: jax_model.init_cache(jcfg, B,
                                                      P + S + steps))
    ref_bytes = sum(x.size * x.dtype.itemsize
                    for x in jax.tree_util.tree_leaves(ref))
    cache = pt_model.init_cache(pcfg, B, pt_build.cache_len(S, steps, P),
                                device="meta")
    got = sum(t.numel() * t.element_size() for t in cache.values())
    assert got == ref_bytes
    assert want is None or got == want


def test_session_serve_takes_the_prefix():
    """Session.serve at smoke size: the cache holds the 64-row prefix, and
    the first token is the argmax of a prefill with the same prefix."""
    spec = pt_spec.RunSpec(arch="internvl2-76b", smoke=True, seq_len=32,
                           clients=2, global_batch=4)
    sess = pt_session.Session(spec, device="cpu", dtype="float32")
    tokens = torch.randint(0, sess.cfg.vocab_size, (2, 24),
                           generator=torch.Generator().manual_seed(0))
    out = sess.serve(tokens=tokens, decode_steps=3)
    want = jax_model.init_cache(jax_cb.get_smoke("internvl2-76b"), 2,
                                64 + 24 + 3)
    assert out["cache_bytes"] == sum(
        x.size * x.dtype.itemsize for x in jax.tree_util.tree_leaves(want))
    cache = pt_model.init_cache(sess.cfg, 2, 64 + 24, dtype=torch.float32)
    logits, _ = pt_model.prefill(
        sess.cfg, sess.serving_params(), pipe.with_prefix_embeds(
            sess.cfg, {"tokens": tokens}, pad_to=64), cache)
    np.testing.assert_array_equal(out["tokens"][:, 0],
                                  logits[:, -1].argmax(-1).numpy())


# ---------------------------------------------------------------------------
# specs and Sessions
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("smoke", [True, False])
def test_spec_hash_is_the_reference_s(arch, smoke):
    d = _shipped(arch=arch, smoke=smoke)
    spec = pt_spec.RunSpec.from_dict(d)
    assert spec.spec_hash() == jax_spec.RunSpec.from_dict(d).spec_hash()
    assert pt_spec.RunSpec.from_json(spec.to_json()) == spec


def test_frontend_proj_takes_an_exactly_zero_gradient():
    """A zero prefix gives frontend_proj a zero gradient on every client,
    so over Session steps on the fused wire its params and its EF state
    stay bit for bit what they were (chip_smoke.py's D-musicgen holds the
    same at full width)."""
    cfg = dataclasses.replace(pt_cb.get_smoke("musicgen-medium"),
                              dtype="float32")
    params = pt_model.init_params(cfg, torch.Generator().manual_seed(0))
    rs = np.random.RandomState(0)
    batch = pipe.with_prefix_embeds(cfg, {
        n: torch.from_numpy(rs.randint(0, cfg.vocab_size, (4, 16))
                            .astype(np.int32)) for n in ("tokens", "labels")})
    _, _, grads = dist.per_client_value_and_grad(
        lambda p, b: pt_model.train_loss(cfg, p, b), params, batch, 2)
    assert not grads["frontend_proj"].any()
    assert grads["embed"].any()
    sess = pt_session.Session(pt_spec.RunSpec.from_dict(
        _shipped(arch="musicgen-medium", **TRAIN)), device="cpu")
    before = {k: t.clone() for k, t in flatten(
        {"params": sess.params, "ef_state": sess.ef_state}).items()
        if "frontend_proj" in k}
    assert len(before) >= 4                 # params, v, g, server g, h
    sess.train(2, log_every=0)
    after = flatten({"params": sess.params, "ef_state": sess.ef_state})
    for k, t in before.items():
        assert torch.equal(after[k], t), k


@pytest.fixture(scope="module")
def reference_runs(tmp_path_factory):
    """Per arch, once for the module: the reference Session's initial state
    as npz and its 3-step trajectory in f32."""
    runs = {}

    def run(arch):
        if arch not in runs:
            d = _shipped(arch=arch, **TRAIN)
            jsess = jax_session.Session(jax_spec.RunSpec.from_dict(d))
            jsess.cfg = dataclasses.replace(jsess.cfg, dtype="float32")
            path = str(tmp_path_factory.mktemp(arch) / "step_0.npz")
            ckpt = jsess.save(path)
            runs[arch] = (d, ckpt, jsess.train(3, log_every=1))
        return runs[arch]
    return run


@pytest.mark.parametrize("arch", ARCHS)
def test_three_session_steps_match_reference(arch, reference_runs):
    d, ckpt, want = reference_runs(arch)
    psess = pt_session.Session(pt_spec.RunSpec.from_dict(d), device="cpu",
                               dtype="float32")
    psess.restore_from(ckpt)
    got = psess.train(3, log_every=1)
    assert [r["step"] for r in got] == [0, 1, 2]
    for key in ("loss", "g_norm"):
        np.testing.assert_allclose([r[key] for r in got],
                                   [r[key] for r in want], rtol=1e-4,
                                   err_msg=key)
    assert np.isfinite(psess.evaluate(1))
