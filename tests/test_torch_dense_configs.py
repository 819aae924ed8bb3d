"""The other dense configs on the port (h2o-danube-3-4b, granite-34b,
gemma2-9b) against the reference, on the CPU: their configs and spec
hashes, the layers they add (soft caps, banded chunked attention, the
ring-buffer decode cache and the windowed prefill's rolled cache), the
model (training loss, a 3-step Session trajectory, prefill and decode past
the window, cache bytes), gemma's embedding scale and the prefill's route
to K7.

Inputs are made with numpy from a seed, weights come from the reference's
``init_params`` (checkpoint/bridge.py) or its Session's npz. Tolerances:
f32 within 1e-5 where only the order of the sums differs; bf16 within 2e-2
of each row's largest magnitude (the serving tolerances of
tests/test_torch_serve.py); the 3-step trajectories within rtol 1e-4
(tests/test_torch_train.py). Sequences are longer than the smoke window
(128), so the banded masks and the ring cache are exercised.
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
from repro.launch import session as jax_session
from repro.launch import spec as jax_spec
from repro.models import layers as jax_layers
from repro.models import model as jax_model
from repro_torch.checkpoint import bridge
from repro_torch.configs import base as pt_cb
from repro_torch.kernels import ops
from repro_torch.launch import session as pt_session
from repro_torch.launch import spec as pt_spec
from repro_torch.models import layers
from repro_torch.models import model as pt_model
from test_torch_schedule import one_torch_thread  # noqa: F401 (autouse)

ROOT = os.path.join(os.path.dirname(__file__), "..")
ARCHS = ["h2o-danube-3-4b", "granite-34b", "gemma2-9b"]
TOL = {"float32": 1e-5, "bfloat16": 2e-2}
SEQ = 160                       # above the smoke window of 128
# fused_quickstart.json at smoke size, 4 clients: the reference's compile
# dominates the cost of a trajectory, and fewer clients shorten it
TRAIN = {"smoke": True, "seq_len": SEQ, "global_batch": 8, "clients": 4,
         "carrier": "fused_quant8", "downlink_carrier": "fused_quant4"}


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(jnp.asarray(x, jnp.float32))


def _close(got, want, tol, msg="", rowwise=False):
    """Within tol (atol and rtol); ``rowwise``: atol tol * max|want| of
    each row (the last axis)."""
    got, want = _np(got), _np(want)
    atol = tol * np.abs(want).max(-1, keepdims=True) if rowwise else tol
    bad = np.abs(got - want) > atol + tol * np.abs(want)
    assert got.shape == want.shape and not bad.any(), (
        f"{msg}: {int(bad.sum())} of {bad.size} outside tol {tol}; max abs "
        f"diff {np.abs(got - want).max()}")


def _configs(arch, dtype="float32"):
    return (dataclasses.replace(jax_cb.get_smoke(arch), dtype=dtype),
            dataclasses.replace(pt_cb.get_smoke(arch), dtype=dtype))


def _shipped(name="fused_quickstart", **overrides):
    with open(os.path.join(ROOT, "results", "specs", f"{name}.json")) as f:
        return dict(json.load(f), **overrides)


# ---------------------------------------------------------------------------
# configs and specs
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ["smollm-360m"] + ARCHS)
def test_configs_equal_the_reference_field_for_field(arch):
    for get in ("get", "get_smoke"):
        got = getattr(pt_cb, get)(arch)
        want = getattr(jax_cb, get)(arch)
        for f in dataclasses.fields(got):
            assert getattr(got, f.name) == getattr(want, f.name), (get,
                                                                   f.name)
        assert got.head_dim_ == want.head_dim_


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("smoke", [True, False])
def test_spec_takes_the_arch_with_the_reference_hash(arch, smoke):
    d = _shipped(arch=arch, smoke=smoke)
    spec = pt_spec.RunSpec.from_dict(d)
    assert spec.spec_hash() == jax_spec.RunSpec.from_dict(d).spec_hash()
    assert pt_spec.RunSpec.from_json(spec.to_json()) == spec


def test_dryrun_sparse_pod_is_refused_for_mesh_and_shape_only():
    """gemma2-9b, the pod mesh and the input shape, the two things the
    shipped dry-run spec was refused for, are ported: it loads with the
    reference's hash, as do its smoke-size and smoke-mesh variants. (A
    world whose pod mesh has a 'model' axis above 1 splits gemma2 over it:
    tests/test_torch_tensor_parallel.py.)"""
    d = _shipped("dryrun_sparse_pod")
    assert d["arch"] == "gemma2-9b"
    assert (d["mesh"], d["shape"]) == ("pod", "train_4k")
    for ok in (d, dict(d, mesh="smoke", shape=None), dict(d, smoke=True)):
        assert pt_spec.RunSpec.from_dict(ok).spec_hash() == \
            jax_spec.RunSpec.from_dict(ok).spec_hash()


def test_archs_not_yet_ported_still_raise():
    """Every arch of the reference is ported; an id the registry does not
    know still raises, naming the archs it has."""
    with pytest.raises(NotImplementedError, match="unknown arch") as err:
        pt_cb.get("falcon-mamba-70b")
    assert "falcon-mamba-7b" in str(err.value)
    assert sorted(pt_cb.ARCH_ALIASES) == sorted(jax_cb.ARCH_ALIASES)


# ---------------------------------------------------------------------------
# layers
# ---------------------------------------------------------------------------

def _qkv(B, S, H, KV, hd, seed, dtype):
    rng = np.random.RandomState(seed)
    q = rng.randn(B, S, H, hd).astype(np.float32)
    k, v = (rng.randn(B, S, KV, hd).astype(np.float32) for _ in range(2))
    if dtype == "bfloat16":       # both packages start from the same bf16
        q, k, v = (np.asarray(jnp.asarray(x, jnp.bfloat16), np.float32)
                   for x in (q, k, v))
    return q, k, v


def _both(x, dtype):
    return (torch.tensor(x).to(getattr(torch, dtype)),
            jnp.asarray(x, getattr(jnp, dtype)))


def test_softcap_matches_reference():
    x = np.random.RandomState(0).randn(64, 33).astype(np.float32) * 80
    for cap in (None, 30.0, 50.0):
        _close(layers.softcap(torch.tensor(x), cap),
               jax_layers.softcap(jnp.asarray(x), cap), 1e-5, str(cap))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("window,cap", [(128, None), (128, 50.0),
                                        (None, 50.0), (40, 5.0)])
def test_chunked_attention_banded_and_capped(dtype, window, cap):
    """S 300 (not a multiple of the chunk 64), GQA 2: the banded schedule's
    slices and masks, and the soft cap before the mask."""
    q, k, v = _qkv(2, 300, 4, 2, 32, seed=300 + (window or 0), dtype=dtype)
    (tq, jq), (tk, jk), (tv, jv) = (_both(x, dtype) for x in (q, k, v))
    got = layers.chunked_attention(tq, tk, tv, chunk=64, window=window,
                                   cap=cap)
    want = jax_layers.chunked_attention(jq, jk, jv, chunk=64, window=window,
                                        cap=cap)
    _close(got, want, TOL[dtype], rowwise=dtype == "bfloat16")


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("S,pos,cap", [(16, 9, None), (16, 16, 50.0),
                                       (16, 40, None), (33, 70, 5.0)])
def test_decode_attention_on_a_ring(dtype, S, pos, cap):
    """A windowed cache of S slots: before it fills, slots <= pos; once
    pos >= S, every slot (the ring holds the last S positions)."""
    B, H, KV, hd = 2, 4, 2, 64
    rng = np.random.RandomState(S + pos)
    q = rng.randn(B, 1, H, hd).astype(np.float32)
    kc, vc = (rng.randn(B, S, KV, hd).astype(np.float32) for _ in range(2))
    (tq, jq), (tk, jk), (tv, jv) = (_both(x, dtype) for x in (q, kc, vc))
    got = layers.decode_attention(tq, tk, tv, pos, window=S, cap=cap)
    want = jax_layers.decode_attention(jq, jk, jv, jnp.asarray(pos),
                                       window=S, cap=cap)
    _close(got, want, TOL[dtype], rowwise=dtype == "bfloat16")


@pytest.mark.parametrize("S,slots", [(150, 128), (256, 128), (100, 128)])
def test_windowed_prefill_writes_the_rolled_tail(S, slots):
    """attn_apply's prefill into a windowed cache of ``slots``: a prompt
    longer than the ring keeps its last ``slots`` keys, rolled by
    S % slots (position p at slot p % slots), in place; a shorter one
    fills slots [0, S). f32 caches within 1e-5 of the reference's."""
    cfg = dataclasses.replace(pt_cb.get_smoke("h2o-danube-3-4b"),
                              dtype="float32")
    jcfg = dataclasses.replace(jax_cb.get_smoke("h2o-danube-3-4b"),
                               dtype="float32")
    jp = jax_model.init_params(jcfg, jax.random.PRNGKey(0))
    attn = jax.tree_util.tree_map(lambda t: t[0], jp["layers"]["attn"])
    pattn = {k: torch.tensor(np.asarray(v)) for k, v in attn.items()}
    x = np.random.RandomState(S).randn(2, S, cfg.d_model).astype(np.float32)
    hd, KV = cfg.head_dim_, cfg.num_kv_heads
    cache = tuple(torch.full((2, slots, KV, hd), 7.0) for _ in range(2))
    positions = torch.arange(S)[None].expand(2, S)
    cs = layers.rope_at(positions, hd, cfg.rope_theta, S)
    got = layers.attn_apply(pattn, torch.tensor(x), cs, eps=cfg.norm_eps,
                            chunk=cfg.attn_chunk, window=slots, cache=cache)
    jcache = tuple(jnp.full((2, slots, KV, hd), 7.0) for _ in range(2))
    want, jnew = jax_layers.attn_apply(
        attn, jnp.asarray(x), jnp.asarray(positions.numpy()),
        rope_theta=cfg.rope_theta, eps=cfg.norm_eps, chunk=cfg.attn_chunk,
        window=slots, cache=jcache)
    _close(got, want, 1e-5, "delta")
    for name, c, w in zip("kv", cache, jnew):
        _close(c, w, 1e-5, f"cache {name}")


# ---------------------------------------------------------------------------
# the model
# ---------------------------------------------------------------------------

def _params(jcfg, seed=0):
    jparams = jax_model.init_params(jcfg, jax.random.PRNGKey(seed))
    return jparams, bridge.params_from_jax(jax.device_get(jparams))


@pytest.mark.parametrize("arch", ARCHS)
def test_train_loss_matches_reference(arch):
    jcfg, pcfg = _configs(arch)
    jparams, pparams = _params(jcfg)
    rng = np.random.RandomState(1)
    tokens = rng.randint(0, jcfg.vocab_size, (2, SEQ)).astype(np.int32)
    labels = rng.randint(0, jcfg.vocab_size, (2, SEQ)).astype(np.int32)
    want, _ = jax_model.train_loss(jcfg, jparams, {
        "tokens": jnp.asarray(tokens), "labels": jnp.asarray(labels)})
    got, _ = pt_model.train_loss(pcfg, pparams, {
        "tokens": torch.tensor(tokens), "labels": torch.tensor(labels)})
    np.testing.assert_allclose(float(got), float(want), rtol=1e-5)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_and_decode_past_the_window(arch, dtype):
    """A 150-token prompt into a cache of 153 positions (a ring of 128
    under the smoke window: the prefill wraps it), then 3 decode steps."""
    jcfg, pcfg = _configs(arch, dtype)
    jparams, pparams = _params(jcfg)
    B, S, steps = 2, 150, 3
    tokens = np.random.RandomState(2).randint(
        0, jcfg.vocab_size, (B, S + steps)).astype(np.int32)
    f32 = dtype == "float32"
    jcache = jax_model.init_cache(jcfg, B, S + steps,
                                  dtype=jnp.float32 if f32 else jnp.bfloat16)
    pcache = pt_model.init_cache(pcfg, B, S + steps,
                                 dtype=torch.float32 if f32 else
                                 torch.bfloat16)
    assert sorted(pcache) == sorted(jcache)
    for k in pcache:
        assert tuple(pcache[k].shape) == jcache[k].shape, k
    jpre = jax.jit(lambda p, b, c: jax_model.prefill(jcfg, p, b, c))
    jdec = jax.jit(lambda p, c, t, q: jax_model.decode_step(jcfg, p, c, t, q))
    tol = TOL[dtype]
    want, jcache = jpre(jparams, {"tokens": jnp.asarray(tokens[:, :S])},
                        jcache)
    got, pcache = pt_model.prefill(pcfg, pparams,
                                   {"tokens": torch.tensor(tokens[:, :S])},
                                   pcache)
    _close(got, want, tol, "prefill logits", rowwise=not f32)
    for i in range(steps):
        t = tokens[:, S + i:S + i + 1]
        want, jcache = jdec(jparams, jcache, jnp.asarray(t),
                            jnp.asarray(S + i, jnp.int32))
        got, pcache = pt_model.decode_step(pcfg, pparams, pcache,
                                           torch.tensor(t), S + i)
        _close(got, want, tol, f"decode step {i} logits", rowwise=not f32)
    if f32:
        for k in pcache:
            _close(pcache[k], jcache[k], tol, f"cache {k}")


@pytest.mark.parametrize("arch", ARCHS)
def test_session_cache_bytes_equal_the_reference(arch):
    """Session.serve's cache_bytes are the bytes of the reference's
    init_cache for the same prompt and decode budget."""
    B, S, steps = 2, 140, 4
    spec = pt_spec.RunSpec(arch=arch, smoke=True, seq_len=32, clients=2,
                           global_batch=4)
    sess = pt_session.Session(spec, device="cpu")
    out = sess.serve(batch=B, prompt_len=S, decode_steps=steps)
    want = jax_model.init_cache(jax_cb.get_smoke(arch), B, S + steps)
    assert out["cache_bytes"] == sum(
        x.size * x.dtype.itemsize for x in jax.tree_util.tree_leaves(want))
    assert out["tokens"].shape == (B, steps + 1)


@pytest.fixture(scope="module")
def reference_runs(tmp_path_factory):
    """Per arch, once for the module: the reference Session's initial state
    as npz and its 3-step trajectory on fused_quant8/fused_quant4 in f32."""
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


def test_gemma_embedding_scale_is_rounded_to_the_activation_dtype():
    """At gemma2-9b's d_model 3584, sqrt(d) is 59.866 but 59.75 in bf16:
    the port's bf16 embeddings equal the reference's bit for bit, and an
    unrounded scale would give others."""
    jcfg = dataclasses.replace(jax_cb.get("gemma2-9b"), vocab_size=64)
    pcfg = dataclasses.replace(pt_cb.get("gemma2-9b"), vocab_size=64)
    embed = np.random.RandomState(3).randn(64, 3584).astype(np.float32)
    tokens = np.arange(64, dtype=np.int32).reshape(2, 32)
    want, _ = jax_model._embed(jcfg, {"embed": jnp.asarray(embed)},
                               jnp.asarray(tokens), None)
    got, _ = pt_model._embed(pcfg, {"embed": torch.tensor(embed)},
                          torch.tensor(tokens))
    assert got.dtype == torch.bfloat16
    np.testing.assert_array_equal(_np(got), _np(want))
    unrounded = torch.tensor(embed)[torch.tensor(tokens).long()].to(
        torch.bfloat16) * pcfg.d_model ** 0.5
    assert not torch.equal(unrounded, got)


@pytest.mark.parametrize("arch,overrides,want", [
    ("granite-34b", {}, 2),                        # hd 64, no window or cap
    ("granite-34b", {"head_dim": 120}, 0),         # danube's head dim
    ("h2o-danube-3-4b", {}, 0),                    # a window on every layer
    ("gemma2-9b", {}, 0),                          # windows and a cap
    ("gemma2-9b", {"logit_softcap": None}, 1),     # the global layer
])
def test_prefill_routes_only_plain_layers_to_flash(monkeypatch, arch,
                                                   overrides, want):
    """K7 runs a layer's prefill only with no window, no soft cap and a
    head dim it is built for; every other layer runs chunked attention.
    ``model.flash_layers`` states the count."""
    cfg = dataclasses.replace(pt_cb.get_smoke(arch), dtype="float32",
                              **overrides)
    calls = []

    def counted(*a, _fn=ops.flash_attention, **kw):
        calls.append(a[0].shape)
        return _fn(*a, **kw)
    monkeypatch.setattr(ops, "flash_attention", counted)
    params = pt_model.init_params(cfg, torch.Generator().manual_seed(0))
    tokens = torch.randint(0, cfg.vocab_size, (2, 40),
                           generator=torch.Generator().manual_seed(0))
    cache = pt_model.init_cache(cfg, 2, 44, dtype=torch.float32)
    pt_model.prefill(cfg, params, {"tokens": tokens}, cache)
    assert len(calls) == want == pt_model.flash_layers(cfg)
