"""The SSM families on the port (models/ssm.py: falcon-mamba-7b's Mamba1,
zamba2-1.2b's Mamba2 with its shared attention block) against the
reference, on the CPU: the associative scan against
``jax.lax.associative_scan``, the causal conv, both mixers over several
chunks and in one-token decode, each mixer's chunked pass against its own
token-by-token decode, the archs' training loss and gradients (zamba2 with
a tail layer too), block recompute and the client vmap, prefill and
decode with right-padded prompts, the parameter tree, the serving cast,
cache bytes at the card phases' shapes, spec hashes, 3-step Session
trajectories, a checkpoint and a replica over the wire stream.

Inputs are made with numpy from a seed and weights come from the
reference's ``init_params`` (checkpoint/bridge.py) or its Session's npz.
Tolerances: f32 within 1e-5 of each row's (or leaf's) largest magnitude
(the order of sums and XLA's fused multiply-adds differ); bf16 within
2e-2 of each row's largest magnitude (tests/test_torch_serve.py's
serving tolerance); the 3-step trajectories within rtol 1e-4
(tests/test_torch_train.py); recompute and the client vmap against their
plain counterparts bit for bit and within 1e-5.
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
from repro.models import model as jax_model
from repro.models import ssm as jax_ssm
from repro_torch.checkpoint import bridge
from repro_torch.configs import base as pt_cb
from repro_torch.core import distributed as dist
from repro_torch.core.ef import flatten
from repro_torch.kernels import ops
from repro_torch.launch import build as pt_build
from repro_torch.launch import session as pt_session
from repro_torch.launch import spec as pt_spec
from repro_torch.models import model as pt_model
from repro_torch.models import ssm
from test_torch_schedule import one_torch_thread  # noqa: F401 (autouse)

ROOT = os.path.join(os.path.dirname(__file__), "..")
ARCHS = ["falcon-mamba-7b", "zamba2-1.2b"]
VARIANT = {"mamba1": "falcon-mamba-7b", "mamba2": "zamba2-1.2b"}
TOL = {"float32": 1e-5, "bfloat16": 2e-2}
# zamba2's bf16 serving at smoke size: the reference's own bf16 prefill
# logits lie 2.6e-2 of a row's largest logit from its f32 ones (the
# port's 2.4e-2), so the two packages' bf16 logits are held within 3e-2
HYBRID_BF16_TOL = 3e-2
SEQ = 128                       # two chunks of the smoke configs' 64
# fused_quickstart.json at smoke size, 2 clients: the reference's compile
# dominates the cost of a trajectory, and fewer clients shorten it
TRAIN = {"smoke": True, "seq_len": SEQ, "global_batch": 4, "clients": 2,
         "carrier": "fused_quant8", "downlink_carrier": "fused_quant4"}


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(jnp.asarray(x, jnp.float32))


def _close(got, want, tol, msg=""):
    """Within tol of the largest magnitude of each row (the last axis)."""
    got, want = _np(got), _np(want)
    atol = tol * np.abs(want).max(-1, keepdims=True) + 1e-30
    bad = np.abs(got - want) > atol
    assert got.shape == want.shape and not bad.any(), (
        f"{msg}: {int(bad.sum())} of {bad.size} outside tol {tol}; max abs "
        f"diff {np.abs(got - want).max()}")


def _configs(arch, dtype="float32", **kw):
    return (dataclasses.replace(jax_cb.get_smoke(arch), dtype=dtype, **kw),
            dataclasses.replace(pt_cb.get_smoke(arch), dtype=dtype, **kw))


def _x(shape, seed, dtype):
    x = np.random.RandomState(seed).randn(*shape).astype(np.float32)
    if dtype == "bfloat16":         # both packages start from the same bf16
        x = np.asarray(jnp.asarray(x, jnp.bfloat16), np.float32)
    return (torch.tensor(x).to(getattr(torch, dtype)),
            jnp.asarray(x, getattr(jnp, dtype)))


def _shipped(name="fused_quickstart", **overrides):
    with open(os.path.join(ROOT, "results", "specs", f"{name}.json")) as f:
        return dict(json.load(f), **overrides)


# ---------------------------------------------------------------------------
# the associative scan and the causal conv
# ---------------------------------------------------------------------------

COMBINES = {
    # Mamba1's first-order recurrence (a, b) -> (a_l a_r, b_l a_r + b_r)
    "linear": (ssm._linear_combine,
               lambda l, r: (l[0] * r[0], l[1] * r[0] + r[1])),
    # a one-element combine that rounds: the running sum
    "sum": (lambda l, r: (l[0] + r[0],), lambda l, r: (l[0] + r[0],)),
}


@pytest.mark.parametrize("n", [1, 2, 5, 8, 13, 64])
@pytest.mark.parametrize("name", sorted(COMBINES))
def test_associative_scan_matches_jax(name, n):
    """Along axis 1 of (3, n, 4) elements, odd and even n: the running sum
    bit for bit (the same additions in the same order), the linear
    combine within 1e-6 of each output's magnitude (XLA may contract
    b_l a_r + b_r into one fused multiply-add)."""
    pt_fn, jax_fn = COMBINES[name]
    rs = np.random.RandomState(n)
    arrays = [rs.uniform(0.5, 1.0, (3, n, 4)).astype(np.float32),
              rs.randn(3, n, 4).astype(np.float32)][:2 if name == "linear"
                                                    else 1]
    got = ssm.associative_scan(pt_fn, [torch.tensor(a) for a in arrays],
                               dim=1)
    want = jax.lax.associative_scan(jax_fn, tuple(map(jnp.asarray, arrays)),
                                    axis=1)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        if name == "sum":
            np.testing.assert_array_equal(g.numpy(), np.asarray(w))
        else:
            np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-6,
                                       atol=1e-6)


def test_associative_scan_runs_under_vmap_and_grad():
    """The scan is an inclusive scan of the recurrence (a sequential loop
    within 1e-6), and runs under torch.func.vmap and grad."""
    rs = np.random.RandomState(0)
    a = torch.tensor(rs.uniform(0.5, 1.0, (2, 7, 3)).astype(np.float32))
    b = torch.tensor(rs.randn(2, 7, 3).astype(np.float32))
    _, h = ssm.associative_scan(ssm._linear_combine, (a, b), dim=1)
    state, loop = torch.zeros(2, 3), []
    for t in range(7):
        state = a[:, t] * state + b[:, t]
        loop.append(state)
    torch.testing.assert_close(h, torch.stack(loop, 1), rtol=1e-6,
                               atol=1e-6)

    def last(a, b):
        return ssm.associative_scan(ssm._linear_combine, (a, b),
                                    dim=0)[1][-1].sum()
    g = torch.func.vmap(torch.func.grad(last, argnums=1))(a, b)
    # d h_T / d b_t = prod_{s>t} a_s
    want = torch.flip(torch.cumprod(torch.flip(
        torch.cat([a[:, 1:], torch.ones(2, 1, 3)], 1), [1]), 1), [1])
    torch.testing.assert_close(g, want, rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("with_state", [False, True])
def test_causal_conv_matches_reference(dtype, with_state):
    x, jx = _x((2, 9, 6), 0, dtype)
    w, jw = _x((4, 6), 1, dtype)
    st, jst = _x((2, 3, 6), 2, dtype) if with_state else (None, None)
    y, new = ssm.causal_conv(x, w, st)
    jy, jnew = jax_ssm.causal_conv(jx, jw, jst)
    _close(y, jy, TOL[dtype], "y")
    np.testing.assert_array_equal(_np(new), _np(jnew))
    assert y.dtype == x.dtype and new.shape == (2, 3, 6)


# ---------------------------------------------------------------------------
# the mixers
# ---------------------------------------------------------------------------

def _mixer(variant, dtype, seed=0):
    """One block of the smoke config's mixer from the reference's init,
    as jax and torch trees; the configs; the two apply functions."""
    jcfg, pcfg = _configs(VARIANT[variant], dtype)
    d = jcfg.d_model
    if variant == "mamba1":
        jp = jax_ssm.mamba1_init(jax.random.PRNGKey(seed), d, jcfg.d_inner,
                                 jcfg.ssm_state, jcfg.dt_rank, jcfg.ssm_conv,
                                 jnp.float32)
        fns = ssm.mamba1_apply, jax_ssm.mamba1_apply
    else:
        jp = jax_ssm.mamba2_init(jax.random.PRNGKey(seed), d, jcfg.d_inner,
                                 jcfg.ssm_state, jcfg.ssm_head_dim,
                                 jcfg.ssm_conv, jnp.float32)
        fns = ssm.mamba2_apply, jax_ssm.mamba2_apply
    # dt around the bias of -4 is tiny: widen it so the decays matter
    jp = dict(jp, dt_bias=jnp.zeros_like(jp["dt_bias"]),
              A_log=jp["A_log"] + 0.3)
    return jp, bridge.params_from_jax(jax.device_get(jp)), jcfg, pcfg, fns


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("variant", ["mamba1", "mamba2"])
def test_mixer_matches_reference(variant, dtype):
    """A (2, 128) sequence over two chunks of 64 from zero states, then
    one decode token from the states it leaves: outputs, the f32 scan
    state (within tol of its largest magnitude) and the conv state."""
    jp, pp, jcfg, pcfg, (pt_fn, jax_fn) = _mixer(variant, dtype)
    x, jx = _x((2, SEQ + 1, jcfg.d_model), 3, dtype)
    y, (s, c) = pt_fn(pp, x[:, :SEQ], pcfg)
    jy, (js, jc) = jax.jit(lambda p, x: jax_fn(p, x, jcfg))(jp, jx[:, :SEQ])
    _close(y, jy, TOL[dtype], "chunked y")
    # the state sums over the sequence: held to its largest magnitude
    _close(s.reshape(-1), js.reshape(-1), TOL[dtype], "ssm state")
    _close(c, jc, TOL[dtype], "conv state")
    assert s.dtype == torch.float32 and y.dtype == x.dtype
    y1, (s1, _) = pt_fn(pp, x[:, SEQ:], pcfg, ssm_state=s, conv_state=c)
    jy1, (js1, _) = jax.jit(lambda p, x, s, c: jax_fn(
        p, x, jcfg, ssm_state=s, conv_state=c))(jp, jx[:, SEQ:], js, jc)
    _close(y1, jy1, TOL[dtype], "decode y")
    _close(s1.reshape(-1), js1.reshape(-1), TOL[dtype], "decode state")


@pytest.mark.parametrize("variant", ["mamba1", "mamba2"])
def test_chunked_pass_equals_token_by_token_decode(variant):
    """The port's chunked pass over 128 tokens (two chunks) against its
    own decode recurrence run one token at a time from zero states, f32:
    every output and the final states within 1e-5 (tests/test_models.py
    holds the reference so)."""
    _, pp, _, pcfg, (pt_fn, _) = _mixer(variant, "float32", seed=1)
    x, _ = _x((2, SEQ, pcfg.d_model), 4, "float32")
    y, (s, c) = pt_fn(pp, x, pcfg)
    cache = pt_model.init_cache(dataclasses.replace(pcfg, num_layers=1), 2,
                                1, dtype=torch.float32)
    st, cv, ys = cache["ssm"][0], cache["conv"][0], []
    for t in range(SEQ):
        yt, (st, cv) = pt_fn(pp, x[:, t:t + 1], pcfg, ssm_state=st,
                             conv_state=cv)
        ys.append(yt)
    _close(torch.cat(ys, 1), y, 1e-5, "token by token")
    _close(st, s, 1e-5, "ssm state")
    _close(cv, c, 1e-5, "conv state")


@pytest.mark.parametrize("variant", ["mamba1", "mamba2"])
def test_a_sequence_off_the_chunk_is_refused(variant):
    """160 tokens on the smoke chunk of 64: the reference asserts the
    chunk divides the sequence; the port raises a ValueError naming both."""
    _, pp, _, pcfg, (pt_fn, _) = _mixer(variant, "float32")
    x, _ = _x((1, 160, pcfg.d_model), 5, "float32")
    with pytest.raises(ValueError, match="sequence 160 .* chunk 64"):
        pt_fn(pp, x, pcfg)


def test_softplus_is_logaddexp_past_the_threshold():
    """logaddexp(x, 0) at x above F.softplus's threshold of 20, where
    F.softplus returns x itself: the reference's value there."""
    x = torch.tensor([-30.0, -1.0, 0.0, 3.0, 20.5, 40.0])
    want = np.asarray(jax.nn.softplus(jnp.asarray(x.numpy())))
    np.testing.assert_array_equal(ssm.softplus(x).numpy(), want)


# ---------------------------------------------------------------------------
# the model: loss, gradients, recompute, the client vmap
# ---------------------------------------------------------------------------

def _batch(vocab, B=2, S=SEQ, seed=0):
    rs = np.random.RandomState(seed)
    return {n: torch.from_numpy(rs.randint(0, vocab, (B, S))
                                .astype(np.int32))
            for n in ("tokens", "labels")}


# zamba2's smoke config has no tail (4 layers, a group of 2): 5 layers
# give 2 groups and a tail of 1
CASES = [("falcon-mamba-7b", {}), ("zamba2-1.2b", {}),
         ("zamba2-1.2b", {"num_layers": 5})]


@pytest.mark.parametrize("arch,kw", [CASES[0], CASES[2]],
                         ids=["falcon", "zamba2-tail"])
def test_train_loss_and_gradients_match_reference(arch, kw):
    """The loss within rtol 1e-5 and every leaf's gradient within 1e-5 of
    its largest magnitude, f32, two chunks; zamba2 with 2 groups and a
    tail layer, its shared block's gradient summing both applications
    (the smoke config, without a tail, runs in the Session trajectory)."""
    jcfg, pcfg = _configs(arch, **kw)
    jparams = jax_model.init_params(jcfg, jax.random.PRNGKey(0))
    pparams = bridge.params_from_jax(jax.device_get(jparams))
    b = _batch(pcfg.vocab_size, seed=1)

    def jloss(p):
        return jax_model.train_loss(
            jcfg, p, {k: jnp.asarray(v.numpy()) for k, v in b.items()})[0]
    want, jgrads = jax.jit(jax.value_and_grad(jloss))(jparams)
    leaves = {k: t.clone().requires_grad_(True) for k, t in pparams.items()}
    got, _ = pt_model.train_loss(pcfg, leaves, b)
    np.testing.assert_allclose(float(got.detach()), float(want), rtol=1e-5)
    keys = sorted(leaves)
    grads = torch.autograd.grad(got, [leaves[k] for k in keys])
    jflat = flatten(jax.device_get(jgrads))
    assert sorted(jflat) == keys
    for k, g in zip(keys, grads):
        _close(g.reshape(-1), np.asarray(jflat[k]).reshape(-1), 1e-5, k)
    if pcfg.family == "hybrid":
        assert float(grads[keys.index("shared_attn/mlp/w_up")].abs().sum()) > 0


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch,kw", CASES,
                         ids=["falcon", "zamba2", "zamba2-tail"])
def test_recompute_is_bit_identical(arch, kw, dtype):
    """The client pass (2 clients) with cfg.remat against without: loss
    and every gradient, torch.equal. Each mamba block is recomputed on
    its own; the shared block is not."""
    out = {}
    for on in (False, True):
        cfg = dataclasses.replace(pt_cb.get_smoke(arch), remat=on,
                                  dtype=dtype, **kw)
        params = pt_model.init_params(cfg, torch.Generator().manual_seed(0))
        out[on] = dist.per_client_value_and_grad(
            lambda p, b, cfg=cfg: pt_model.train_loss(cfg, p, b), params,
            _batch(cfg.vocab_size, B=4), 2)
    assert torch.equal(out[True][0], out[False][0])
    for k, g in out[False][2].items():
        assert torch.equal(out[True][2][k], g), k


@pytest.mark.parametrize("arch", ARCHS)
def test_client_vmap_matches_a_client_loop(arch):
    """The one vmap pass over 2 clients (recompute on) against each
    client's own loss and gradients: within 1e-5."""
    cfg = dataclasses.replace(pt_cb.get_smoke(arch), dtype="float32",
                              remat=True)
    params = pt_model.init_params(cfg, torch.Generator().manual_seed(0))
    batch = _batch(cfg.vocab_size, B=4)
    loss, _, grads = dist.per_client_value_and_grad(
        lambda p, b: pt_model.train_loss(cfg, p, b), params, batch, 2)
    losses = []
    for i in range(2):
        leaves = {k: t.clone().requires_grad_(True)
                  for k, t in params.items()}
        li, _ = pt_model.train_loss(
            cfg, leaves, {n: x[2 * i:2 * i + 2] for n, x in batch.items()})
        keys = sorted(leaves)
        for k, g in zip(keys, torch.autograd.grad(
                li, [leaves[k] for k in keys])):
            torch.testing.assert_close(grads[k][i], g, rtol=1e-5,
                                       atol=1e-5 * float(g.abs().max()))
        losses.append(float(li.detach()))
    np.testing.assert_allclose(float(loss), np.mean(losses), rtol=1e-6)


# ---------------------------------------------------------------------------
# the parameter tree, the serving cast, cache bytes
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("param_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", ARCHS)
def test_init_params_has_the_reference_s_leaves(arch, param_dtype):
    """Leaf paths, shapes and dtypes of the smoke tree against
    ``jax.eval_shape`` of the reference's: falcon's 11 leaves (9 stacked
    Mamba1 leaves), zamba2's 23 (12 stacked Mamba2 leaves, the shared
    block's 9 unstacked); A_log and D f32 under a bf16 param dtype too."""
    jcfg, pcfg = _configs(arch, param_dtype=param_dtype)
    shapes = jax.eval_shape(
        lambda: jax_model.init_params(jcfg, jax.random.PRNGKey(0)))
    want = {"/".join(p.key for p in path): leaf for path, leaf in
            jax.tree_util.tree_leaves_with_path(shapes)}
    for got in (pt_model.init_params(pcfg, None, "meta"),
                pt_model.init_params(pcfg, torch.Generator().manual_seed(0))):
        assert sorted(got) == sorted(want)
        assert len(got) == {"ssm": 11, "hybrid": 23}[pcfg.family]
        for k in got:
            assert tuple(got[k].shape) == want[k].shape, k
            assert str(got[k].dtype)[len("torch."):] == str(want[k].dtype), k
    for k in ("layers/mamba/A_log", "layers/mamba/D"):
        assert got[k].dtype == torch.float32
    assert got["layers/mamba/out_proj"].dtype == getattr(torch, param_dtype)


@pytest.mark.parametrize("arch", ARCHS)
def test_cast_matrices_keeps_the_scan_s_f32_leaves(arch):
    """Serving's cast: the matrices to bf16; the norms, A_log, D and
    dt_bias (read in f32 by the scan) kept f32."""
    cfg = pt_cb.get_smoke(arch)
    tree = pt_model.cast_matrices(
        cfg, pt_model.init_params(cfg, torch.Generator().manual_seed(0)))
    kept = ("norm", "A_log", "/D", "dt_bias")
    for k, t in tree.items():
        want = torch.float32 if k.endswith(kept) else torch.bfloat16
        assert t.dtype == want, k


@pytest.mark.parametrize("arch,layers,B,S,steps,want", [
    ("falcon-mamba-7b", 1, 8, 1024, 32, 4_587_520),     # D-falcon-mamba
    ("zamba2-1.2b", 13, 8, 1024, 32, 250_099_712),      # D-zamba2
    ("zamba2-1.2b", 38, 2, 16, 4, None)])
def test_cache_bytes_equal_the_reference(arch, layers, B, S, steps, want):
    """The port's cache for a serve of B x S and ``steps`` decode steps
    (meta tensors) against the reference's init_cache under
    jax.eval_shape, leaf by leaf."""
    jcfg = dataclasses.replace(jax_cb.get(arch), num_layers=layers)
    pcfg = dataclasses.replace(pt_cb.get(arch), num_layers=layers)
    ref = jax.eval_shape(lambda: jax_model.init_cache(jcfg, B, S + steps))
    cache = pt_model.init_cache(pcfg, B, S + steps, device="meta")
    assert sorted(cache) == sorted(ref)
    for k, t in cache.items():
        assert tuple(t.shape) == ref[k].shape, k
        assert str(t.dtype)[len("torch."):] == str(ref[k].dtype), k
    got = sum(t.numel() * t.element_size() for t in cache.values())
    assert want is None or got == want


def test_head_dim_of_an_attention_free_config_is_zero():
    """falcon-mamba's num_heads 0: head_dim_ 0, as the reference's (not a
    division by zero), and no K7 layer."""
    cfg = pt_cb.get("falcon-mamba-7b")
    assert cfg.head_dim_ == jax_cb.get("falcon-mamba-7b").head_dim_ == 0
    assert (cfg.d_inner, cfg.dt_rank) == (8192, 256)
    assert pt_model.flash_layers(cfg) == 0
    z = pt_cb.get("zamba2-1.2b")
    assert pt_model.flash_layers(z) == 38 // 6


# ---------------------------------------------------------------------------
# serving
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_and_decode_match_reference(arch, dtype):
    """A 128-token prompt (two chunks), row 1 right-padded to it from 121
    real tokens (``prompt_lens``), then 3 decode steps: logits and every
    cache entry after them. As in the reference, the padded row's states
    run over its padding: only its first token is read at its last real
    position. Tolerances: TOL, and HYBRID_BF16_TOL for zamba2 in bf16."""
    jcfg, pcfg = _configs(arch, dtype)
    tol = HYBRID_BF16_TOL if (pcfg.family, dtype) == ("hybrid", "bfloat16") \
        else TOL[dtype]
    jparams = jax_model.init_params(jcfg, jax.random.PRNGKey(0))
    pparams = pt_model.cast_matrices(
        pcfg, bridge.params_from_jax(jax.device_get(jparams)))
    B, S, steps = 2, SEQ, 3
    tokens = np.random.RandomState(2).randint(
        0, jcfg.vocab_size, (B, S + steps)).astype(np.int32)
    lens = np.array([S, S - 7], np.int32)
    tokens[1, S - 7:S] = 0                          # the padding, id 0
    cdt = (jnp.float32, torch.float32) if dtype == "float32" else \
        (jnp.bfloat16, torch.bfloat16)
    jcache = jax_model.init_cache(jcfg, B, S + steps, dtype=cdt[0])
    pcache = pt_model.init_cache(pcfg, B, S + steps, dtype=cdt[1])
    want, jcache = jax.jit(lambda p, b, c: jax_model.prefill(jcfg, p, b, c))(
        jparams, {"tokens": jnp.asarray(tokens[:, :S]),
                  "prompt_lens": jnp.asarray(lens)}, jcache)
    got, pcache = pt_model.prefill(
        pcfg, pparams, {"tokens": torch.tensor(tokens[:, :S]),
                        "prompt_lens": torch.tensor(lens)}, pcache)
    _close(got, want, tol, "prefill logits")
    jdec = jax.jit(lambda p, c, t, q: jax_model.decode_step(jcfg, p, c, t, q))
    for i in range(steps):
        t = tokens[:, S + i:S + i + 1]
        want, jcache = jdec(jparams, jcache, jnp.asarray(t),
                            jnp.asarray(S + i, jnp.int32))
        got, pcache = pt_model.decode_step(pcfg, pparams, pcache,
                                           torch.tensor(t), S + i)
        _close(got, want, tol, f"decode step {i}")
    assert sorted(pcache) == sorted(jcache)
    for k, t in pcache.items():
        assert t.dtype == getattr(torch, str(jcache[k].dtype)), k
        # each entry held to its largest magnitude: a state sums over the
        # sequence, and k and v carry the blocks' roundings before them
        _close(t.reshape(-1), jcache[k].reshape(-1), tol, f"cache {k}")


def test_padded_row_states_include_the_padding():
    """The standing behaviour, the reference's: a right-padded row's first
    token equals the unpadded prompt's, but its scan state after the
    prefill is that of the whole padded row, not of its real tokens."""
    _, pcfg = _configs("falcon-mamba-7b")
    params = pt_model.init_params(pcfg, torch.Generator().manual_seed(0))
    tok = torch.from_numpy(np.random.RandomState(3).randint(
        1, pcfg.vocab_size, (1, 64)).astype(np.int32))
    padded = torch.cat([tok[:, :57], torch.zeros(1, 7, dtype=torch.int32)],
                       1)
    runs = {}
    for name, t, lens in (("short", tok[:, :57], None),
                          ("padded", padded, torch.tensor([57]))):
        cache = pt_model.init_cache(pcfg, 1, 64, dtype=torch.float32)
        batch = {"tokens": t} if lens is None else {"tokens": t,
                                                    "prompt_lens": lens}
        runs[name] = pt_model.prefill(pcfg, params, batch, cache)
    _close(runs["padded"][0], runs["short"][0], 1e-5, "first token logits")
    assert not torch.allclose(runs["padded"][1]["ssm"],
                              runs["short"][1]["ssm"])


def test_f32_activations_widen_the_bf16_conv_cache_as_the_reference():
    """f32 activations on the default bf16 cache: the reference's
    concatenation carries an f32 conv state after the prefill; the port
    widens its cache entry once and matches the reference's logits and
    states through 2 decode steps."""
    jcfg, pcfg = _configs("zamba2-1.2b")
    jparams = jax_model.init_params(jcfg, jax.random.PRNGKey(1))
    pparams = bridge.params_from_jax(jax.device_get(jparams))
    tokens = np.random.RandomState(4).randint(
        0, jcfg.vocab_size, (2, 66)).astype(np.int32)
    # the shared block's k and v in f32, so that the conv state is the one
    # bf16 entry
    jcache = jax_model.init_cache(jcfg, 2, 66)
    jcache.update({k: jcache[k].astype(jnp.float32)
                   for k in ("k_attn", "v_attn")})
    pcache = pt_model.init_cache(pcfg, 2, 66)
    pcache.update({k: pcache[k].float() for k in ("k_attn", "v_attn")})
    assert pcache["conv"].dtype == torch.bfloat16
    want, jcache = jax_model.prefill(
        jcfg, jparams, {"tokens": jnp.asarray(tokens[:, :64])}, jcache)
    got, pcache = pt_model.prefill(
        pcfg, pparams, {"tokens": torch.tensor(tokens[:, :64])}, pcache)
    assert pcache["conv"].dtype == torch.float32 == \
        getattr(torch, str(jcache["conv"].dtype))
    _close(got, want, TOL["float32"], "prefill")
    for i in range(2):
        t = tokens[:, 64 + i:65 + i]
        want, jcache = jax_model.decode_step(jcfg, jparams, jcache,
                                             jnp.asarray(t),
                                             jnp.asarray(64 + i, jnp.int32))
        got, pcache = pt_model.decode_step(pcfg, pparams, pcache,
                                           torch.tensor(t), 64 + i)
        _close(got, want, TOL["float32"], f"decode {i}")
    _close(pcache["conv"], jcache["conv"], TOL["float32"], "conv")


@pytest.mark.parametrize("arch,want", [("falcon-mamba-7b", 0),
                                       ("zamba2-1.2b", 2)])
def test_prefill_runs_k7_once_a_shared_block_application(monkeypatch, arch,
                                                         want):
    """The smoke zamba2 prefill calls the K7 wrapper once for each of its
    2 applications of the shared block (``flash_layers``); falcon never;
    decode never."""
    calls = []

    def counted(*a, _fn=ops.flash_attention, **kw):
        calls.append(a[0].shape)
        return _fn(*a, **kw)
    monkeypatch.setattr(ops, "flash_attention", counted)
    _, pcfg = _configs(arch, "bfloat16")
    params = pt_model.cast_matrices(pcfg, pt_model.init_params(
        pcfg, torch.Generator().manual_seed(0)))
    cache = pt_model.init_cache(pcfg, 2, 65)
    tok = torch.zeros(2, 64, dtype=torch.int32)
    pt_model.prefill(pcfg, params, {"tokens": tok}, cache)
    assert len(calls) == want == pt_model.flash_layers(pcfg)
    pt_model.decode_step(pcfg, params, cache, tok[:, :1], 64)
    assert len(calls) == want


# ---------------------------------------------------------------------------
# specs, Sessions, checkpoints, the stream
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ARCHS)
def test_spec_hash_is_the_reference_s(arch):
    d = _shipped(arch=arch)
    spec = pt_spec.RunSpec.from_dict(d)
    assert spec.spec_hash() == jax_spec.RunSpec.from_dict(d).spec_hash()
    assert pt_spec.RunSpec.from_json(spec.to_json()) == spec
    assert pt_cb.get(arch) == dataclasses.replace(
        pt_cb.get(arch), **{f.name: getattr(jax_cb.get(arch), f.name)
                            for f in dataclasses.fields(pt_cb.ArchConfig)})


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
    """fused_quickstart.json on fused_quant8/fused_quant4 at smoke size, 2
    clients, seq 128, from the reference's npz: loss and g_norm within
    rtol 1e-4 over 3 steps."""
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


@pytest.mark.parametrize("arch", ARCHS)
def test_session_checkpoint_restores_bit_for_bit(tmp_path, arch):
    """One step, saved; a fresh Session restores it into a meta template,
    every leaf equal; its serve equals the first Session's."""
    d = _shipped(arch=arch, **TRAIN)
    sess = pt_session.Session(pt_spec.RunSpec.from_dict(d), device="cpu")
    sess.train(1, log_every=0)
    path = sess.save(str(tmp_path / "step_1.npz"))
    back = pt_session.Session(pt_spec.RunSpec.from_dict(d), device="cpu")
    back.restore_from(path)
    a = flatten({"params": sess.params, "opt_state": sess.opt_state,
                 "ef_state": sess.ef_state})
    b = flatten({"params": back.params, "opt_state": back.opt_state,
                 "ef_state": back.ef_state})
    assert sorted(a) == sorted(b) and back.step == 1
    assert any(k.endswith("layers/mamba/A_log") for k in a)
    for k, t in a.items():
        assert t.dtype == b[k].dtype and torch.equal(t, b[k]), k
    tok = torch.randint(0, sess.cfg.vocab_size, (2, 64),
                        generator=torch.Generator().manual_seed(0))
    outs = [s.serve(tokens=tok, decode_steps=3) for s in (sess, back)]
    np.testing.assert_array_equal(outs[0]["tokens"], outs[1]["tokens"])
    assert outs[0]["cache_bytes"] == outs[1]["cache_bytes"]


@pytest.mark.parametrize("arch", ARCHS)
def test_a_replica_follows_the_trainer_over_the_stream(tmp_path, arch):
    """The wire stream carries the new leaves (f32 A_log and D, zamba2's
    unstacked shared block): its transport legs' wire words are the
    reference's for the arch's tree, and a replica joined from the
    bootstrap equals the trainer's params bit for bit after 2 published
    fused_quant8/fused_quant4 steps."""
    from repro.core import stream as jax_stream
    from repro_torch.core import stream as stream_lib
    from repro_torch.launch import fleet as fleet_lib
    d = _shipped(arch=arch, **TRAIN)
    jspec, pspec = jax_spec.RunSpec.from_dict(d), pt_spec.RunSpec.from_dict(d)
    jlike = jax.eval_shape(lambda: jax_model.init_params(
        jax_session.Session(jspec).cfg, jax.random.PRNGKey(0)))
    sess = pt_session.Session(pspec, device="cpu")
    plegs = stream_lib.resolve_legs(
        sess.params, down_carrier=pspec.downlink_carrier,
        down_compressor=pt_build.make_down_compressor(pspec))
    jlegs = jax_stream.resolve_legs(
        jlike, schedule=None, down_carrier=jspec.downlink_carrier,
        down_compressor=jax_session.make_down_compressor(jspec))
    assert stream_lib.legs_wire_words(plegs, sess.params) == \
        jax_stream.legs_wire_words(jlegs, jlike)
    sess.publish_to(str(tmp_path / "wire"))
    sess.train(2, log_every=0)
    rep = fleet_lib.ServeReplica(str(tmp_path / "wire"), device="cpu")
    rep.sync()
    assert rep.step == 2 and sorted(rep.params) == sorted(sess.params)
    for k, t in sess.params.items():
        assert torch.equal(rep.params[k], t), k
