"""Mixture-of-experts on the port (models/moe.py, olmoe-1b-7b and
grok-1-314b) against the reference, on the CPU: ``moe_apply`` and
``moe_apply_dense`` (outputs, aux values, the kept mask and the experts'
load histogram, gradients), the client vmap against a client loop, block
recompute with the aux values leaving the block, the archs' training loss
and 3-step Session trajectories (both ``moe_impl`` values), cache bytes,
spec hashes, the router kept f32 for serving, and a Session checkpoint of
the expert leaves.

Inputs are made with numpy from a seed and weights come from the
reference's ``init_params``/``moe_init`` (checkpoint/bridge.py).
Tolerances: f32 within 1e-5 of a leaf's or a row's largest magnitude (only
the order of sums differs); bf16 within 2e-2 of each row's largest
magnitude (tests/test_torch_serve.py's serving tolerance); the integer
outcomes of routing (the kept mask, ``dropped_frac``, the per-expert
assignment counts) exactly; the 3-step trajectories within rtol 1e-4
(tests/test_torch_train.py).
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
from repro.models import moe as jax_moe
from repro_torch.checkpoint import bridge
from repro_torch.configs import base as pt_cb
from repro_torch.core import distributed as dist
from repro_torch.launch import session as pt_session
from repro_torch.launch import spec as pt_spec
from repro_torch.models import layers
from repro_torch.models import model as pt_model
from repro_torch.models import moe
from test_torch_schedule import one_torch_thread  # noqa: F401 (autouse)

ROOT = os.path.join(os.path.dirname(__file__), "..")
ARCHS = ["olmoe-1b-7b", "grok-1-314b"]
TOL = {"float32": 1e-5, "bfloat16": 2e-2}
E, D, FF, K = 8, 32, 24, 2           # a layer: d >= E for the keep probe
TRAIN = {"smoke": True, "seq_len": 32, "global_batch": 8, "clients": 4,
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


def _layer(seed=0):
    """One MoE layer of the reference's moe_init, as jax and torch trees."""
    jp = jax_moe.moe_init(jax.random.PRNGKey(seed), D, FF, E, jnp.float32)
    return jp, bridge.params_from_jax(jax.device_get(jp))


def _x(shape, seed, dtype):
    x = np.random.RandomState(seed).randn(*shape).astype(np.float32)
    if dtype == "bfloat16":         # both packages start from the same bf16
        x = np.asarray(jnp.asarray(x, jnp.bfloat16), np.float32)
    return (torch.tensor(x).to(getattr(torch, dtype)),
            jnp.asarray(x, getattr(jnp, dtype)))


def _apply(impl):
    return ((moe.moe_apply, jax_moe.moe_apply) if impl == "dispatch" else
            (moe.moe_apply_dense, jax_moe.moe_apply_dense))


# ---------------------------------------------------------------------------
# moe_apply and moe_apply_dense
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("impl,cf", [("dispatch", 0.5), ("dispatch", 1.25),
                                     ("dispatch", 4.0), ("dense", 1.25)])
def test_moe_apply_matches_reference(impl, cf, dtype):
    """(2, 24) tokens; capacity factors 0.5 and 1.25 drop assignments, 4.0
    none. dropped_frac exactly, the other aux values within 1e-6."""
    jp, pp = _layer()
    tx, jx = _x((2, 24, D), 1, dtype)
    pt_fn, jax_fn = _apply(impl)
    got, aux = pt_fn(pp, tx, k=K, cf=cf, eps=1e-6)
    want, jaux = jax_fn(jp, jx, k=K, cf=cf, eps=1e-6)
    assert got.dtype == tx.dtype
    _close(got, want, TOL[dtype], f"{impl} cf {cf}")
    assert sorted(aux) == sorted(jaux) == sorted(moe.AUX_KEYS)
    assert float(aux["dropped_frac"]) == float(jaux["dropped_frac"])
    for key in ("load_balance", "router_z"):
        np.testing.assert_allclose(float(aux[key]), float(jaux[key]),
                                   rtol=1e-6, err_msg=key)
    if impl == "dispatch" and cf < 1.5:
        assert float(aux["dropped_frac"]) > 0       # the case drops some
    if cf == 4.0:
        assert float(aux["dropped_frac"]) == 0


def _probe(params):
    """The layer with experts that reveal routing: w_gate = w_up put the
    same g on every ff column, so silu(g)·g = g²σ(g) > 0, and w_down writes
    expert e's output to column e alone. out[n, e] > 0 exactly when an
    assignment of token n to expert e was kept."""
    rs = np.random.RandomState(5)
    a = np.repeat(rs.randn(D, 1).astype(np.float32), FF, axis=1)
    down = np.zeros((E, FF, D), np.float32)
    for e in range(E):
        down[e, :, e] = 1.0
    p = dict(params)
    p["w_gate"] = p["w_up"] = np.broadcast_to(a, (E, D, FF)).copy()
    p["w_down"] = down
    return p


def _kept(out, k):
    """(N, E) bools of the probe's output: expert e kept for token n."""
    kept = _np(out).reshape(-1, out.shape[-1])[:, :E] > 0
    assert (kept.sum(1) <= k).all()
    return kept


@pytest.mark.parametrize("cf", [0.5, 1.0, 1.25, 4.0])
def test_kept_mask_and_load_histogram_are_the_reference_s(cf):
    """The integer outcomes of routing, exactly: which assignments each
    package keeps (read off the probe layer), dropped_frac, and (at cf
    4.0, where nothing drops) each token's chosen experts and the
    per-expert counts the load-balance loss weighs."""
    jp, _ = _layer(seed=2)
    jp = {k: jnp.asarray(v) for k, v in _probe(jax.device_get(jp)).items()}
    pp = bridge.params_from_jax(jax.device_get(jp))
    tx, jx = _x((3, 40, D), 3, "float32")
    got, aux = moe.moe_apply(pp, tx, k=K, cf=cf, eps=1e-6)
    want, jaux = jax_moe.moe_apply(jp, jx, k=K, cf=cf, eps=1e-6)
    np.testing.assert_array_equal(_kept(got, K), _kept(want, K))
    assert float(aux["dropped_frac"]) == float(jaux["dropped_frac"])
    kept = _kept(got, K)
    n_dropped = kept.shape[0] * K - kept.sum()
    assert round(float(aux["dropped_frac"]) * kept.shape[0] * K) == n_dropped
    _, _, top_e, counts, _, _ = moe._route(pp, tx, K, 1e-6)
    chosen = np.zeros_like(kept)
    np.put_along_axis(chosen, top_e.numpy(), True, axis=1)
    assert (kept <= chosen).all()
    if cf == 4.0:
        np.testing.assert_array_equal(chosen, kept)
        np.testing.assert_array_equal(counts.numpy(),
                                      _kept(want, K).sum(0))


def test_capacity_is_the_reference_s():
    for N, E_, k, cf in [(512, 64, 8, 1.25), (8192, 64, 8, 1.25),
                         (8, 64, 8, 1.25), (48, 4, 2, 1.25), (7, 3, 2, 0.1)]:
        assert moe._capacity(N, E_, k, cf) == \
            jax_moe._capacity(N, E_, k, cf)
    cfg = pt_cb.get("olmoe-1b-7b")
    # a client's training tokens, a prefill's and a decode step's (B 8)
    assert [moe.capacity(cfg, n) for n in (512, 8192, 8)] == [80, 1280, 1]


@pytest.mark.parametrize("impl", ["dispatch", "dense"])
def test_moe_gradients_match_reference(impl):
    """Gradients of the router and the three expert leaves, and of x, for
    a loss that uses the output and both aux losses; f32, cf 1.0 (some
    assignments drop)."""
    jp, pp = _layer(seed=4)
    tx, jx = _x((2, 24, D), 6, "float32")
    pt_fn, jax_fn = _apply(impl)
    w = np.random.RandomState(7).randn(2, 24, D).astype(np.float32)

    def jloss(p, x):
        out, aux = jax_fn(p, x, k=K, cf=1.0, eps=1e-6)
        return (jnp.sum(out * w) + 0.01 * aux["load_balance"]
                + 0.001 * aux["router_z"])
    want = jax.grad(jloss, argnums=(0, 1))(jp, jx)
    leaves = {k: t.clone().requires_grad_(True) for k, t in pp.items()}
    x = tx.clone().requires_grad_(True)
    out, aux = pt_fn(leaves, x, k=K, cf=1.0, eps=1e-6)
    loss = (torch.sum(out * torch.tensor(w)) + 0.01 * aux["load_balance"]
            + 0.001 * aux["router_z"])
    names = ["router", "w_gate", "w_up", "w_down", "norm"]
    got = torch.autograd.grad(loss, [leaves[n] for n in names] + [x])
    for name, g in zip(names, got):
        _close(g.reshape(-1), np.asarray(want[0][name]).reshape(-1),
               TOL["float32"], name)
    _close(got[-1], want[1], TOL["float32"], "x")


# ---------------------------------------------------------------------------
# the model: client vmap, recompute, loss
# ---------------------------------------------------------------------------

def _batch(cfg, B=4, S=24, seed=0):
    rs = np.random.RandomState(seed)
    return {n: torch.from_numpy(rs.randint(0, cfg.vocab_size, (B, S))
                                .astype(np.int32))
            for n in ("tokens", "labels")}


@pytest.mark.parametrize("impl", ["dispatch", "dense"])
def test_client_vmap_matches_a_client_loop(impl):
    """olmoe's smoke config, 2 clients: the one vmap pass against each
    client's own loss and gradients (capacity from one client's tokens,
    so the same assignments drop); the aux values averaged over clients."""
    cfg = dataclasses.replace(pt_cb.get_smoke("olmoe-1b-7b"),
                              dtype="float32", moe_impl=impl,
                              moe_capacity_factor=1.0)
    params = pt_model.init_params(cfg, torch.Generator().manual_seed(0))
    batch = _batch(cfg)
    loss, aux, grads = dist.per_client_value_and_grad(
        lambda p, b: pt_model.train_loss(cfg, p, b), params, batch, 2)
    losses, auxes = [], []
    for i in range(2):
        leaves = {k: t.clone().requires_grad_(True)
                  for k, t in params.items()}
        li, ai = pt_model.train_loss(
            cfg, leaves, {n: x[2 * i:2 * i + 2] for n, x in batch.items()})
        keys = sorted(leaves)
        for k, g in zip(keys, torch.autograd.grad(
                li, [leaves[k] for k in keys])):
            torch.testing.assert_close(grads[k][i], g, rtol=1e-5,
                                       atol=1e-5 * float(g.abs().max()))
        losses.append(float(li.detach()))
        auxes.append({k: float(v.detach()) for k, v in ai.items()})
    np.testing.assert_allclose(float(loss), np.mean(losses), rtol=1e-6)
    for k in moe.AUX_KEYS:
        np.testing.assert_allclose(float(aux[k]),
                                   np.mean([a[k] for a in auxes]),
                                   rtol=1e-6, err_msg=k)
    if impl == "dispatch":
        assert float(aux["dropped_frac"]) > 0


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch,impl", [("olmoe-1b-7b", "dispatch"),
                                       ("olmoe-1b-7b", "dense"),
                                       ("grok-1-314b", "dispatch")])
def test_recompute_is_bit_identical_aux_included(arch, impl, dtype):
    """The client pass (2 clients) with cfg.remat against without: the
    loss, every aux value (which leave each recomputed block beside h) and
    every gradient, torch.equal; the backward recomputes the forward's
    routing exactly."""
    out = {}
    for on in (False, True):
        cfg = dataclasses.replace(pt_cb.get_smoke(arch), remat=on,
                                  dtype=dtype, moe_impl=impl,
                                  moe_capacity_factor=1.0)
        params = pt_model.init_params(cfg, torch.Generator().manual_seed(0))
        out[on] = dist.per_client_value_and_grad(
            lambda p, b, cfg=cfg: pt_model.train_loss(cfg, p, b), params,
            _batch(cfg, S=40), 2)
    assert torch.equal(out[True][0], out[False][0])
    for k, a in out[False][1].items():
        assert torch.equal(out[True][1][k], a), k
    for k, g in out[False][2].items():
        assert torch.equal(out[True][2][k], g), k


def _configs(arch, dtype="float32", **kw):
    return (dataclasses.replace(jax_cb.get_smoke(arch), dtype=dtype, **kw),
            dataclasses.replace(pt_cb.get_smoke(arch), dtype=dtype, **kw))


@pytest.mark.parametrize("arch,impl", [("olmoe-1b-7b", "dispatch"),
                                       ("olmoe-1b-7b", "dense"),
                                       ("grok-1-314b", "dispatch")])
def test_train_loss_matches_reference(arch, impl):
    """The loss with its aux terms, and each summed aux value: the dropped
    assignments' count exactly (XLA rounds ``1 - mean`` one way eagerly and
    another inside the scan of layers, a few f32 ulps apart), the other
    values within 1e-5."""
    jcfg, pcfg = _configs(arch, moe_impl=impl)
    jparams = jax_model.init_params(jcfg, jax.random.PRNGKey(0))
    pparams = bridge.params_from_jax(jax.device_get(jparams))
    b = _batch(pcfg, B=2, S=40, seed=1)
    want, jaux = jax_model.train_loss(
        jcfg, jparams, {k: jnp.asarray(v.numpy()) for k, v in b.items()})
    got, aux = pt_model.train_loss(pcfg, pparams, b)
    np.testing.assert_allclose(float(got), float(want), rtol=1e-5)
    nk = 2 * 40 * pcfg.num_experts_per_tok          # assignments a layer
    assert round(float(aux["dropped_frac"]) * nk) == \
        round(float(jaux["dropped_frac"]) * nk)
    np.testing.assert_allclose(float(aux["dropped_frac"]),
                               float(jaux["dropped_frac"]), atol=1e-6)
    for k in ("load_balance", "router_z"):
        np.testing.assert_allclose(float(aux[k]), float(jaux[k]), rtol=1e-5,
                                   err_msg=k)


def test_init_params_has_the_reference_s_leaves():
    """Leaf paths, shapes and dtypes of olmoe's smoke tree, the router f32
    under a bf16 param dtype too."""
    for param_dtype in ("float32", "bfloat16"):
        jcfg, pcfg = _configs("olmoe-1b-7b", param_dtype=param_dtype)
        shapes = jax.eval_shape(
            lambda: jax_model.init_params(jcfg, jax.random.PRNGKey(0)))
        want = {"/".join(p.key for p in path): leaf for path, leaf in
                jax.tree_util.tree_leaves_with_path(shapes)}
        got = pt_model.init_params(pcfg, None, "meta")
        assert sorted(got) == sorted(want)
        for k in got:
            assert tuple(got[k].shape) == want[k].shape, k
            assert str(got[k].dtype)[len("torch."):] == str(want[k].dtype), k
        assert got["layers/moe/router"].dtype == torch.float32
        assert got["layers/moe/w_up"].dtype == getattr(torch, param_dtype)


def test_cast_matrices_keeps_the_router_f32():
    cfg = pt_cb.get_smoke("olmoe-1b-7b")
    tree = pt_model.cast_matrices(
        cfg, pt_model.init_params(cfg, torch.Generator().manual_seed(0)))
    for k, t in tree.items():
        want = torch.float32 if k.endswith(("norm", "router")) \
            else torch.bfloat16
        assert t.dtype == want, k


# ---------------------------------------------------------------------------
# serving
# ---------------------------------------------------------------------------

def _chunked_prefill(monkeypatch):
    """Every layer's prefill on chunked attention, as the reference
    prefills: K7's bf16 roundings (P against the running max) move a
    router probability by up to about 1e-2 and may flip a near tie of the
    routing (test_bf16_routing_flips_under_k7_are_near_ties)."""
    monkeypatch.setattr(layers, "prefill_runs_flash", lambda *a: False)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_and_decode_match_reference(monkeypatch, arch, dtype):
    """A 40-token prompt with per-row lengths, then 3 decode steps (B 2:
    the decode's capacity drops assignments, as the reference's). f32 on
    the serving route (K7's plain version where it computes the layer);
    bf16 with the reference's chunked prefill (:func:`_chunked_prefill`)."""
    if dtype == "bfloat16":
        _chunked_prefill(monkeypatch)
    jcfg, pcfg = _configs(arch, dtype)
    jparams = jax_model.init_params(jcfg, jax.random.PRNGKey(0))
    pparams = pt_model.cast_matrices(
        pcfg, bridge.params_from_jax(jax.device_get(jparams)))
    assert pparams["layers/moe/router"].dtype == torch.float32
    B, S, steps = 2, 40, 3
    tokens = np.random.RandomState(2).randint(
        0, jcfg.vocab_size, (B, S + steps)).astype(np.int32)
    lens = np.array([S, S - 7], np.int32)
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
    _close(got, want, TOL[dtype], "prefill logits")
    jdec = jax.jit(lambda p, c, t, q: jax_model.decode_step(jcfg, p, c, t, q))
    for i in range(steps):
        t = tokens[:, S + i:S + i + 1]
        want, jcache = jdec(jparams, jcache, jnp.asarray(t),
                            jnp.asarray(S + i, jnp.int32))
        got, pcache = pt_model.decode_step(pcfg, pparams, pcache,
                                           torch.tensor(t), S + i)
        _close(got, want, TOL[dtype], f"decode step {i}")


@pytest.mark.parametrize("arch", ARCHS)
def test_bf16_routing_flips_under_k7_are_near_ties(monkeypatch, arch):
    """The bf16 prefill on the serving route (K7 where it computes the
    layer) against the same prefill on chunked attention: in the first
    layer where the chosen experts differ (the two runs' hidden states
    differ there by bf16 roundings alone; a flip moves the later tokens
    of its row in the later layers by more), every differing token is a
    near tie, its swapped experts' router probabilities within 2e-2 of
    each other (the bf16 serving tolerance)."""
    _, pcfg = _configs(arch, "bfloat16")
    params = pt_model.cast_matrices(pcfg, pt_model.init_params(
        pcfg, torch.Generator().manual_seed(0)))
    tokens = torch.from_numpy(np.random.RandomState(2).randint(
        0, pcfg.vocab_size, (2, 40)).astype(np.int32))
    seen = {}
    for route in ("k7", "chunked"):
        if route == "chunked":
            _chunked_prefill(monkeypatch)
        cache = pt_model.init_cache(pcfg, 2, 40)
        with moe.capture_routing() as seen[route]:
            pt_model.prefill(pcfg, params, {"tokens": tokens}, cache)
    assert len(seen["k7"]) == len(seen["chunked"]) == pcfg.num_layers
    for (e1, _), (e2, p2) in zip(seen["k7"], seen["chunked"]):
        flipped = (e1 != e2).any(-1).nonzero().ravel().tolist()
        for n in flipped:
            a, b = e1[n][e1[n] != e2[n]], e2[n][e1[n] != e2[n]]
            gap = float((p2[n][a] - p2[n][b]).abs().max())
            assert gap < 2e-2, (n, e1[n].tolist(), e2[n].tolist(), gap)
        if flipped:
            break


@pytest.mark.parametrize("arch,layers,B,S,steps,want", [
    ("olmoe-1b-7b", 1, 8, 1024, 32, 69_206_016),      # phase D-olmoe
    ("grok-1-314b", 1, 2, 16, 4, None)])
def test_cache_bytes_equal_the_reference(arch, layers, B, S, steps, want):
    """The port's cache for a serve of B x S and ``steps`` decode steps
    against the reference's init_cache under jax.eval_shape."""
    jcfg = dataclasses.replace(jax_cb.get(arch), num_layers=layers)
    pcfg = dataclasses.replace(pt_cb.get(arch), num_layers=layers)
    ref = jax.eval_shape(lambda: jax_model.init_cache(jcfg, B, S + steps))
    ref_bytes = sum(x.size * x.dtype.itemsize
                    for x in jax.tree_util.tree_leaves(ref))
    cache = pt_model.init_cache(pcfg, B, S + steps, device="meta")
    got = sum(t.numel() * t.element_size() for t in cache.values())
    assert got == ref_bytes
    assert want is None or got == want


# ---------------------------------------------------------------------------
# specs, Sessions, checkpoints
# ---------------------------------------------------------------------------

def _shipped(name="fused_quickstart", **overrides):
    with open(os.path.join(ROOT, "results", "specs", f"{name}.json")) as f:
        return dict(json.load(f), **overrides)


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("impl", ["dispatch", "dense"])
def test_spec_hash_is_the_reference_s(arch, impl):
    d = _shipped(arch=arch, moe_impl=impl)
    spec = pt_spec.RunSpec.from_dict(d)
    assert spec.spec_hash() == jax_spec.RunSpec.from_dict(d).spec_hash()
    assert pt_spec.RunSpec.from_json(spec.to_json()) == spec
    assert pt_session.Session(spec, device="cpu").cfg.moe_impl == impl
    with pytest.raises(ValueError, match="moe_impl='scatter'"):
        pt_spec.RunSpec.from_dict(dict(d, moe_impl="scatter"))


def test_the_moe_impl_flag_reaches_the_spec():
    import argparse
    ap = argparse.ArgumentParser()
    pt_spec.add_flags(ap)
    args = ap.parse_args(["--arch", "olmoe-1b-7b", "--moe-impl", "dense"])
    spec = pt_spec.from_args(args)
    assert (spec.arch, spec.moe_impl) == ("olmoe-1b-7b", "dense")


def test_quant4_multipod_zero_is_refused_for_its_mesh_alone():
    """grok-1-314b, the multi_pod mesh, the input shape, pod granularity
    and ZeRO are ported: the shipped spec loads with the reference's hash,
    and so do its group variant (a batch of the group geometry's 32
    clients) on multi_pod and on the smoke mesh. Its ZeRO training state
    is refused for its mesh alone: the production geometry (pod 2, data
    16, model 16) puts 16 data ranks in a pod, where the reference's round
    fails; with one data rank a pod it runs. Serving it on one rank is not
    refused (grok smoke, a prompt of 8 and 2 decode steps)."""
    from repro_torch.launch import mesh as mesh_lib
    from repro_torch.launch import shardings as sh
    from repro_torch.launch.session import Session
    d = _shipped("quant4_multipod_zero")
    assert d["arch"] == "grok-1-314b"
    group = dict(d, client_granularity="group", state_sharding="client",
                 global_batch=32)
    for ok in (d, group, dict(group, mesh="smoke", shape=None)):
        assert pt_spec.RunSpec.from_dict(ok).spec_hash() == \
            jax_spec.RunSpec.from_dict(ok).spec_hash()
    spec = pt_spec.RunSpec.from_dict(d)
    cfg = Session._arch_config(spec)
    plan = sh.ShardPlan(spec.client_granularity, spec.state_sharding)
    prod = mesh_lib.Mesh((2, 16, 16), ("pod", "data", "model"))
    msg = sh.zero_refusal(cfg, prod, plan)
    assert msg is not None and "TypeError" in msg
    assert "arch" not in msg and "shape=" not in msg
    one = mesh_lib.Mesh((2, 1, 16), ("pod", "data", "model"))
    assert sh.zero_refusal(cfg, one, plan) is None
    served = Session(pt_spec.RunSpec.from_dict(dict(d, smoke=True)),
                     device="cpu").serve(batch=1, prompt_len=8,
                                         decode_steps=2)
    assert served["tokens"].shape == (1, 3)


@pytest.fixture(scope="module")
def reference_runs(tmp_path_factory):
    """Per (arch, impl), once for the module: the reference Session's
    initial state as npz and its 3-step trajectory in f32."""
    runs = {}

    def run(arch, impl):
        if (arch, impl) not in runs:
            d = _shipped(arch=arch, moe_impl=impl, **TRAIN)
            jsess = jax_session.Session(jax_spec.RunSpec.from_dict(d))
            jsess.cfg = dataclasses.replace(jsess.cfg, dtype="float32")
            path = str(tmp_path_factory.mktemp(arch) / "step_0.npz")
            ckpt = jsess.save(path)
            runs[arch, impl] = (d, ckpt, jsess.train(3, log_every=1))
        return runs[arch, impl]
    return run


@pytest.mark.parametrize("arch,impl", [("olmoe-1b-7b", "dispatch"),
                                       ("olmoe-1b-7b", "dense"),
                                       ("grok-1-314b", "dispatch")])
def test_three_session_steps_match_reference(arch, impl, reference_runs):
    d, ckpt, want = reference_runs(arch, impl)
    psess = pt_session.Session(pt_spec.RunSpec.from_dict(d), device="cpu",
                               dtype="float32")
    psess.restore_from(ckpt)
    got = psess.train(3, log_every=1)
    assert [r["step"] for r in got] == [0, 1, 2]
    for key in ("loss", "g_norm"):
        np.testing.assert_allclose([r[key] for r in got],
                                   [r[key] for r in want], rtol=1e-4,
                                   err_msg=key)


def test_reference_tree_crosses_the_bridge_unchanged(tmp_path):
    """The reference's nested tree (the f32 router, 4-D expert leaves)
    becomes the port's flat leaves, and the port's npz of them restores
    into the reference's nested template, bit for bit both ways."""
    from repro.checkpoint import checkpoint as jax_ckpt
    from repro_torch.checkpoint import checkpoint as pt_ckpt
    jcfg = jax_cb.get_smoke("olmoe-1b-7b")
    jparams = jax.device_get(jax_model.init_params(jcfg,
                                                   jax.random.PRNGKey(1)))
    flat = bridge.params_from_jax(jparams)
    assert flat["layers/moe/w_gate"].dim() == 4
    assert flat["layers/moe/router"].dtype == torch.float32
    for path, leaf in jax.tree_util.tree_leaves_with_path(jparams):
        key = "/".join(p.key for p in path)
        np.testing.assert_array_equal(flat[key].numpy(), np.asarray(leaf))
    npz = str(tmp_path / "params.npz")
    pt_ckpt.save(npz, {"params": flat})
    back, _ = jax_ckpt.restore(npz, {"params": jparams})
    for a, b in zip(jax.tree_util.tree_leaves(back["params"]),
                    jax.tree_util.tree_leaves(jparams)):
        assert np.asarray(a).dtype == np.asarray(b).dtype
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def test_session_checkpoint_restores_bit_for_bit(tmp_path):
    """A Session of olmoe's smoke config, one step, saved; a fresh Session
    restores it into a meta template, every leaf equal."""
    from repro_torch.core.ef import flatten
    d = _shipped(arch="olmoe-1b-7b", **TRAIN)
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
    assert any(k.endswith("layers/moe/w_down") for k in a)
    for k, t in a.items():
        assert t.dtype == b[k].dtype and torch.equal(t, b[k]), k


@pytest.mark.parametrize("arch", ["olmoe-1b-7b", "musicgen-medium"])
def test_a_replica_follows_the_trainer_over_the_stream(tmp_path, arch):
    """The wire stream carries the new leaves (the f32 router, the 4-D
    expert stacks, frontend_proj): its transport legs and wire words are
    the reference's for the arch's tree, and a replica joined from the
    bootstrap equals the trainer's params bit for bit after 2 published
    fused_quant8/fused_quant4 steps."""
    from repro.core import stream as jax_stream
    from repro_torch.core import stream as stream_lib
    from repro_torch.launch import build as pt_build
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
