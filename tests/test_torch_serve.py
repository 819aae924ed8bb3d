"""The port's serving path against the reference's, on the CPU: KV cache,
prefill (K7's plain version on CPU tensors, where the reference runs
chunked attention), greedy decode, and Session.serve.

The weights come from the reference's ``init_params`` through
checkpoint/bridge.py; prompts are made with numpy from a seed. Tolerances:
- f32 activations: logits and f32 caches within 1e-5 (atol and rtol) — the
  packages differ only in the order of their sums. The caches are not held
  to 1e-6: one f32 einsum of the two frameworks already differs by more
  (layer 0's k, which is rope(rms_norm(embed) @ wk), by up to 1.2e-6 at a
  magnitude of 3.5, five ulps, in this test);
- bf16 activations: logits within 2e-2 of the largest logit's magnitude
  (rtol 2e-2, atol 2e-2 * max|logit|). The reference's prefill rounds
  the normalised P to bf16 before P.V where K7 rounds the unnormalised P
  against its running max, and the two frameworks round their bf16
  elementwise steps at different places; a logit is a bf16
  product rounded to bf16, so its error follows the size of its row, not
  its own: an elementwise 2e-2 fails near zero even when the port runs the
  reference's own chunked attention (0.036 at a logit of 0.01, measured on
  this test's inputs);
- within the port, in f32: 1e-5.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import base as jax_cb
from repro.launch import session as jax_session
from repro.launch import spec as jax_spec
from repro.models import model as jax_model
from repro_torch.checkpoint import bridge
from repro_torch.configs import base as pt_cb
from repro_torch.kernels import ops
from repro_torch.launch import serve as pt_serve
from repro_torch.launch import session as pt_session
from repro_torch.launch import spec as pt_spec
from repro_torch.models import model as pt_model

TINY = dict(arch="smollm-360m", smoke=True, clients=2, global_batch=4,
            seq_len=32)


def _configs(dtype):
    return (dataclasses.replace(jax_cb.get_smoke("smollm_360m"), dtype=dtype),
            dataclasses.replace(pt_cb.get_smoke("smollm-360m"), dtype=dtype))


def _params(jcfg, seed=0):
    jparams = jax_model.init_params(jcfg, jax.random.PRNGKey(seed))
    return jparams, bridge.params_from_jax(jax.device_get(jparams))


def _np(x):
    return np.asarray(x.float().numpy() if isinstance(x, torch.Tensor) else
                      np.asarray(x, np.float32))


def _close(got, want, tol, msg="", rowwise=False):
    """Within tol (atol and rtol); ``rowwise``: atol tol * max|want| of
    each row (the last axis)."""
    got, want = _np(got), _np(want)
    atol = tol * np.abs(want).max(-1, keepdims=True) if rowwise else tol
    bad = np.abs(got - want) > atol + tol * np.abs(want)
    assert got.shape == want.shape and not bad.any(), (
        f"{msg}: {int(bad.sum())} of {bad.size} outside tol {tol}; max abs "
        f"diff {np.abs(got - want).max()}")


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_prefill_and_decode_match_reference(dtype):
    """Prefill of a 24-token prompt, then 3 decode steps; in f32 with f32
    caches (compared too), in bf16 with the default bf16 caches."""
    jcfg, pcfg = _configs(dtype)
    jparams, pparams = _params(jcfg)
    B, S, steps = 2, 24, 3
    tokens = np.random.RandomState(0).randint(0, jcfg.vocab_size,
                                              (B, S + steps)).astype(np.int32)
    f32 = dtype == "float32"
    tol = 1e-5 if f32 else 2e-2
    jcache = jax_model.init_cache(jcfg, B, S + steps,
                                  dtype=jnp.float32 if f32 else jnp.bfloat16)
    pcache = pt_model.init_cache(pcfg, B, S + steps,
                                 dtype=torch.float32 if f32 else
                                 torch.bfloat16)
    jpre = jax.jit(lambda p, b, c: jax_model.prefill(jcfg, p, b, c))
    jdec = jax.jit(lambda p, c, t, q: jax_model.decode_step(jcfg, p, c, t, q))

    want, jcache = jpre(jparams, {"tokens": jnp.asarray(tokens[:, :S])},
                        jcache)
    got, pcache = pt_model.prefill(pcfg, pparams,
                                   {"tokens": torch.tensor(tokens[:, :S])},
                                   pcache)
    assert got.shape == (B, 1, pcfg.vocab_size) and got.dtype == torch.float32
    _close(got, want, tol, "prefill logits", rowwise=not f32)
    for i in range(steps):
        t = tokens[:, S + i:S + i + 1]
        want, jcache = jdec(jparams, jcache, jnp.asarray(t),
                            jnp.asarray(S + i, jnp.int32))
        got, pcache = pt_model.decode_step(pcfg, pparams, pcache,
                                           torch.tensor(t), S + i)
        _close(got, want, tol, f"decode step {i} logits", rowwise=not f32)
    if f32:
        for name in ("k", "v"):
            _close(pcache[name], jcache[name], tol, f"cache {name}")


def test_prefill_then_decode_equals_longer_prefill():
    """tests/test_models.py::test_prefill_decode_matches_full_forward on
    the port: decoding token S after prefilling S tokens gives the logits
    of a prefill over S+1 tokens."""
    _, cfg = _configs("float32")
    params = pt_model.init_params(cfg, torch.Generator().manual_seed(3))
    B, S = 2, 32
    tokens = torch.randint(0, cfg.vocab_size, (B, S + 1),
                           generator=torch.Generator().manual_seed(3))
    cache = pt_model.init_cache(cfg, B, S + 1, dtype=torch.float32)
    full, _ = pt_model.prefill(cfg, params, {"tokens": tokens}, cache)
    cache = pt_model.init_cache(cfg, B, S + 1, dtype=torch.float32)
    _, cache = pt_model.prefill(cfg, params, {"tokens": tokens[:, :S]}, cache)
    dec, _ = pt_model.decode_step(cfg, params, cache, tokens[:, S:], S)
    _close(dec, full, 1e-5)


def test_prefill_prompt_lens_ignores_right_padding():
    """tests/test_models.py::test_prefill_prompt_lens_ignores_right_padding
    on the port: with prompt_lens, a right-padded prompt ending in a real
    token 0 gives exactly the logits of the unpadded prompt."""
    _, cfg = _configs("float32")
    params = pt_model.init_params(cfg, torch.Generator().manual_seed(7))
    S, L = 8, 5
    row = torch.randint(1, cfg.vocab_size, (1, L),
                        generator=torch.Generator().manual_seed(7))
    row[0, L - 1] = 0                          # a real token 0, not padding
    padded = torch.zeros(1, S, dtype=row.dtype)
    padded[:, :L] = row

    def prefill(tokens, **extra):
        cache = pt_model.init_cache(cfg, 1, tokens.shape[1],
                                    dtype=torch.float32)
        return pt_model.prefill(cfg, params, {"tokens": tokens, **extra},
                                cache)[0]

    exact = prefill(row)
    _close(prefill(padded, prompt_lens=torch.tensor([L])), exact, 1e-5)
    assert (prefill(padded) - exact).abs().max() > 1e-3   # the tail differs


def test_session_serve_matches_reference_session():
    """Session.serve on both packages, from the same weights and explicit
    prompts, f32 activations and the default bf16 caches: the greedy tokens
    are equal and so are the cache bytes."""
    spec = dict(TINY)
    jsess = jax_session.Session(jax_spec.RunSpec(**spec))
    jsess.cfg = dataclasses.replace(jsess.cfg, dtype="float32")
    psess = pt_session.Session(pt_spec.RunSpec(**spec), device="cpu",
                               dtype="float32")
    jparams, pparams = _params(jsess.cfg, seed=11)
    jsess.set_serve_params(jparams)
    psess.set_serve_params(pparams)
    tokens = np.random.RandomState(5).randint(
        0, jsess.cfg.vocab_size, (3, 20)).astype(np.int32)
    want = jsess.serve(tokens=jnp.asarray(tokens), decode_steps=6)
    ops.reset_launches()
    got = psess.serve(tokens=tokens, decode_steps=6)
    assert ops.launches["flash_attention"] == 0       # CPU: plain version
    assert got["tokens"].shape == (3, 7) and got["tokens"].dtype == np.int32
    np.testing.assert_array_equal(got["tokens"], np.asarray(want["tokens"]))
    assert got["cache_bytes"] == want["cache_bytes"]
    for key in ("prefill_s", "decode_s", "prefill_tok_s", "decode_tok_s"):
        assert got[key] > 0


def test_serve_params_follow_state_changes_without_a_step(tmp_path):
    """tests/test_session.py::test_serve_params_track_same_step_state_changes
    on the port: step_once, set_serve_params and restore_from drop the
    served (placed, cast) tree, so an injected tree or a restore at the
    SAME step is served, never a stale copy. The served tree holds the
    source's matrices cast to the activation dtype (bf16 here): it is
    compared with the source cast the same way."""
    jsess = jax_session.Session(jax_spec.RunSpec(**TINY))
    ckpt = jsess.save(str(tmp_path / "step_0.npz"))
    sess = pt_session.Session(pt_spec.RunSpec(**TINY), device="cpu")

    def served():
        sess.serve(batch=1, prompt_len=8, decode_steps=1)
        return sess.serving_params()

    def cast(tree):
        return pt_model.cast_matrices(sess.cfg, tree)

    fresh = served()                     # no training state: a fresh init
    init = cast(pt_model.init_params(sess.cfg,
                                     torch.Generator().manual_seed(0)))
    assert all(torch.equal(fresh[k], init[k]) for k in init)

    sess.restore_from(ckpt)
    restored = {k: v.clone() for k, v in served().items()}
    assert all(torch.equal(restored[k], cast(sess.params)[k])
               for k in restored)

    sess.step_once()                     # a step moves the served params
    assert any(not torch.equal(served()[k], restored[k]) for k in restored)

    zeros = {k: torch.zeros_like(v) for k, v in sess.params.items()}
    sess.set_serve_params(zeros)         # same step, new tree
    assert all(not v.any() for v in served().values())

    sess.restore_from(ckpt)          # supersedes the injected tree
    assert sess.step == 0
    assert all(torch.equal(served()[k], restored[k]) for k in restored)


def _serve_greedy(cfg, params, tokens, steps):
    """Prefill, then ``steps`` greedy decode steps: (logits of each, the
    tokens, the cache)."""
    B, S = tokens.shape
    cache = pt_model.init_cache(cfg, B, S + steps)
    logits, cache = pt_model.prefill(cfg, params, {"tokens": tokens}, cache)
    out, toks = [logits], [logits[:, -1].argmax(-1)[:, None]]
    for i in range(steps):
        logits, cache = pt_model.decode_step(cfg, params, cache, toks[-1],
                                             S + i)
        out.append(logits)
        toks.append(logits[:, -1].argmax(-1)[:, None])
    return out, torch.cat(toks, dim=1), cache


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_cast_tree_serves_bit_identical(dtype):
    """``model.cast_matrices``: every matrix leaf in the activation dtype,
    the norm scales kept in f32 (the same tensors); serving from it gives
    the logits, tokens and cache of serving from the f32 tree, bit for bit
    (a cast commutes with the embedding's gather and with the slice of a
    stacked leaf). In f32 it is the tree itself."""
    _, cfg = _configs(dtype)
    params = pt_model.init_params(cfg, torch.Generator().manual_seed(3))
    tree = pt_model.cast_matrices(cfg, params)
    assert sorted(tree) == sorted(params)
    for k, t in tree.items():
        if k.endswith("norm"):
            assert t is params[k] and t.dtype == torch.float32, k
        else:
            assert t.dtype == cfg.activation_dtype, k
            assert (t is params[k]) == (dtype == "float32"), k
    tokens = torch.randint(0, cfg.vocab_size, (2, 24),
                           generator=torch.Generator().manual_seed(4))
    want_logits, want_toks, want_cache = _serve_greedy(cfg, params, tokens, 3)
    got_logits, got_toks, got_cache = _serve_greedy(cfg, tree, tokens, 3)
    for a, b in zip(got_logits, want_logits):
        assert torch.equal(a, b)
    assert torch.equal(got_toks, want_toks)
    for name in ("k", "v"):
        assert torch.equal(got_cache[name], want_cache[name])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_session_casts_once_per_params_version(dtype):
    """Session.serve runs ``serving_params()``: built once per params
    version (the same tensors on a second serve), matrices in the
    activation dtype and norm scales in f32, and its tokens are the greedy
    tokens of the uncast tree. set_serve_params makes a new version and
    drops the cached copy; the next serve builds it from the new tree."""
    sess = pt_session.Session(pt_spec.RunSpec(**TINY), device="cpu",
                              dtype=dtype)
    cfg = sess.cfg
    params = pt_model.init_params(cfg, torch.Generator().manual_seed(5))
    sess.set_serve_params(params)
    tokens = torch.randint(0, cfg.vocab_size, (2, 16),
                           generator=torch.Generator().manual_seed(6))
    out = sess.serve(tokens=tokens, decode_steps=3)
    tree = sess.serving_params()
    assert sess.serve(tokens=tokens, decode_steps=3)["tokens"].tolist() == \
        out["tokens"].tolist()
    assert all(sess.serving_params()[k] is tree[k] for k in tree)
    for k, t in tree.items():
        assert t.dtype == (torch.float32 if k.endswith("norm")
                           else cfg.activation_dtype), k
    _, want, _ = _serve_greedy(cfg, params, tokens, 3)
    np.testing.assert_array_equal(out["tokens"], want.numpy())

    other = pt_model.init_params(cfg, torch.Generator().manual_seed(8))
    sess.set_serve_params(other)
    assert sess._serve_params is None                # the copy is dropped
    new = sess.serving_params()
    assert all(torch.equal(new[k], other[k].to(new[k].dtype)) for k in new)
    assert not any(new[k] is tree[k] for k in new)


@pytest.mark.parametrize("hd,theta", [(64, 10000.0), (32, 100000.0),
                                      (128, 10000.0)])
def test_cached_rope_tables_equal_the_direct_computation(hd, theta):
    """RoPE's cos and sin read from the cached tables (``rope_at``) rotate
    q and k bit for bit as ``rope`` does from the positions, for training
    and prefill positions and for decode positions; the tables are built
    once per (hd, theta, device, power-of-two length)."""
    from repro_torch.models import layers
    gen = torch.Generator().manual_seed(hd)
    for B, S, length in ((2, 24, 24), (3, 17, 17), (1, 300, 300)):
        x = torch.randn(B, S, 3, hd, generator=gen)
        for positions, need in (
                (torch.arange(S)[None].expand(B, S), length),
                (torch.full((B, 1), S - 1), S)):
            xs = x[:, :positions.shape[1]]
            want = layers.rope(xs, positions, theta)
            got = layers.apply_rope(xs, *layers.rope_at(positions, hd, theta,
                                                        need))
            assert torch.equal(got, want)
            assert torch.equal(layers.apply_rope(
                xs.bfloat16(), *layers.rope_at(positions, hd, theta, need)),
                layers.rope(xs.bfloat16(), positions, theta))
    a = layers.rope_tables(hd, theta, 33, "cpu")
    b = layers.rope_tables(hd, theta, 64, "cpu")
    assert a[0] is b[0] and a[0].shape == (64, hd // 2)


def test_serve_cli_on_cpu(capsys):
    pt_serve.main(["--smoke", "--batch", "2", "--prompt-len", "8",
                   "--decode-steps", "2", "--device", "cpu"])
    out = capsys.readouterr().out
    assert "prefill 2×8:" in out and "decode 2 steps:" in out
    assert "sample generations (token ids):" in out


def test_serve_cli_refuses_fleet_mode(tmp_path):
    """Fleet mode refuses a stream it cannot join: one with no bootstrap
    checkpoint (params never travel on the wire)."""
    from repro_torch.core import stream as stream_lib
    with pytest.raises(stream_lib.StreamError, match="no bootstrap"):
        pt_serve.main(["--serve-stream", str(tmp_path / "nonexistent"),
                       "--replicas", "2", "--device", "cpu"])


@pytest.fixture(scope="module")
def cli_stream(tmp_path_factory):
    """``train --publish-stream`` on the CPU: 3 steps of a quant4 downlink,
    bootstraps at 0 and 2, the logged steps in ``--metrics-out``."""
    from repro_torch.launch import train as pt_train
    from test_torch_schedule import torch_threads
    root = tmp_path_factory.mktemp("cli_wire")
    metrics = root / "out" / "metrics.json"
    with torch_threads(1):
        pt_train.main(["--smoke", "--steps", "3", "--clients", "2",
                       "--global-batch", "4", "--seq", "32",
                       "--log-every", "1", "--compressor", "block_topk",
                       "--ratio", "0.1", "--downlink-carrier", "quant4",
                       "--downlink-ratio", "0.05", "--device", "cpu",
                       "--publish-stream", str(root / "wire"),
                       "--bootstrap-every", "2",
                       "--metrics-out", str(metrics)])
    return {"dir": str(root / "wire"), "metrics": str(metrics)}


def test_train_cli_publishes_a_stream_and_writes_metrics(cli_stream):
    import json
    from repro_torch.core import stream as stream_lib
    log = stream_lib.WireLog(cli_stream["dir"])
    assert log.last_step() == 3 and log.bootstrap_steps() == [0, 2]
    with open(cli_stream["metrics"]) as f:
        hist = json.load(f)
    assert [r["step"] for r in hist] == [0, 1, 2]
    assert all(np.isfinite(r["loss"]) and r["g_norm"] > 0 for r in hist)


@pytest.mark.parametrize("processes,tcp", [(False, False), (True, False),
                                           (True, True)],
                         ids=["in-process", "processes", "tcp-processes"])
def test_serve_cli_fleet_mode_on_cpu(cli_stream, capsys, monkeypatch,
                                     processes, tcp):
    """``serve --serve-stream --replicas 2 --lags 0,1`` (replicas in this
    process, or ``--processes``: worker processes; the stream a directory
    or ``tcp://`` of a TailServer), on the CPU: the fleet line names each
    replica's step, and every request completes."""
    from repro_torch.launch import transport as transport_lib
    from test_torch_schedule import torch_threads
    monkeypatch.setenv("OMP_NUM_THREADS", "1")
    srv = transport_lib.TailServer(cli_stream["dir"]).start() if tcp \
        else None
    argv = ["--serve-stream", srv.address if tcp else cli_stream["dir"],
            "--replicas", "2",
            "--lags", "0,1", "--requests", "4", "--rate", "0",
            "--prompt-len", "8", "--max-new-tokens", "2",
            "--decode-budget", "4", "--batch", "2", "--device", "cpu"]
    try:
        with torch_threads(1):
            pt_serve.main(argv + (["--processes"] if processes else []))
    finally:
        if srv is not None:
            srv.stop()
    out = capsys.readouterr().out
    if processes:
        assert "fleet of 2 worker PROCESSES" in out
    else:
        assert "(head step 3): r0@3(lag 0), r1@2(lag 1)" in out
    assert "4 requests in 2 batches" in out and "SHORT" not in out
