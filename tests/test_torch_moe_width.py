"""olmoe-1b-7b's routing at its published width, against the reference,
on the CPU: what decides which of a client's assignments its MoE layer
drops in phase D-olmoe of chip_smoke.py.

D-olmoe trains olmoe-1b-7b cut to 1 of its 16 layers on
``fused_quickstart.json``'s batch: 16 rows of 256 tokens over 8 clients,
so each client's forward routes its 2 rows, 512 tokens, in one MoE call
(top 8 of 64 experts, capacity factor 1.25: C = 80). Here each package
runs what reaches that call's router at d_model 2048: the embedding, the
first layer's attention (16 heads of 128) and residual add, then its MoE
layer, client by client, on the same params and the same tokens (the
step-0 batch of D-olmoe's data pipeline).

Cuts, none of which the routing reads:
- the vocabulary: only the rows of the embedding the batch's tokens look
  up, the tokens renumbered onto them (the lookup is a row gather);
- the experts' width: d_ff 1 in place of 1024. The experts are a probe
  (tests/test_torch_moe.py's): w_gate = w_up put one g on the column, so
  silu(g)·g > 0, and w_down writes expert e's output to column e alone, so
  out[n, e] > 0 exactly when token n's assignment to expert e was kept.
  The reference runs it once at the call's capacity factor (the kept
  assignments) and once at 8.0, where C = 512 keeps every assignment (the
  chosen ones); the port's chosen ones are its router's top 8
  (``moe.capture_routing``), each held against the other.

Held exactly in f32: each token's chosen and kept experts, the per-expert
assignment and drop counts, and ``dropped_frac``; in the spec's bf16 the
tokens that choose otherwise are near ties (the test's docstring). The
params are the reference's draws (``attn_init``, the router's and the
embedding's init formulas), carried to the port by
``checkpoint/bridge.py``.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from repro.configs import base as jax_cb
from repro.models import layers as jax_layers
from repro.models import model as jax_model
from repro.models import moe as jax_moe
from repro_torch.checkpoint import bridge
from repro_torch.configs import base as pt_cb
from repro_torch.data import pipeline as pipe_lib
from repro_torch.models import layers
from repro_torch.models import model as pt_model
from repro_torch.models import moe
from test_torch_schedule import one_torch_thread  # noqa: F401 (autouse)

ARCH = "olmoe-1b-7b"
CLIENTS, GLOBAL_BATCH, SEQ = 8, 16, 256     # fused_quickstart.json
ROWS = GLOBAL_BATCH // CLIENTS              # a client's rows, one MoE call
ALL_KEPT_CF = 8.0                           # C = N: no assignment drops


def _configs(dtype):
    return tuple(dataclasses.replace(lib.get(ARCH), num_layers=1,
                                     dtype=dtype)
                 for lib in (jax_cb, pt_cb))


def _tokens(cfg):
    """D-olmoe's step-0 batch (the Session's pipeline at seed 0), its ids
    renumbered onto the distinct ids drawn, and how many there are."""
    batch = pipe_lib._batch_np(pipe_lib.DataConfig(
        vocab_size=cfg.vocab_size, seq_len=SEQ, global_batch=GLOBAL_BATCH,
        seed=0, dp_groups=CLIENTS, heterogeneity=0.5), 0)
    ids, tokens = np.unique(batch["tokens"], return_inverse=True)
    return tokens.reshape(GLOBAL_BATCH, SEQ).astype(np.int32), len(ids)


def _params(cfg, vocab):
    """The reference's draws: the embedding's rows, the layer's attention
    and router, and the probe experts."""
    d, E = cfg.d_model, cfg.num_experts
    r_embed, r_attn, r_router, r_probe = jax.random.split(
        jax.random.PRNGKey(0), 4)
    # g of order 1 on the unit-rms normed tokens: silu(g)·g stays normal
    a = np.asarray(jax.random.normal(r_probe, (d, 1)) * d ** -0.5,
                   np.float32)
    down = np.zeros((E, 1, d), np.float32)
    down[np.arange(E), 0, np.arange(E)] = 1.0
    params = {
        "embed": jax.random.normal(r_embed, (vocab, d)) * d ** -0.5,
        "attn": jax_layers.attn_init(r_attn, d, cfg.num_heads,
                                     cfg.num_kv_heads, cfg.head_dim_,
                                     jnp.float32),
        "moe": {"router": jax.random.normal(r_router, (d, E)) * d ** -0.5,
                "w_gate": np.broadcast_to(a, (E, d, 1)).copy(),
                "w_up": np.broadcast_to(a, (E, d, 1)).copy(),
                "w_down": down, "norm": np.zeros((d,), np.float32)}}
    return jax.tree_util.tree_map(np.asarray, params)


def _reference(cfg, params, tokens):
    """The reference's probe outputs (clients, N, E) at the call's
    capacity factor and at ALL_KEPT_CF, and each client's dropped_frac at
    the call's."""
    @jax.jit
    def run(p, t):
        h, _ = jax_model._embed(cfg, {"embed": p["embed"]}, t, None)
        positions = jnp.broadcast_to(jnp.arange(SEQ)[None], t.shape)
        delta, _ = jax_layers.attn_apply(
            p["attn"], h, positions, rope_theta=cfg.rope_theta,
            eps=cfg.norm_eps, chunk=cfg.attn_chunk, window=cfg.sliding_window,
            cap=cfg.logit_softcap)
        h = h + delta
        kept, chosen, drops = [], [], []
        for c in range(CLIENTS):
            x = h[c * ROWS:(c + 1) * ROWS]
            out, aux = jax_moe.moe_apply(
                p["moe"], x, k=cfg.num_experts_per_tok,
                cf=cfg.moe_capacity_factor, eps=cfg.norm_eps)
            kept.append(out.reshape(-1, out.shape[-1]))
            drops.append(aux["dropped_frac"])
            out, _ = jax_moe.moe_apply(
                p["moe"], x, k=cfg.num_experts_per_tok, cf=ALL_KEPT_CF,
                eps=cfg.norm_eps)
            chosen.append(out.reshape(-1, out.shape[-1]))
        return jnp.stack(kept), jnp.stack(chosen), jnp.stack(drops)
    kept, chosen, drops = run(jax.tree_util.tree_map(jnp.asarray, params),
                              jnp.asarray(tokens))
    E = cfg.num_experts
    return (np.asarray(kept[..., :E], np.float32) > 0,
            np.asarray(chosen[..., :E], np.float32) > 0, np.asarray(drops))


@torch.no_grad()
def _port(cfg, params, tokens):
    """As :func:`_reference`, on the port (the chosen experts are the
    router's top k, ``moe.capture_routing``); and each client's router
    probabilities (N, E) and per-expert assignment counts
    (``moe._route``)."""
    p = pt_model.cast_matrices(cfg, bridge.params_from_jax(params))
    t = torch.tensor(tokens)
    h, _ = pt_model._embed(cfg, {"embed": p["embed"]}, t)
    positions = torch.arange(SEQ)[None].expand(t.shape)
    cs = layers.rope_at(positions, cfg.head_dim_, cfg.rope_theta, SEQ)
    attn = {k[len("attn/"):]: v for k, v in p.items()
            if k.startswith("attn/")}
    h = h + layers.attn_apply(attn, h, cs, eps=cfg.norm_eps,
                              chunk=cfg.attn_chunk,
                              window=cfg.sliding_window,
                              cap=cfg.logit_softcap)
    expert = {k[len("moe/"):]: v for k, v in p.items()
              if k.startswith("moe/")}
    kw = dict(k=cfg.num_experts_per_tok, eps=cfg.norm_eps)
    kept, chosen, drops, probs, counts = [], [], [], [], []
    for c in range(CLIENTS):
        x = h[c * ROWS:(c + 1) * ROWS]
        with moe.capture_routing() as seen:
            out, aux = moe.moe_apply(expert, x, cf=cfg.moe_capacity_factor,
                                     **kw)
        kept.append(out.reshape(-1, out.shape[-1]))
        drops.append(aux["dropped_frac"])
        top_e, p_n = seen[0]
        chosen.append(F.one_hot(top_e, cfg.num_experts).sum(1) > 0)
        probs.append(p_n)
        counts.append(moe._route(expert, x, **kw)[3])
    return (torch.stack(kept)[..., :cfg.num_experts].float().numpy() > 0,
            torch.stack(chosen).numpy(), torch.stack(drops).numpy(),
            torch.stack(probs).numpy(), torch.stack(counts).numpy())


@torch.no_grad()
def _port_embedding_drops(cfg, params, tokens):
    """Each client's dropped_frac routed on its embeddings alone, the
    attention left out."""
    p = pt_model.cast_matrices(cfg, bridge.params_from_jax(params))
    h, _ = pt_model._embed(cfg, {"embed": p["embed"]}, torch.tensor(tokens))
    expert = {k[len("moe/"):]: v for k, v in p.items()
              if k.startswith("moe/")}
    return np.array([float(moe.moe_apply(
        expert, h[c * ROWS:(c + 1) * ROWS], k=cfg.num_experts_per_tok,
        cf=cfg.moe_capacity_factor, eps=cfg.norm_eps)[1]["dropped_frac"])
        for c in range(CLIENTS)])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_olmoe_routing_at_full_width_drops_what_the_reference_drops(dtype):
    """Per client (512 tokens, C 80), f32: the chosen experts (8 of 64 a
    token) and the kept ones equal the reference's exactly, and so do the
    per-expert assignment and drop counts and dropped_frac (a mean of
    0.1732 over the clients in both packages, 0.1450-0.2136 a client: the
    spec's own routing at initialisation, 0.0017 on the embeddings alone).
    bf16: the packages round the
    attention's and the norm's steps at different places (XLA-CPU rounds
    each step to bf16), so a token whose top 8 end in a near tie may choose
    otherwise: every token that does is one, its swapped experts' router
    probabilities within 2e-2 of each other (tests/test_torch_moe.py's
    bar), and each client's drop count moves by at most its assignments
    that differ. The port's router counts equal its chosen experts'."""
    jcfg, pcfg = _configs(dtype)
    tokens, vocab = _tokens(pcfg)
    params = _params(jcfg, vocab)
    k, N = pcfg.num_experts_per_tok, ROWS * SEQ
    assert moe.capacity(pcfg, N) == jax_moe._capacity(
        N, jcfg.num_experts, k, jcfg.moe_capacity_factor) == 80
    want_kept, want_chosen, want_drops = _reference(jcfg, params, tokens)
    kept, chosen, drops, probs, counts = _port(pcfg, params, tokens)
    for c, w in ((chosen, "port"), (want_chosen, "reference")):
        assert (c.sum(-1) == k).all(), w
    assert (kept <= chosen).all() and (want_kept <= want_chosen).all()
    np.testing.assert_array_equal(counts, chosen.sum(1))
    dropped = chosen.sum(1) - kept.sum(1)                   # (clients, E)
    assert (dropped.sum(-1) == np.round(drops * N * k)).all()
    assert (chosen.sum(1) - dropped <= 80).all()
    want_dropped = want_chosen.sum(1) - want_kept.sum(1)
    moved = (chosen != want_chosen).sum((1, 2))             # a client
    print(f"olmoe-1b-7b layer at full width, {dtype}: dropped_frac a client "
          f"port {[round(float(x), 4) for x in drops]} (mean "
          f"{drops.mean():.4f}), reference "
          f"{[round(float(x), 4) for x in want_drops]} (mean "
          f"{want_drops.mean():.4f}); tokens choosing otherwise "
          f"{int((chosen != want_chosen).any(-1).sum())} of "
          f"{chosen.shape[0] * chosen.shape[1]}")
    if dtype == "float32":
        np.testing.assert_array_equal(chosen, want_chosen)
        np.testing.assert_array_equal(kept, want_kept)
        np.testing.assert_array_equal(dropped, want_dropped)
        np.testing.assert_array_equal(drops, want_drops)
        # why so many drop: at initialisation the attention's output (the
        # v's averaged over each causal prefix, alike along a row)
        # outweighs the token's own embedding (rms d^-1/2), so a row's
        # tokens route alike; on the embeddings alone almost none drop.
        # The readings print under pytest -s
        alone = _port_embedding_drops(pcfg, params, tokens)
        print(f"routed on the embeddings alone: dropped_frac mean "
              f"{alone.mean():.4f}")
        assert drops.mean() > 0.1 and alone.mean() < 0.01, (drops, alone)
        return
    for c, n in zip(*np.nonzero((chosen != want_chosen).any(-1))):
        a = np.flatnonzero(chosen[c, n] & ~want_chosen[c, n])
        b = np.flatnonzero(want_chosen[c, n] & ~chosen[c, n])
        gap = np.abs(probs[c, n, a][:, None] - probs[c, n, b][None]).min()
        assert gap < 2e-2, (c, n, a, b, gap)
    assert (np.abs(dropped.sum(-1) - want_dropped.sum(-1)) <= moved).all()
