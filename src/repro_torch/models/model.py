"""The attention families' model (counterpart of src/repro/models/model.py):
parameter init, the training loss, and serving's KV cache, prefill and
decode step, for the dense family, the modality frontends (audio, vlm) and
mixture-of-experts (moe).

Parameters are a flat dict keyed by the reference's ``/``-joined leaf paths,
with each layer's weights STACKED on a leading (num_layers, ...) axis under
the reference's leaf names (``layers/attn/wq``, ``layers/mlp/w_up``, …).
Every EF leaf's size sets its Block-TopK geometry and its wire, so
per-layer leaves would change the algorithm. gemma2's [local, global]
super-layers read the same stacked leaves: layer 2i is local (the sliding
window), layer 2i+1 global. Training recomputes each block (a super-layer
under ``local_global``) in the backward when ``cfg.remat`` is set
(models/remat.py), as the reference checkpoints each scanned body, and
each cross-entropy chunk too: under ``torch.func`` the f32 logits would
otherwise live until the whole pass returns.

The frontends are STUBS, as in the reference: the batch carries zero
precomputed ``prefix_embeds`` (B, P, d_model) (data/pipeline.py), which
``frontend_proj`` projects and the tokens follow; the loss counts the
token positions only. An MoE block runs models/moe.py in place of the
MLP, its aux values summed over the layers in layer order; an MoE loss
adds 0.01 of the load-balance sum and 0.001 of the router-z sum.
"""
from __future__ import annotations

import functools
from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ArchConfig
from repro_torch.models import layers as L
from repro_torch.models import moe as moe_lib
from repro_torch.models import remat as remat_lib

CE_CHUNK = 256          # sequence chunk of the cross-entropy
FAMILIES = ("dense", "audio", "vlm", "moe")
LB_COEF, Z_COEF = 0.01, 0.001   # an MoE loss's load-balance and z weights


def _check_family(cfg: ArchConfig) -> None:
    if cfg.family not in FAMILIES:
        raise NotImplementedError(f"model family {cfg.family!r} arrives with "
                                  "a later slice")


def init_params(cfg: ArchConfig, generator: torch.Generator,
                device="cpu") -> Dict[str, torch.Tensor]:
    """Random parameters drawn from ``generator`` (a CPU generator, so the
    same seed gives the same numbers on every device), moved to ``device``.
    The reference draws from jax.random, so parity runs load its numbers
    from its checkpoints instead. ``generator=None`` with ``device="meta"``
    gives the tree's shapes and dtypes alone, drawing nothing (a restore
    template)."""
    _check_family(cfg)
    dt = cfg.parameter_dtype
    d, hd, ff, n = cfg.d_model, cfg.head_dim_, cfg.d_ff, cfg.num_layers
    H, KV = cfg.num_heads, cfg.num_kv_heads

    def normal(*shape, std, dtype=dt):
        if generator is None:
            return torch.empty(*shape, dtype=dtype, device="meta")
        return (torch.randn(*shape, generator=generator) * std).to(dtype)

    params = {
        "embed": normal(cfg.vocab_size, d, std=d ** -0.5),
        "final_norm": torch.zeros(d, dtype=dt),
        "layers/attn/norm": torch.zeros(n, d, dtype=dt),
        "layers/attn/wk": normal(n, d, KV, hd, std=d ** -0.5),
        "layers/attn/wo": normal(n, H, hd, d, std=(H * hd) ** -0.5),
        "layers/attn/wq": normal(n, d, H, hd, std=d ** -0.5),
        "layers/attn/wv": normal(n, d, KV, hd, std=d ** -0.5),
    }
    if cfg.family == "moe":
        params.update({"layers/moe/" + k: t for k, t in moe_lib.moe_init(
            normal, d, ff, cfg.num_experts, n, dt).items()})
    else:
        params.update({
            "layers/mlp/norm": torch.zeros(n, d, dtype=dt),
            "layers/mlp/w_down": normal(n, ff, d, std=ff ** -0.5),
            "layers/mlp/w_gate": normal(n, d, ff, std=d ** -0.5),
            "layers/mlp/w_up": normal(n, d, ff, std=d ** -0.5)})
    if cfg.frontend is not None:
        params["frontend_proj"] = normal(d, d, std=d ** -0.5)
    return {k: params[k].to(device) for k in sorted(params)}


def cast_matrices(cfg: ArchConfig, params: Dict[str, torch.Tensor]
                  ) -> Dict[str, torch.Tensor]:
    """``params`` with every matrix leaf (the embedding, the attention, MLP
    and expert weights, the frontend's projection) cast to the activation
    dtype; the norm scales kept (``rms_norm`` reads them in f32), and the
    MoE router kept in f32, which routing multiplies in. The model uses
    each matrix in the
    activation dtype, and a cast commutes with the embedding's gather and
    with the slice of a stacked leaf, so this tree gives the same numbers
    as ``params`` without a cast a call: serving runs it, cast once per
    params version. A leaf already in that dtype is not copied."""
    act = cfg.activation_dtype
    return {k: t if k.endswith(("norm", "moe/router")) else t.to(act)
            for k, t in params.items()}


def _embed(cfg: ArchConfig, params: Dict[str, torch.Tensor],
           tokens: torch.Tensor, prefix_embeds: Optional[torch.Tensor] = None
           ) -> Tuple[torch.Tensor, int]:
    """The tokens' embeddings (gemma's scale on them alone), after the
    prefix projected through ``frontend_proj`` in the activation dtype when
    ``prefix_embeds`` (B, P, d) is given; and P, the prefix's length."""
    adt = cfg.activation_dtype
    h = F.embedding(tokens.long(), params["embed"]).to(adt)
    if cfg.name.startswith("gemma"):
        # sqrt(d_model) rounded to the activation dtype first, as the
        # reference's jnp.asarray(..., adt): 59.75 in bf16 at d 3584
        h = h * torch.tensor(cfg.d_model ** 0.5, dtype=adt, device=h.device)
    if prefix_embeds is None:
        return h, 0
    pe = torch.einsum("bpd,de->bpe", prefix_embeds.to(adt),
                      params["frontend_proj"].to(adt))
    return torch.cat([pe, h], dim=1), prefix_embeds.shape[1]


def layer_window(cfg: ArchConfig, i: int) -> Optional[int]:
    """Layer i's sliding window: every layer's under a window, the even
    (local) layers' only under ``local_global``."""
    if cfg.local_global and i % 2:
        return None
    return cfg.sliding_window


def flash_layers(cfg: ArchConfig) -> int:
    """The layers whose prefill runs K7 (``layers.prefill_runs_flash``):
    K7's launches a prefill."""
    return sum(L.prefill_runs_flash(cfg.head_dim_, layer_window(cfg, i),
                                    cfg.logit_softcap)
               for i in range(cfg.num_layers))


def _layer_cache(cfg: ArchConfig, cache: Dict[str, torch.Tensor], i: int):
    if not cfg.local_global:
        return cache["k"][i], cache["v"][i]
    kind = "global" if i % 2 else "local"
    return cache[f"k_{kind}"][i // 2], cache[f"v_{kind}"][i // 2]


def _run_stack(cfg: ArchConfig, params: Dict[str, torch.Tensor],
               h: torch.Tensor, positions: torch.Tensor,
               cache: Optional[Dict[str, torch.Tensor]] = None,
               pos: Optional[int] = None, train: bool = False
               ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """The layers, one after another, for training (no cache), prefill
    (cache, no ``pos``) and decode (cache and ``pos``); see
    ``layers.attn_apply``. Returns h and the aux values (models/moe.py)
    summed over the layers in layer order, zeros without MoE. The cache is
    written in place. RoPE's cos and sin are gathered once for all layers
    from the cached tables; positions run below S, or up to ``pos`` in
    decode. With ``train`` and ``cfg.remat`` each block (a [local, global]
    pair under ``local_global``) is recomputed in the backward, its aux
    values leaving the block beside h."""
    length = h.shape[1] if pos is None else pos + 1
    cos, sin = L.rope_at(positions, cfg.head_dim_, cfg.rope_theta, length)
    # one unbind per stacked leaf: its backward is a single stack
    names = sorted(k[len("layers/"):] for k in params
                   if k.startswith("layers/"))
    per_layer = {n: params["layers/" + n].unbind(0) for n in names}
    moe_fn = None
    if cfg.family == "moe":
        moe_fn = functools.partial(
            moe_lib.moe_apply_dense if cfg.moe_impl == "dense"
            else moe_lib.moe_apply, k=cfg.num_experts_per_tok,
            cf=cfg.moe_capacity_factor, eps=cfg.norm_eps)

    def sub(p, prefix):
        return {n[len(prefix):]: t for n, t in p.items()
                if n.startswith(prefix)}

    def block(first: int, h: torch.Tensor, *flat: torch.Tensor):
        """(h after the group's layers, then each MoE layer's aux values
        in ``AUX_KEYS`` order)."""
        *leaves, cos, sin = flat
        aux = []
        for j in range(len(leaves) // len(names)):
            i = first + j
            p = dict(zip(names, leaves[j * len(names):]))
            h = h + L.attn_apply(
                sub(p, "attn/"), h, (cos, sin), eps=cfg.norm_eps,
                chunk=cfg.attn_chunk, window=layer_window(cfg, i),
                cap=cfg.logit_softcap,
                cache=None if cache is None else _layer_cache(cfg, cache, i),
                pos=pos)
            if moe_fn is None:
                h = h + L.mlp_apply(sub(p, "mlp/"), h, cfg.norm_eps)
            else:
                delta, a = moe_fn(sub(p, "moe/"), h)
                h = h + delta
                aux.extend(a[k] for k in moe_lib.AUX_KEYS)
        return (h, *aux)

    total = {k: torch.zeros((), device=h.device) for k in moe_lib.AUX_KEYS}
    group = 2 if cfg.local_global else 1
    for first in range(0, cfg.num_layers, group):
        leaves = [per_layer[n][i] for i in range(first, first + group)
                  for n in names]
        fn = functools.partial(block, first)
        if train and cfg.remat:
            h, *aux = remat_lib.checkpoint(fn, (h, *leaves), (cos, sin))
        else:
            h, *aux = fn(h, *leaves, cos, sin)
        for j, a in enumerate(aux):
            key = moe_lib.AUX_KEYS[j % len(moe_lib.AUX_KEYS)]
            total[key] = total[key] + a
    return h, total


def _logits(cfg: ArchConfig, embed: torch.Tensor, h: torch.Tensor
            ) -> torch.Tensor:
    """f32 logits through the tied embedding, already cast to h's dtype,
    soft-capped by ``cfg.final_softcap``."""
    lg = torch.einsum("bsd,vd->bsv", h, embed).float()
    return L.softcap(lg, cfg.final_softcap)


def train_loss(cfg: ArchConfig, params: Dict[str, torch.Tensor],
               batch: Dict[str, torch.Tensor]
               ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """(mean next-token cross-entropy over the token positions, plus the
    MoE aux losses under MoE; the aux values summed over the layers).
    batch: tokens (B,S), labels (B,S), optional prefix_embeds (B,P,d)."""
    tokens, labels = batch["tokens"], batch["labels"].long()
    B, S = tokens.shape
    h, n_prefix = _embed(cfg, params, tokens, batch.get("prefix_embeds"))
    T = h.shape[1]
    positions = torch.arange(T, device=h.device)[None].expand(B, T)
    h, aux = _run_stack(cfg, params, h, positions, train=True)
    h = L.rms_norm(h, params["final_norm"], cfg.norm_eps)[:, n_prefix:]

    # chunked cross-entropy: never materialize (B, S, V) in full; under
    # recompute a chunk's f32 logits live only in its forward and backward
    def ce_sum(embed, hc, lc):
        lg = _logits(cfg, embed, hc)
        gold = torch.gather(lg, -1, lc[..., None])[..., 0]
        return (torch.logsumexp(lg, dim=-1) - gold).sum()

    embed = params["embed"].to(h.dtype)
    total = torch.zeros((), dtype=torch.float32, device=h.device)
    for start in range(0, S, CE_CHUNK):
        hc = h[:, start:start + CE_CHUNK]
        lc = labels[:, start:start + CE_CHUNK]
        if cfg.remat:
            total = total + remat_lib.checkpoint(ce_sum, (embed, hc), (lc,))
        else:
            total = total + ce_sum(embed, hc, lc)
    loss = total / (B * S)
    if cfg.family == "moe":
        loss = loss + LB_COEF * aux["load_balance"] + \
            Z_COEF * aux["router_z"]
    return loss, aux


def init_cache(cfg: ArchConfig, batch_size: int, max_seq: int,
               dtype: torch.dtype = torch.bfloat16, device="cpu"
               ) -> Dict[str, torch.Tensor]:
    """Zero KV cache of the attention families, bfloat16 by default as in the
    reference: k and v (L, B, S, KV, hd), S = min(max_seq, window) under a
    sliding window; under ``local_global`` the local layers' ring
    (k_local, v_local: L/2 x min(max_seq, window) slots) and the global
    layers' full cache (k_global, v_global: L/2 x max_seq). Separate
    tensors, since the port writes them in place."""
    _check_family(cfg)
    KV, hd = cfg.num_kv_heads, cfg.head_dim_
    ring = min(max_seq, cfg.sliding_window) if cfg.sliding_window \
        else max_seq

    def zeros(n, S):
        return torch.zeros((n, batch_size, S, KV, hd), dtype=dtype,
                           device=device)
    if cfg.local_global:
        n2 = cfg.num_layers // 2
        return {"k_local": zeros(n2, ring), "v_local": zeros(n2, ring),
                "k_global": zeros(n2, max_seq),
                "v_global": zeros(n2, max_seq)}
    return {"k": zeros(cfg.num_layers, ring),
            "v": zeros(cfg.num_layers, ring)}


@torch.no_grad()
def prefill(cfg: ArchConfig, params: Dict[str, torch.Tensor],
            batch: Dict[str, torch.Tensor], cache: Dict[str, torch.Tensor]
            ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Process the whole prompt; returns (last-token logits (B,1,V) f32,
    the cache with slots [0, S) filled, or a ring with the last positions
    under a window).

    ``batch["prefix_embeds"]`` (optional, (B, P, d)) goes before the tokens
    and fills the cache's first P slots. ``batch["prompt_lens"]``
    (optional, (B,) true lengths) takes each row's logits at its last REAL
    token, ``P + len - 1``, instead of the rightmost column: right padding
    (id 0, a legal token) never reaches the first generated token, since
    causal attention keeps that position blind to the padding after it."""
    h, n_prefix = _embed(cfg, params, batch["tokens"],
                         batch.get("prefix_embeds"))
    B, T = h.shape[:2]
    positions = torch.arange(T, device=h.device)[None].expand(B, T)
    h, _ = _run_stack(cfg, params, h, positions, cache=cache)
    h = L.rms_norm(h, params["final_norm"], cfg.norm_eps)
    lens = batch.get("prompt_lens")
    if lens is None:
        h_last = h[:, -1:]
    else:
        idx = n_prefix + lens.to(device=h.device, dtype=torch.long) - 1
        h_last = h[torch.arange(B, device=h.device), idx][:, None]
    return _logits(cfg, params["embed"].to(h.dtype), h_last), cache


def _decode_stack(cfg: ArchConfig, params: Dict[str, torch.Tensor],
                  h: torch.Tensor, pos: int, cache: Dict[str, torch.Tensor]
                  ) -> torch.Tensor:
    positions = torch.full((h.shape[0], 1), pos, device=h.device)
    return _run_stack(cfg, params, h, positions, cache=cache, pos=pos)[0]


@torch.no_grad()
def decode_step(cfg: ArchConfig, params: Dict[str, torch.Tensor],
                cache: Dict[str, torch.Tensor], tokens: torch.Tensor,
                pos: int) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """One decode step. tokens: (B,1); pos: the tokens' absolute position.
    Returns (logits (B,1,V) f32, the cache with slot ``pos`` written)."""
    h, _ = _embed(cfg, params, tokens)
    h = _decode_stack(cfg, params, h, pos, cache)
    h = L.rms_norm(h, params["final_norm"], cfg.norm_eps)
    return _logits(cfg, params["embed"].to(h.dtype), h), cache
