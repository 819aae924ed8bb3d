"""Dense-family model (counterpart of src/repro/models/model.py): parameter
init and the training loss.

Parameters are a flat dict keyed by the reference's ``/``-joined leaf paths,
with each layer's weights STACKED on a leading (num_layers, ...) axis under
the reference's leaf names (``layers/attn/wq``, ``layers/mlp/w_up``, …).
Every EF leaf's size sets its Block-TopK geometry and its wire, so
per-layer leaves would change the algorithm.
"""
from __future__ import annotations

from typing import Dict

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ArchConfig
from repro_torch.models import layers as L

CE_CHUNK = 256          # sequence chunk of the cross-entropy


def init_params(cfg: ArchConfig, generator: torch.Generator,
                device="cpu") -> Dict[str, torch.Tensor]:
    """Random parameters drawn from ``generator`` (a CPU generator, so the
    same seed gives the same numbers on every device), moved to ``device``.
    The reference draws from jax.random, so parity runs load its numbers
    through checkpoint/bridge.py instead."""
    if cfg.family != "dense":
        raise NotImplementedError(f"model family {cfg.family!r} arrives with "
                                  "a later slice")
    dt = cfg.parameter_dtype
    d, hd, ff, n = cfg.d_model, cfg.head_dim_, cfg.d_ff, cfg.num_layers
    H, KV = cfg.num_heads, cfg.num_kv_heads

    def normal(*shape, std):
        return (torch.randn(*shape, generator=generator) * std).to(dt)

    params = {
        "embed": normal(cfg.vocab_size, d, std=d ** -0.5),
        "final_norm": torch.zeros(d, dtype=dt),
        "layers/attn/norm": torch.zeros(n, d, dtype=dt),
        "layers/attn/wk": normal(n, d, KV, hd, std=d ** -0.5),
        "layers/attn/wo": normal(n, H, hd, d, std=(H * hd) ** -0.5),
        "layers/attn/wq": normal(n, d, H, hd, std=d ** -0.5),
        "layers/attn/wv": normal(n, d, KV, hd, std=d ** -0.5),
        "layers/mlp/norm": torch.zeros(n, d, dtype=dt),
        "layers/mlp/w_down": normal(n, ff, d, std=ff ** -0.5),
        "layers/mlp/w_gate": normal(n, d, ff, std=d ** -0.5),
        "layers/mlp/w_up": normal(n, d, ff, std=d ** -0.5),
    }
    return {k: params[k].to(device) for k in sorted(params)}


def train_loss(cfg: ArchConfig, params: Dict[str, torch.Tensor],
               batch: Dict[str, torch.Tensor]) -> torch.Tensor:
    """Mean next-token cross-entropy. batch: tokens (B,S), labels (B,S)."""
    tokens, labels = batch["tokens"].long(), batch["labels"].long()
    B, S = tokens.shape
    h = F.embedding(tokens, params["embed"]).to(cfg.activation_dtype)
    positions = torch.arange(S, device=h.device)[None].expand(B, S)
    # one unbind per stacked leaf: its backward is a single stack
    per_layer = {k[len("layers/"):]: params[k].unbind(0)
                 for k in params if k.startswith("layers/")}
    for i in range(cfg.num_layers):
        attn = {k[len("attn/"):]: v[i] for k, v in per_layer.items()
                if k.startswith("attn/")}
        mlp = {k[len("mlp/"):]: v[i] for k, v in per_layer.items()
               if k.startswith("mlp/")}
        h = h + L.attn_apply(attn, h, positions, rope_theta=cfg.rope_theta,
                             eps=cfg.norm_eps, chunk=cfg.attn_chunk)
        h = h + L.mlp_apply(mlp, h, cfg.norm_eps)
    h = L.rms_norm(h, params["final_norm"], cfg.norm_eps)

    # chunked cross-entropy: never materialize (B, S, V) in full
    embed = params["embed"].to(h.dtype)
    total = torch.zeros((), dtype=torch.float32, device=h.device)
    for start in range(0, S, CE_CHUNK):
        hc = h[:, start:start + CE_CHUNK]
        lc = labels[:, start:start + CE_CHUNK]
        lg = torch.einsum("bsd,vd->bsv", hc, embed).float()
        gold = torch.gather(lg, -1, lc[..., None])[..., 0]
        total = total + (torch.logsumexp(lg, dim=-1) - gold).sum()
    return total / (B * S)
