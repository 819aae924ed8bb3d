"""Deterministic synthetic token pipeline (counterpart of
src/repro/data/pipeline.py). ``_batch_np`` is a copy of the reference's pure
numpy generator, so both packages see the same batches bit for bit:
deterministic in (seed, step), one host slice per host, and per-client
heterogeneity (client i draws from a shifted token range)."""
from __future__ import annotations

import dataclasses
from typing import Dict

import numpy as np
import torch


# the frontend prefix's padding (the reference's DESIGN.md §5): the
# modality-frontend archs (musicgen, internvl2) carry precomputed frame or
# patch embeddings before the tokens. Training pads the prefix to at least
# PREFIX_PAD_MIN tokens; serving pads to the production alignment
# PREFIX_PAD_SPEC, as the reference's Session.serve does.
PREFIX_PAD_MIN = 8
PREFIX_PAD_SPEC = 64


def prefix_token_count(cfg, pad_to: int = PREFIX_PAD_MIN) -> int:
    """Number of prefix-embedding tokens a batch for ``cfg`` carries: 0 for
    an arch without a modality frontend, else its ``frontend_tokens``
    padded up to ``pad_to``."""
    if cfg.frontend is None:
        return 0
    return max(cfg.frontend_tokens, pad_to)


def with_prefix_embeds(cfg, batch: Dict[str, torch.Tensor],
                       pad_to: int = PREFIX_PAD_MIN
                       ) -> Dict[str, torch.Tensor]:
    """``batch`` with the zero bf16 ``prefix_embeds`` stub (B, n, d_model)
    added on the tokens' device when ``cfg`` has a modality frontend, n
    ``prefix_token_count(cfg, pad_to)``; ``batch`` itself otherwise."""
    n = prefix_token_count(cfg, pad_to)
    if n == 0:
        return batch
    tokens = batch["tokens"]
    return dict(batch, prefix_embeds=torch.zeros(
        (tokens.shape[0], n, cfg.d_model), dtype=torch.bfloat16,
        device=tokens.device))


@dataclasses.dataclass(frozen=True)
class DataConfig:
    vocab_size: int
    seq_len: int
    global_batch: int
    seed: int = 0
    hosts: int = 1
    host_id: int = 0
    dp_groups: int = 1            # number of EF clients
    heterogeneity: float = 0.5    # 0 = iid clients, 1 = disjoint token ranges


def _batch_np(cfg: DataConfig, step: int) -> Dict[str, np.ndarray]:
    B, S, V = cfg.global_batch, cfg.seq_len, cfg.vocab_size
    lo = B * cfg.host_id // cfg.hosts
    hi = B * (cfg.host_id + 1) // cfg.hosts
    rng = np.random.RandomState((cfg.seed * 1_000_003 + step) % (2 ** 31))
    rows = np.arange(B)
    group = rows * cfg.dp_groups // B                       # client id per row
    width = max(16, int(V * (1.0 - cfg.heterogeneity * (1 - 1 / cfg.dp_groups))))
    base = (group * (V - width) // max(cfg.dp_groups - 1, 1)).astype(np.int64)
    toks = np.empty((B, S + 1), np.int64)
    toks[:, 0] = rng.randint(0, width, size=B)
    a, c = 31, 17
    noise = rng.randint(0, 3, size=(B, S))
    for t in range(S):
        toks[:, t + 1] = (toks[:, t] * a + c + noise[:, t]) % width
    toks = (toks + base[:, None])[lo:hi]
    return {"tokens": toks[:, :-1].astype(np.int32),
            "labels": toks[:, 1:].astype(np.int32)}


class SyntheticTokens:
    """Stateless-addressable: ``pipeline.batch(step, device)`` for any step."""

    def __init__(self, cfg: DataConfig):
        self.cfg = cfg

    def batch(self, step: int, device="cpu") -> Dict[str, torch.Tensor]:
        return {k: torch.from_numpy(v).to(device)
                for k, v in _batch_np(self.cfg, step).items()}
