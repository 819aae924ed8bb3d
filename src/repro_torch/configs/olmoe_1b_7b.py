"""olmoe-1b-7b — 64-expert top-8 MoE, 1B active / 7B total [arXiv:2409.02060]."""
import dataclasses

from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="olmoe-1b-7b", family="moe", citation="arXiv:2409.02060",
    num_layers=16, d_model=2048, num_heads=16, num_kv_heads=16, d_ff=1024,
    vocab_size=50304, num_experts=64, num_experts_per_tok=8,
)


def smoke_config() -> ArchConfig:
    return dataclasses.replace(
        CONFIG, num_layers=2, d_model=128, num_heads=4, num_kv_heads=4,
        d_ff=64, vocab_size=256, num_experts=4, num_experts_per_tok=2,
        remat=False, attn_chunk=64)
