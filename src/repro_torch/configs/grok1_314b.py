"""grok-1-314b — 8-expert top-2 MoE, 314B total [hf:xai-org/grok-1]."""
import dataclasses

from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="grok-1-314b", family="moe", citation="hf:xai-org/grok-1",
    num_layers=64, d_model=6144, num_heads=48, num_kv_heads=8, d_ff=32768,
    vocab_size=131072, num_experts=8, num_experts_per_tok=2,
)


def smoke_config() -> ArchConfig:
    return dataclasses.replace(
        CONFIG, num_layers=2, d_model=128, num_heads=4, num_kv_heads=2,
        d_ff=256, vocab_size=256, num_experts=4, num_experts_per_tok=2,
        remat=False, attn_chunk=64)
