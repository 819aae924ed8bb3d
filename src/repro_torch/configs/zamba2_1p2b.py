"""zamba2-1.2b — Mamba2 backbone with a SHARED attention block applied every 6
SSM layers [arXiv:2411.15242]."""
import dataclasses

from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="zamba2-1.2b", family="hybrid", citation="arXiv:2411.15242",
    num_layers=38, d_model=2048, num_heads=32, num_kv_heads=32, d_ff=8192,
    vocab_size=32000, ssm_variant="mamba2", ssm_state=64, ssm_expand=2,
    ssm_head_dim=64, hybrid_attn_every=6,
    # long-context serving config gives the shared attention block a 4k window
    sliding_window=None,
)


def smoke_config() -> ArchConfig:
    return dataclasses.replace(
        CONFIG, num_layers=4, d_model=128, num_heads=4, num_kv_heads=4,
        d_ff=256, vocab_size=256, ssm_state=16, ssm_head_dim=32,
        hybrid_attn_every=2, remat=False, attn_chunk=64)
