"""falcon-mamba-7b — pure Mamba1 LM, attention-free [arXiv:2410.05355]."""
import dataclasses

from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="falcon-mamba-7b", family="ssm", citation="arXiv:2410.05355",
    num_layers=64, d_model=4096, num_heads=0, num_kv_heads=0, d_ff=0,
    vocab_size=65024, ssm_variant="mamba1", ssm_state=16, ssm_expand=2,
)


def smoke_config() -> ArchConfig:
    return dataclasses.replace(
        CONFIG, num_layers=2, d_model=128, vocab_size=256, ssm_state=8,
        remat=False, attn_chunk=64)
