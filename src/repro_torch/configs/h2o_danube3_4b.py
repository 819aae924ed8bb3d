"""h2o-danube-3-4b — llama+mistral mix with sliding-window attention
[arXiv:2401.16818]."""
import dataclasses

from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="h2o-danube-3-4b", family="dense", citation="arXiv:2401.16818",
    num_layers=24, d_model=3840, num_heads=32, num_kv_heads=8, d_ff=10240,
    vocab_size=32000, sliding_window=4096,
)


def smoke_config() -> ArchConfig:
    return dataclasses.replace(
        CONFIG, num_layers=2, d_model=256, num_heads=4, num_kv_heads=2,
        d_ff=512, vocab_size=256, sliding_window=128, remat=False,
        attn_chunk=64)
