"""granite-34b — llama-arch code model, GQA with a single KV head (MQA)
[arXiv:2405.04324]."""
import dataclasses

from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="granite-34b", family="dense", citation="arXiv:2405.04324",
    num_layers=88, d_model=6144, num_heads=48, num_kv_heads=1, d_ff=24576,
    vocab_size=49152,
)


def smoke_config() -> ArchConfig:
    return dataclasses.replace(
        CONFIG, num_layers=2, d_model=256, num_heads=4, num_kv_heads=1,
        d_ff=512, vocab_size=256, remat=False, attn_chunk=64)
