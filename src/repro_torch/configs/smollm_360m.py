"""smollm-360m — small llama-arch dense LM [hf:HuggingFaceTB/SmolLM-135M]."""
import dataclasses

from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="smollm-360m", family="dense", citation="hf:HuggingFaceTB/SmolLM-135M",
    num_layers=32, d_model=960, num_heads=15, num_kv_heads=5, d_ff=2560,
    vocab_size=49152,
)


def smoke_config() -> ArchConfig:
    return dataclasses.replace(
        CONFIG, num_layers=2, d_model=192, num_heads=3, num_kv_heads=1,
        d_ff=512, vocab_size=256, remat=False, attn_chunk=64)
