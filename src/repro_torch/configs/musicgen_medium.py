"""musicgen-medium — decoder-only transformer over EnCodec audio tokens
[arXiv:2306.05284]. The EnCodec frontend is a STUB: the batch carries zero
precomputed frame-token embeddings (data/pipeline.py::with_prefix_embeds)."""
import dataclasses

from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="musicgen-medium", family="audio", citation="arXiv:2306.05284",
    num_layers=48, d_model=1536, num_heads=24, num_kv_heads=24, d_ff=6144,
    vocab_size=2048, frontend="audio",
)


def smoke_config() -> ArchConfig:
    return dataclasses.replace(
        CONFIG, num_layers=2, d_model=192, num_heads=3, num_kv_heads=3,
        d_ff=768, vocab_size=256, remat=False, attn_chunk=64)
