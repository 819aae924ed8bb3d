"""internvl2-76b — InternViT-6B vision encoder + InternLM2/Llama-70B-class LLM
[arXiv:2404.16821]. The vision tower is a STUB: the batch carries zero patch
embeddings, projected and prepended to the text sequence
(data/pipeline.py::with_prefix_embeds)."""
import dataclasses

from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="internvl2-76b", family="vlm", citation="arXiv:2404.16821",
    num_layers=80, d_model=8192, num_heads=64, num_kv_heads=8, d_ff=28672,
    vocab_size=128256, frontend="vision", frontend_tokens=256,
)


def smoke_config() -> ArchConfig:
    return dataclasses.replace(
        CONFIG, num_layers=2, d_model=256, num_heads=4, num_kv_heads=2,
        d_ff=512, vocab_size=256, frontend_tokens=16, remat=False,
        attn_chunk=64)
