"""gemma2-9b — local(4k SWA)/global alternating attention + logit softcapping
[arXiv:2408.00118]."""
import dataclasses

from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="gemma2-9b", family="dense", citation="arXiv:2408.00118",
    num_layers=42, d_model=3584, num_heads=16, num_kv_heads=8, head_dim=256,
    d_ff=14336, vocab_size=256000, local_global=True, sliding_window=4096,
    logit_softcap=50.0, final_softcap=30.0,
)


def smoke_config() -> ArchConfig:
    return dataclasses.replace(
        CONFIG, num_layers=2, d_model=256, num_heads=4, num_kv_heads=2,
        head_dim=64, d_ff=512, vocab_size=512, sliding_window=128,
        remat=False, attn_chunk=64)
