"""Architecture configuration: the reference's ``ArchConfig`` fields for the
families this port runs (a copy, not an import) and the registry of its
archs: the four dense configs (smollm-360m, h2o-danube-3-4b, granite-34b
and gemma2-9b), with sliding windows, gemma2's [local, global] layers,
soft caps and block recompute (``remat``); the modality frontends
(musicgen-medium's audio and internvl2-76b's vision stubs); the
mixture-of-experts configs (olmoe-1b-7b, grok-1-314b); and the SSM
families: falcon-mamba-7b's Mamba1 (``ssm``) and zamba2-1.2b's Mamba2
with one shared attention block (``hybrid``). Every arch of the
reference's registry is here."""
from __future__ import annotations

import dataclasses
import importlib
from typing import Optional, Tuple

import torch


@dataclasses.dataclass(frozen=True)
class ArchConfig:
    name: str
    family: str                      # dense | audio | vlm | moe | ssm | hybrid
    citation: str

    num_layers: int = 12
    d_model: int = 1024
    num_heads: int = 8
    num_kv_heads: int = 8
    head_dim: Optional[int] = None   # default d_model // num_heads
    d_ff: int = 4096
    vocab_size: int = 32000

    # attention flavour
    sliding_window: Optional[int] = None     # SWA width (h2o-danube, gemma2 local)
    local_global: bool = False               # gemma2: alternate local/global layers
    logit_softcap: Optional[float] = None    # gemma2 attn softcap
    final_softcap: Optional[float] = None    # gemma2 final-logit softcap
    rope_theta: float = 10000.0

    # MoE
    num_experts: int = 0
    num_experts_per_tok: int = 0
    moe_capacity_factor: float = 1.25
    moe_impl: str = "dispatch"        # 'dispatch' | 'dense' (models/moe.py)

    # SSM
    ssm_variant: Optional[str] = None        # 'mamba1' | 'mamba2'
    ssm_state: int = 0
    ssm_expand: int = 2
    ssm_conv: int = 4
    ssm_head_dim: int = 64                   # mamba2 head size
    ssm_dt_rank: Optional[int] = None        # mamba1: default ceil(d_model/16)

    # hybrid (zamba2): one SHARED attention block applied every k SSM layers
    hybrid_attn_every: int = 0

    # modality frontend stub: None | 'audio' | 'vision'
    frontend: Optional[str] = None
    frontend_tokens: int = 0                 # vision: patch embeddings prepended

    # head padding for the 'model' axis: when the heads do not divide it,
    # pad the q heads to a multiple of ``tp_pad_heads`` and MHA-expand kv
    # (each kv head copied under its query group); padded q heads get zero
    # wk/wv/wo, so the layer computes exactly the unpadded function, and
    # attention splits over the axis instead of being replicated. 0 = off.
    tp_pad_heads: int = 0

    # numerics / memory
    dtype: str = "bfloat16"          # activation dtype
    param_dtype: str = "float32"
    norm_eps: float = 1e-6
    remat: bool = True               # recompute each block in the backward
    attn_chunk: int = 512            # chunked-attention query block

    @property
    def head_dim_(self) -> int:
        if self.head_dim is not None:
            return self.head_dim
        return self.d_model // self.num_heads if self.num_heads else 0

    @property
    def eff_heads(self) -> Tuple[int, int]:
        """(H_eff, KV_eff) after the optional head padding (MHA-expand)."""
        H, KV = self.num_heads, self.num_kv_heads
        t = self.tp_pad_heads
        if not t or H == 0 or (H % t == 0 and KV % t == 0):
            return H, KV
        Hp = -(-H // t) * t
        return Hp, Hp

    @property
    def d_inner(self) -> int:
        return self.ssm_expand * self.d_model

    @property
    def dt_rank(self) -> int:
        return self.ssm_dt_rank if self.ssm_dt_rank is not None \
            else -(-self.d_model // 16)

    @property
    def activation_dtype(self) -> torch.dtype:
        return getattr(torch, self.dtype)

    @property
    def parameter_dtype(self) -> torch.dtype:
        return getattr(torch, self.param_dtype)


@dataclasses.dataclass(frozen=True)
class InputShape:
    name: str
    seq_len: int
    global_batch: int
    kind: str          # 'train' | 'prefill' | 'decode'


# the reference's named production shapes (RunSpec.shape names one; its
# batch must divide by the spec's clients, and the dry run lowers it)
INPUT_SHAPES = {
    "train_4k": InputShape("train_4k", 4_096, 256, "train"),
    "prefill_32k": InputShape("prefill_32k", 32_768, 32, "prefill"),
    "decode_32k": InputShape("decode_32k", 32_768, 128, "decode"),
    "long_500k": InputShape("long_500k", 524_288, 1, "decode"),
}


# public --arch ids → module names
ARCH_ALIASES = {"smollm-360m": "smollm_360m",
                "h2o-danube-3-4b": "h2o_danube3_4b",
                "granite-34b": "granite_34b", "gemma2-9b": "gemma2_9b",
                "musicgen-medium": "musicgen_medium",
                "internvl2-76b": "internvl2_76b",
                "olmoe-1b-7b": "olmoe_1b_7b", "grok-1-314b": "grok1_314b",
                "falcon-mamba-7b": "falcon_mamba_7b",
                "zamba2-1.2b": "zamba2_1p2b"}


def _module(arch: str):
    if arch not in ARCH_ALIASES:
        raise NotImplementedError(
            f"unknown arch {arch!r} (this port runs {sorted(ARCH_ALIASES)})")
    return importlib.import_module(
        f"repro_torch.configs.{ARCH_ALIASES[arch]}")


def get(arch: str) -> ArchConfig:
    return _module(arch).CONFIG


def get_smoke(arch: str) -> ArchConfig:
    return _module(arch).smoke_config()
