"""Model configuration schema (subset of ``repro.configs.base``).

A copy of the fields every family of the reference reads (dense, moe,
ssm, hybrid, vlm and audio), serving and training, with the same names
and defaults so a config reads the same in both packages.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Optional


def pad_to_multiple(x: int, multiple: int) -> int:
    return int(math.ceil(x / multiple) * multiple)


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    num_experts: int = 0
    top_k: int = 2
    expert_d_ff: int = 0          # d_ff of each expert MLP
    capacity_factor: float = 1.25  # dispatch capacity = ceil(topk*T/E * cf)
    router_jitter: float = 0.0
    aux_loss_weight: float = 0.01


@dataclasses.dataclass(frozen=True)
class SSMConfig:
    d_state: int = 128
    head_dim: int = 64            # SSD head dim (P)
    expand: int = 2               # d_inner = expand * d_model
    conv_kernel: int = 4
    chunk_size: int = 256         # SSD chunk length (the matmul-rich block)
    dt_min: float = 1e-3
    dt_max: float = 1e-1
    ngroups: int = 1


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    arch_id: str
    family: str                   # dense | moe | ssm | hybrid | audio | vlm
    n_layers: int
    d_model: int
    n_heads: int                  # query heads (0 for attention-free)
    n_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0             # 0 -> d_model // n_heads
    qk_norm: bool = False
    rope_theta: float = 1e4
    attn_logit_softcap: float = 0.0
    moe: Optional[MoEConfig] = None
    ssm: Optional[SSMConfig] = None
    # hybrid (Jamba): within each period of `attn_period` layers, layer index
    # `attn_offset` is attention, the rest are Mamba; a layer uses MoE when
    # (layer_idx % moe_period) == moe_offset.
    attn_period: int = 0
    attn_offset: int = 0
    moe_period: int = 0
    moe_offset: int = 1
    # vlm: every `cross_attn_period`-th layer is a cross-attention layer
    cross_attn_period: int = 0
    num_image_tokens: int = 1601         # stub patch-embedding length
    # audio enc-dec
    n_encoder_layers: int = 0
    n_audio_ctx: int = 1500              # stub frame-embedding length
    mlp_type: str = "swiglu"             # swiglu | gelu
    param_dtype: str = "bfloat16"
    compute_dtype: str = "bfloat16"
    norm_eps: float = 1e-5
    tie_embeddings: bool = False
    attention_impl: str = "reference"    # reference (jnp flash port) | pallas (CUDA kernel)
    remat: str = "full"                  # none | full
    vocab_pad_multiple: int = 256
    notes: str = ""

    @property
    def resolved_head_dim(self) -> int:
        if self.head_dim:
            return self.head_dim
        return self.d_model // max(self.n_heads, 1)

    @property
    def padded_vocab(self) -> int:
        return pad_to_multiple(self.vocab_size, self.vocab_pad_multiple)

    @property
    def is_encdec(self) -> bool:
        return self.n_encoder_layers > 0

    def layer_kind(self, layer_idx: int) -> str:
        """Return 'attn' | 'mamba' for hybrid stacks."""
        if self.family != "hybrid":
            return "mamba" if self.family == "ssm" else "attn"
        return ("attn" if (layer_idx % self.attn_period) == self.attn_offset
                else "mamba")

    def layer_uses_moe(self, layer_idx: int) -> bool:
        if self.moe is None:
            return False
        if self.moe_period <= 0:
            return True
        return (layer_idx % self.moe_period) == self.moe_offset
