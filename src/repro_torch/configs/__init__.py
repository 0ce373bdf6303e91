"""Config registry: ``get_config(arch_id)`` and ``reduced_config(arch_id)``.

The architectures of ``repro.configs`` this port runs; ``reduced_config``
makes the same tiny same-family config as the JAX package's
``reduced_config``, so both packages build identical shapes from one
arch id.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List

from repro_torch.configs import (grok_1_314b, granite_3_2b,
                                 jamba_v0_1_52b, llama_3_2_vision_90b,
                                 mamba2_780m, phi3_5_moe_42b,
                                 phi3_medium_14b, qwen3_1_7b, qwen3_4b,
                                 whisper_base)
from repro_torch.configs.base import ModelConfig, MoEConfig, SSMConfig

REGISTRY: Dict[str, ModelConfig] = {
    m.CONFIG.arch_id: m.CONFIG for m in (
        jamba_v0_1_52b, phi3_5_moe_42b, grok_1_314b, qwen3_4b,
        phi3_medium_14b, granite_3_2b, qwen3_1_7b, mamba2_780m,
        llama_3_2_vision_90b, whisper_base)}
ARCH_IDS: List[str] = list(REGISTRY)


def get_config(arch_id: str, **overrides) -> ModelConfig:
    if arch_id not in REGISTRY:
        raise KeyError(f"unknown arch {arch_id!r}; known: {ARCH_IDS}")
    cfg = REGISTRY[arch_id]
    return dataclasses.replace(cfg, **overrides) if overrides else cfg


def reduced_config(arch_id: str, **overrides) -> ModelConfig:
    """A tiny same-family config for CPU tests: few layers, narrow
    widths, small vocab, fp32 — keeping the GQA ratio, qk-norm, the MoE
    top-k, the SSM's structure (expand, conv kernel), the hybrid period
    (one whole period of layers), the vlm's period (one period with its
    cross-attention layer, 16 image tokens) and the enc-dec's two stacks
    (2 encoder and 2 decoder layers over 24 audio frames)."""
    cfg = get_config(arch_id)
    kw = dict(
        n_layers=min(cfg.n_layers, cfg.attn_period or 4),
        d_model=128,
        d_ff=0 if cfg.d_ff == 0 else 256,
        vocab_size=512,
        head_dim=32,
        vocab_pad_multiple=64,
        param_dtype="float32",
        compute_dtype="float32",
        remat="none",
        rope_theta=cfg.rope_theta,
    )
    if cfg.n_heads:
        # keep the GQA ratio (scaled down) but stay >= 1
        kw["n_heads"] = 4
        kw["n_kv_heads"] = max(1, 4 * cfg.n_kv_heads // cfg.n_heads)
    if cfg.family == "hybrid":
        kw["n_layers"] = cfg.attn_period  # one full period
    if cfg.moe is not None:
        # capacity_factor = E makes the reduced config dropless so the
        # prefill/decode == train-forward invariant holds exactly.
        kw["moe"] = MoEConfig(
            num_experts=min(cfg.moe.num_experts, 4),
            top_k=cfg.moe.top_k,
            expert_d_ff=256,
            capacity_factor=float(min(cfg.moe.num_experts, 4)),
        )
    if cfg.ssm is not None:
        kw["ssm"] = SSMConfig(
            d_state=16,
            head_dim=16,
            expand=cfg.ssm.expand,
            conv_kernel=cfg.ssm.conv_kernel,
            chunk_size=16,
        )
    if cfg.n_encoder_layers:
        kw["n_encoder_layers"] = 2
        kw["n_layers"] = 2
        kw["n_audio_ctx"] = 24
    if cfg.cross_attn_period:
        kw["n_layers"] = cfg.cross_attn_period  # one period incl. cross layer
        kw["num_image_tokens"] = 16
    kw.update(overrides)
    return dataclasses.replace(cfg, **kw)


__all__ = ["ModelConfig", "MoEConfig", "SSMConfig", "REGISTRY", "ARCH_IDS",
           "get_config", "reduced_config"]
