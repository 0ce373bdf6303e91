"""Config registry: ``get_config(arch_id)`` and ``reduced_config(arch_id)``.

The dense architectures of ``repro.configs``; ``reduced_config`` makes
the same tiny same-family config the JAX package's tests use, so both
packages build identical shapes from one arch id.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List

from repro_torch.configs import granite_3_2b, qwen3_1_7b
from repro_torch.configs.base import ModelConfig

REGISTRY: Dict[str, ModelConfig] = {
    m.CONFIG.arch_id: m.CONFIG for m in (granite_3_2b, qwen3_1_7b)}
ARCH_IDS: List[str] = list(REGISTRY)


def get_config(arch_id: str, **overrides) -> ModelConfig:
    if arch_id not in REGISTRY:
        raise KeyError(f"unknown arch {arch_id!r}; known: {ARCH_IDS}")
    cfg = REGISTRY[arch_id]
    return dataclasses.replace(cfg, **overrides) if overrides else cfg


def reduced_config(arch_id: str, **overrides) -> ModelConfig:
    """A tiny same-family config for CPU tests: few layers, narrow
    widths, small vocab, fp32 — keeping the GQA ratio and qk-norm."""
    cfg = get_config(arch_id)
    kw = dict(
        n_layers=min(cfg.n_layers, 4),
        d_model=128,
        d_ff=256,
        vocab_size=512,
        head_dim=32,
        vocab_pad_multiple=64,
        param_dtype="float32",
        compute_dtype="float32",
        remat="none",
        rope_theta=cfg.rope_theta,
        n_heads=4,
        n_kv_heads=max(1, 4 * cfg.n_kv_heads // cfg.n_heads),
    )
    kw.update(overrides)
    return dataclasses.replace(cfg, **kw)


__all__ = ["ModelConfig", "REGISTRY", "ARCH_IDS", "get_config",
           "reduced_config"]
