"""The dense decoder layer and the stack runner.

Counterparts of ``repro.models.blocks.attn_layer`` and ``run_stack``:
the reference scans over layer-stacked parameters; the port keeps one
parameter dict per layer and runs the stack as a Python loop.
"""
from __future__ import annotations

from typing import Sequence

import torch

from repro_torch.models import attention, layers


def attn_layer(p, x, cfg, *, positions, rope, cache, write, paged):
    """One pre-norm decoder layer in decode mode (``cache`` is this
    layer's {"k", "v"}, written in place)."""
    h = layers.rms_norm(x, p["ln1"], cfg.norm_eps)
    x = x + attention.attn_decode(p["attn"], h, cfg, positions=positions,
                                  rope=rope, cache=cache, write=write,
                                  paged=paged)
    h = layers.rms_norm(x, p["ln2"], cfg.norm_eps)
    return x + layers.mlp(h, p["mlp"])


def run_stack(x: torch.Tensor, layer_params: Sequence, cfg, *, positions,
              rope, cache, write, paged) -> torch.Tensor:
    """Run every layer over ``x``; ``cache`` holds layer-stacked K/V
    (n_layers, B, S_cache, NKV, H), indexed per layer as views."""
    for i, p in enumerate(layer_params):
        x = attn_layer(p, x, cfg, positions=positions, rope=rope,
                       cache={"k": cache["k"][i], "v": cache["v"][i]},
                       write=write, paged=paged)
    return x
