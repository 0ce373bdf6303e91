"""The dense decoder layer and the stack runner.

Counterparts of ``repro.models.blocks.attn_layer`` and ``run_stack``:
the reference scans over layer-stacked parameters; the port keeps one
parameter dict per layer and runs the stack as a Python loop.  In train
mode ``remat="full"`` wraps each layer in a non-reentrant
``torch.utils.checkpoint``: only the layer's input is kept, and the
backward runs the layer's forward again — the reference's
``jax.checkpoint`` with ``save_only_these_names("layer_input")``.
"""
from __future__ import annotations

import functools
from typing import Sequence

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.models import attention, layers

REMAT_MODES = ("none", "full")


def attn_layer(p, x, cfg, *, mode="decode", rope, positions=None,
               cache=None, write=None, paged=None):
    """One pre-norm decoder layer.  Train mode attends causally over the
    whole sequence; decode mode writes this layer's ``cache`` ({"k",
    "v"}) in place and attends through the paged kernel."""
    h = layers.rms_norm(x, p["ln1"], cfg.norm_eps)
    if mode == "train":
        a = attention.attn_train(p["attn"], h, cfg, rope=rope)
    elif mode == "decode":
        a = attention.attn_decode(p["attn"], h, cfg, positions=positions,
                                  rope=rope, cache=cache, write=write,
                                  paged=paged)
    else:
        raise NotImplementedError(f"mode={mode!r}")
    x = x + a
    h = layers.rms_norm(x, p["ln2"], cfg.norm_eps)
    return x + layers.mlp(h, p["mlp"])


def run_stack(x: torch.Tensor, layer_params: Sequence, cfg, *,
              mode: str = "decode", rope, positions=None, cache=None,
              write=None, paged=None, remat: str = "none") -> torch.Tensor:
    """Run every layer over ``x``.  Decode mode: ``cache`` holds
    layer-stacked K/V (n_layers, B, S_cache, NKV, H), indexed per layer as
    views.  Train mode: ``remat`` in ``REMAT_MODES``."""
    if remat not in REMAT_MODES:
        raise NotImplementedError(f"remat={remat!r}; the port has "
                                  f"{REMAT_MODES}")
    for i, p in enumerate(layer_params):
        if mode == "train":
            fn = functools.partial(attn_layer, p, cfg=cfg, mode="train",
                                   rope=rope)
            x = (checkpoint(fn, x, use_reentrant=False) if remat == "full"
                 else fn(x))
        else:
            x = attn_layer(p, x, cfg, mode=mode, positions=positions,
                           rope=rope,
                           cache={"k": cache["k"][i], "v": cache["v"][i]},
                           write=write, paged=paged)
    return x
