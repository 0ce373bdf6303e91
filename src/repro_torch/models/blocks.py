"""The decoder layer (dense and moe), the mamba layer and the stack
runner.

Counterparts of ``repro.models.blocks.attn_layer``, ``mamba_layer`` and
``run_stack``: the reference scans over layer-stacked parameters; the
port keeps one parameter dict per layer and runs the stack as a Python
loop, choosing the layer by the config's family.  A decoder layer's FFN
is the SwiGLU ``mlp`` or, where the layer holds ``moe``, the MoE, whose
load-balance loss the stack sums in train mode.  In train
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

from repro_torch.models import attention, layers, mamba2, moe
from repro_torch.models.layers import dtype_of

REMAT_MODES = ("none", "full")


def _mlp_or_moe(p, x, cfg, *, with_aux: bool):
    """The layer's FFN: returns (out, aux loss).  An MoE groups the tokens
    by batch row (G = B, Sg = S), as the reference's; the aux loss is
    computed only ``with_aux`` (else ``None``), a dense MLP's is 0."""
    if "moe" in p:
        return moe.moe_apply(p["moe"], x, cfg, with_aux=with_aux)
    aux = (torch.zeros((), dtype=torch.float32, device=x.device)
           if with_aux else None)
    return layers.mlp(x, p["mlp"]), aux


def attn_layer(p, x, cfg, *, mode="decode", rope, positions=None,
               cache=None, write=None, paged=None):
    """One pre-norm decoder layer.  Train mode attends causally over the
    whole sequence; prefill mode does too and writes the prompt's K/V to
    the start of this layer's ``cache`` ({"k", "v"}) in place; decode
    mode writes the step's K/V in place and attends through the paged
    kernel under ``paged``, else over the dense cache.  Returns (x, aux):
    the FFN's aux loss in train mode, else ``None``."""
    h = layers.rms_norm(x, p["ln1"], cfg.norm_eps)
    if mode == "train":
        a = attention.attn_train(p["attn"], h, cfg, rope=rope)
    elif mode == "prefill":
        a = attention.attn_prefill(p["attn"], h, cfg, rope=rope, cache=cache)
    elif mode == "decode":
        a = attention.attn_decode(p["attn"], h, cfg, positions=positions,
                                  rope=rope, cache=cache, write=write,
                                  paged=paged)
    else:
        raise NotImplementedError(f"mode={mode!r}")
    x = x + a
    h = layers.rms_norm(x, p["ln2"], cfg.norm_eps)
    f, aux = _mlp_or_moe(p, h, cfg, with_aux=mode == "train")
    return x + f, aux


def init_mamba_layer(generator: torch.Generator, cfg, device):
    """Pre-norm + Mamba-2 block: the whole layer of the ssm family (its
    d_ff is 0, so there is no FFN)."""
    if cfg.d_ff:
        raise NotImplementedError(
            "a mamba layer with an FFN (hybrid / d_ff > 0) is not ported "
            "yet (ROADMAP A6)")
    return {
        "ln1": {"scale": torch.ones((cfg.d_model,),
                                    dtype=dtype_of(cfg.param_dtype),
                                    device=device)},
        "mamba": mamba2.init_mamba(generator, cfg, device),
    }


def mamba_layer(p, x, cfg, *, mode, state=None, n_valid=None):
    """One pre-norm Mamba-2 layer.  ``state`` ({"h", "conv"} views of the
    layer's slice of the recurrent state) and ``n_valid`` apply to decode
    mode only.  Returns (x, the prefill state or None)."""
    h = layers.rms_norm(x, p["ln1"], cfg.norm_eps)
    y, new_state = mamba2.mamba_forward(
        p["mamba"], h, cfg, state=state if mode == "decode" else None,
        mode=mode, n_valid=n_valid if mode == "decode" else None)
    return x + y, new_state


def _mamba_stack(x, layer_params, cfg, *, mode, cache, n_valid, remat):
    for i, p in enumerate(layer_params):
        if mode == "train":
            fn = functools.partial(mamba_layer, p, cfg=cfg, mode="train")
            x = (checkpoint(fn, x, use_reentrant=False) if remat == "full"
                 else fn(x))[0]
        elif mode == "prefill":
            x, st = mamba_layer(p, x, cfg, mode="prefill")
            cache["h"][i].copy_(st["h"])
            cache["conv"][i].copy_(st["conv"])
        else:
            x, _ = mamba_layer(p, x, cfg, mode="decode",
                               state={"h": cache["h"][i],
                                      "conv": cache["conv"][i]},
                               n_valid=n_valid)
    return x


def run_stack(x: torch.Tensor, layer_params: Sequence, cfg, *,
              mode: str = "decode", rope=None, positions=None, cache=None,
              write=None, paged=None, n_valid=None,
              remat: str = "none"):
    """Run every layer over ``x``, by the config's family; returns (x,
    aux): in train mode the sum of the layers' MoE load-balance losses
    (0 without MoE), else ``None``.

    dense and moe: prefill and decode modes' ``cache`` holds layer-stacked K/V
    (n_layers, B, S_cache, NKV, H), indexed per layer as views.  ssm:
    ``cache`` holds the layer-stacked recurrent state
    (``mamba2.init_state``); prefill
    writes each layer's final state into it and decode (``n_valid``:
    ragged rows) updates it in place.  Train mode: ``remat`` in
    ``REMAT_MODES``."""
    if remat not in REMAT_MODES:
        raise NotImplementedError(f"remat={remat!r}; the port has "
                                  f"{REMAT_MODES}")
    if cfg.family == "ssm":
        x = _mamba_stack(x, layer_params, cfg, mode=mode, cache=cache,
                         n_valid=n_valid, remat=remat)
        return x, (torch.zeros((), dtype=torch.float32, device=x.device)
                   if mode == "train" else None)
    if mode != "train":
        for i, p in enumerate(layer_params):
            x, _ = attn_layer(p, x, cfg, mode=mode, positions=positions,
                              rope=rope,
                              cache={"k": cache["k"][i],
                                     "v": cache["v"][i]},
                              write=write, paged=paged)
        return x, None
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    for p in layer_params:
        fn = functools.partial(attn_layer, p, cfg=cfg, mode="train",
                               rope=rope)
        x, a = (checkpoint(fn, x, use_reentrant=False) if remat == "full"
                else fn(x))
        aux = aux + a
    return x, aux
