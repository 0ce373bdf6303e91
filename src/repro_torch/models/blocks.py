"""The decoder layer (dense, moe, audio), the mamba layer (ssm and
hybrid), the cross-attention layer (vlm) and the stack runner.

Counterparts of ``repro.models.blocks.attn_layer``, ``mamba_layer``,
``cross_layer`` and ``run_stack``, and of the audio decoder layer of
``repro.models.model.LM._period_step``: the reference scans over
layer-stacked parameters; the port keeps one parameter dict per layer
(hybrid and vlm: per period, holding its sub-layers ``s0``…, and the
vlm's ``cross``) and runs the stack as a Python loop, choosing each
layer's kind by the config (``sublayers``).  A layer's FFN is the MLP
(SwiGLU, or GELU where ``cfg.mlp_type`` says so) or, where the layer
holds ``moe``, the MoE, whose load-balance loss the stack sums in train
mode; a mamba layer has one where ``d_ff > 0`` or it holds ``moe``
(hybrid).  A decoder layer that holds ``xattn`` (whisper's) attends to
the context between its self-attention and its FFN; the vlm's cross
layer is that cross-attention (gated) and an FFN alone.

A layer is a residual chain of blocks (self-attention, cross-attention,
the mamba mixer, the FFN), each ``x + f(x)`` with its pre-norm inside
``f``.  Train mode rematerialises each layer (hybrid, vlm: each
sub-layer) as ``remat`` says, through non-reentrant
``torch.utils.checkpoint``, where the reference wraps its scan body in
``jax.checkpoint``:

- ``"full"``: only the layer's input is kept, and the backward runs the
  layer's forward again (``save_only_these_names("layer_input")``);
- ``"save_blocks"``: each block is checkpointed on its own, so the
  residual stream between blocks — the layer's input and the sums of
  the block outputs the reference names ``block_out`` — is kept and
  every block's interior is recomputed
  (``save_only_these_names("layer_input", "block_out")``);
- ``"dots"``: the layer is checkpointed under a selective policy that
  keeps the outputs of the matrix products (aten ``mm``, ``bmm``,
  ``addmm``, ``baddbmm``) and recomputes the rest
  (``checkpoint_dots``).  A kernel's launch inside an autograd Function
  is no aten op: it runs again in the recompute, as under ``"full"``.

All four give the same gradients.

``*_layer_specs`` are the reference's logical-axis spec trees of each
kind of layer (one layer's, without the stacked ``layers`` axis).  Under
a sharding context every sub-layer computes on the rank's blocks: the
MLP's down projection is row-parallel (its product summed over the
``mlp`` axis where a rank holds a block of ``d_ff``), the MoE runs the
experts the rank holds, or its block of each, and sums its output over
the split axes (``moe.moe_apply``), and the mamba mixer runs the rank's
heads (``mamba2.mamba_forward``), the hybrid's period of attention and
mamba sub-layers included.
"""
from __future__ import annotations

import functools
from typing import Sequence

import torch
from torch.utils.checkpoint import (CheckpointPolicy, checkpoint,
                                    create_selective_checkpoint_contexts)

from repro_torch.models import attention, layers, mamba2, moe
from repro_torch.models.layers import dtype_of

REMAT_MODES = ("none", "full", "save_blocks", "dots")
_aten = torch.ops.aten
DOT_OPS = frozenset({_aten.mm.default, _aten.bmm.default,
                     _aten.addmm.default, _aten.baddbmm.default})


# ---------------------------------------------------------------------------
# init
# ---------------------------------------------------------------------------
def _normal(generator, shape, scale, cfg, device):
    w = torch.randn(shape, generator=generator, dtype=torch.float32,
                    device=device) * scale
    return w.to(dtype_of(cfg.param_dtype))


def _dense(generator, d_in, d_out, cfg, device, scale=None):
    return {"w": _normal(generator, (d_in, d_out),
                         d_in ** -0.5 if scale is None else scale, cfg,
                         device)}


def _norm(cfg, n, device):
    return {"scale": torch.ones((n,), dtype=dtype_of(cfg.param_dtype),
                                device=device)}


def init_ffn(generator: torch.Generator, cfg, device, use_moe: bool):
    """``{"moe": …}`` or ``{"mlp": …}``: SwiGLU (gate, up, down drawn in
    that order) or, where ``cfg.mlp_type`` is ``"gelu"``, up and down,
    with the reference's scales."""
    if use_moe:
        return {"moe": moe.init_moe(generator, cfg, device)}
    d, f = cfg.d_model, cfg.d_ff
    mlp = {} if cfg.mlp_type == "gelu" else {
        "gate": _dense(generator, d, f, cfg, device)}
    mlp["up"] = _dense(generator, d, f, cfg, device)
    mlp["down"] = _dense(generator, f, d, cfg, device, f ** -0.5)
    return {"mlp": mlp}


def init_attention(generator: torch.Generator, cfg, device,
                   cross: bool = False):
    """wq, wk, wv, wo (and qk-norm scales); ``cross``: the gated
    cross-attention's 0-d ``gate_attn``, zero as in the reference, so an
    initialised cross layer adds nothing until it is trained."""
    d, h = cfg.d_model, cfg.resolved_head_dim
    nq, nkv = cfg.n_heads, cfg.n_kv_heads
    attn = {
        "wq": _dense(generator, d, nq * h, cfg, device),
        "wk": _dense(generator, d, nkv * h, cfg, device),
        "wv": _dense(generator, d, nkv * h, cfg, device),
        "wo": _dense(generator, nq * h, d, cfg, device, (nq * h) ** -0.5),
    }
    if cfg.qk_norm:
        attn["q_norm"] = _norm(cfg, h, device)
        attn["k_norm"] = _norm(cfg, h, device)
    if cross:
        attn["gate_attn"] = torch.zeros((), dtype=dtype_of(cfg.param_dtype),
                                        device=device)
    return attn


def init_attn_layer(generator: torch.Generator, cfg, device,
                    use_moe: bool):
    """Pre-norm attention + FFN."""
    d = cfg.d_model
    layer = {"ln1": _norm(cfg, d, device),
             "attn": init_attention(generator, cfg, device),
             "ln2": _norm(cfg, d, device)}
    layer.update(init_ffn(generator, cfg, device, use_moe))
    return layer


def init_decoder_layer(generator: torch.Generator, cfg, device):
    """The audio decoder layer: an attention layer (GELU MLP) with a
    pre-norm ungated cross-attention ``lnx`` + ``xattn``."""
    layer = init_attn_layer(generator, cfg, device, use_moe=False)
    layer["lnx"] = _norm(cfg, cfg.d_model, device)
    layer["xattn"] = init_attention(generator, cfg, device)
    return layer


def init_cross_layer(generator: torch.Generator, cfg, device):
    """The vlm's cross layer: pre-norm gated cross-attention (``lnx``,
    ``xattn``), then a pre-norm FFN (``ln2``)."""
    d = cfg.d_model
    layer = {"lnx": _norm(cfg, d, device),
             "xattn": init_attention(generator, cfg, device, cross=True),
             "ln2": _norm(cfg, d, device)}
    layer.update(init_ffn(generator, cfg, device, use_moe=False))
    return layer


def init_mamba_layer(generator: torch.Generator, cfg, device,
                     use_moe: bool = False):
    """Pre-norm Mamba-2 block, then (``d_ff > 0`` or ``use_moe``: the
    hybrid family) a pre-norm FFN; the ssm family's d_ff is 0, so its
    block is the whole layer."""
    layer = {"ln1": _norm(cfg, cfg.d_model, device),
             "mamba": mamba2.init_mamba(generator, cfg, device)}
    if cfg.d_ff > 0 or use_moe:
        layer["ln2"] = _norm(cfg, cfg.d_model, device)
        layer.update(init_ffn(generator, cfg, device, use_moe))
    return layer


# ---------------------------------------------------------------------------
# logical axes
# ---------------------------------------------------------------------------
def _ffn_specs(cfg, use_moe: bool):
    if use_moe:
        return {"moe": moe.moe_specs(cfg)}
    return {"mlp": layers.mlp_specs(cfg.mlp_type)}


def attn_layer_specs(cfg, use_moe: bool, cross: bool = False):
    p = {"ln1": layers.rmsnorm_specs(),
         "attn": attention.attention_specs(cfg, cross=cross),
         "ln2": layers.rmsnorm_specs()}
    p.update(_ffn_specs(cfg, use_moe))
    return p


def decoder_layer_specs(cfg):
    """The audio decoder layer's: ``attn_layer_specs`` with ``lnx`` and
    ``xattn``."""
    p = attn_layer_specs(cfg, use_moe=False)
    p["lnx"] = layers.rmsnorm_specs()
    p["xattn"] = attention.attention_specs(cfg, cross=False)
    return p


def mamba_layer_specs(cfg, use_moe: bool = False, with_ffn: bool = True):
    p = {"ln1": layers.rmsnorm_specs(), "mamba": mamba2.mamba_specs(cfg)}
    if with_ffn and (cfg.d_ff > 0 or use_moe):
        p["ln2"] = layers.rmsnorm_specs()
        p.update(_ffn_specs(cfg, use_moe))
    return p


def cross_layer_specs(cfg, use_moe: bool = False):
    p = {"lnx": layers.rmsnorm_specs(),
         "xattn": attention.attention_specs(cfg, cross=True),
         "ln2": layers.rmsnorm_specs()}
    p.update(_ffn_specs(cfg, use_moe))
    return p


# ---------------------------------------------------------------------------
# layers
# ---------------------------------------------------------------------------
def _mlp_or_moe(p, x, cfg, *, with_aux: bool):
    """The layer's FFN: returns (out, aux loss).  An MoE groups the tokens
    by batch row (G = B, Sg = S), as the reference's; the aux loss is
    computed only ``with_aux`` (else ``None``), a dense MLP's is 0."""
    if "moe" in p:
        return moe.moe_apply(p["moe"], x, cfg, with_aux=with_aux)
    aux = (torch.zeros((), dtype=torch.float32, device=x.device)
           if with_aux else None)
    return layers.row_parallel(layers.mlp(x, p["mlp"]), p["mlp"]["down"],
                               cfg.d_ff, "mlp"), aux


def _call(f, x):
    return f(x)


def _kept(f, x):
    """A block under ``remat="save_blocks"``: its own checkpoint."""
    return checkpoint(f, x, use_reentrant=False)


def _dots_policy(ctx, op, *args, **kwargs):
    return (CheckpointPolicy.MUST_SAVE if op in DOT_OPS
            else CheckpointPolicy.PREFER_RECOMPUTE)


def _save_dots():
    return create_selective_checkpoint_contexts(_dots_policy)


def _ffn_block(p, x, cfg, *, train):
    """``ffn(ln2(x))``: (out, aux) as ``_mlp_or_moe``."""
    h = layers.rms_norm(x, p["ln2"], cfg.norm_eps)
    return _mlp_or_moe(p, h, cfg, with_aux=train)


def _cross_block(p, x, cfg, *, mode, ctx, cache):
    """``xattn(lnx(x))``.  Train and prefill modes attend to ``ctx``,
    prefill also copying its K/V into ``cache`` ({"k", "v"}: this
    layer's (B, T, NKV, H) cross K/V) in place; decode mode attends over
    ``cache`` and never writes it."""
    h = layers.rms_norm(x, p["lnx"], cfg.norm_eps)
    if mode == "decode":
        a, _ = attention.cross_attn(p["xattn"], h, cfg,
                                    cached_kv=(cache["k"], cache["v"]))
        return a
    a, (k, v) = attention.cross_attn(p["xattn"], h, cfg, ctx=ctx)
    if mode == "prefill":
        cache["k"].copy_(k)
        cache["v"].copy_(v)
    return a


def attn_layer(p, x, cfg, *, mode="decode", rope, positions=None,
               cache=None, write=None, paged=None, causal=True, ctx=None,
               cross=None, block=_call):
    """One pre-norm decoder layer.  Train mode attends over the whole
    sequence (causally unless ``causal=False``: the audio encoder);
    prefill mode attends causally and writes the prompt's K/V to the
    start of this layer's ``cache`` ({"k", "v"}) in place; decode mode
    writes the step's K/V in place and attends through the paged kernel
    under ``paged``, else over the dense cache.  A layer holding
    ``xattn`` (the audio decoder's) then attends to the context:
    ``ctx`` in train and prefill modes, its K/V ``cross`` ({"k", "v"})
    in prefill (written) and decode (read) modes.  ``block(f, x)`` runs
    each block ``f`` (``_kept`` under ``remat="save_blocks"``).  Returns
    (x, aux): the FFN's aux loss in train mode, else ``None``."""
    if mode not in ("train", "prefill", "decode"):
        raise NotImplementedError(f"mode={mode!r}")

    def self_attn(x):
        h = layers.rms_norm(x, p["ln1"], cfg.norm_eps)
        if mode == "train":
            return attention.attn_train(p["attn"], h, cfg, rope=rope,
                                        causal=causal)
        if mode == "prefill":
            return attention.attn_prefill(p["attn"], h, cfg, rope=rope,
                                          cache=cache)
        return attention.attn_decode(p["attn"], h, cfg, positions=positions,
                                     rope=rope, cache=cache, write=write,
                                     paged=paged)

    x = x + block(self_attn, x)
    if "xattn" in p:
        x = x + block(functools.partial(_cross_block, p, cfg=cfg, mode=mode,
                                        ctx=ctx, cache=cross), x)
    f, aux = block(functools.partial(_ffn_block, p, cfg=cfg,
                                     train=mode == "train"), x)
    return x + f, aux


def cross_layer(p, x, cfg, *, mode="decode", ctx=None, cache=None,
                block=_call):
    """The vlm's gated cross-attention + FFN (Llama-3.2-Vision style):
    ``ctx`` in train and prefill modes, the layer's cross K/V ``cache``
    in prefill (written) and decode (read) modes.  Returns (x, aux) as
    ``attn_layer``."""
    x = x + block(functools.partial(_cross_block, p, cfg=cfg, mode=mode,
                                    ctx=ctx, cache=cache), x)
    f, aux = block(functools.partial(_ffn_block, p, cfg=cfg,
                                     train=mode == "train"), x)
    return x + f, aux


def mamba_layer(p, x, cfg, *, mode, state=None, n_valid=None, block=_call):
    """One pre-norm Mamba-2 layer, then its FFN where it has one (``ln2``).
    ``state`` ({"h", "conv"} views of the layer's slice of the recurrent
    state) and ``n_valid`` apply to decode mode only.  Returns (x, the
    prefill state or None, aux): the FFN's aux loss in train mode (0
    without an MoE), else ``None``."""
    def mixer(x):
        h = layers.rms_norm(x, p["ln1"], cfg.norm_eps)
        return mamba2.mamba_forward(
            p["mamba"], h, cfg, state=state if mode == "decode" else None,
            mode=mode, n_valid=n_valid if mode == "decode" else None)

    y, new_state = block(mixer, x)
    x = x + y
    train = mode == "train"
    if "ln2" not in p:
        return x, new_state, (torch.zeros((), dtype=torch.float32,
                                          device=x.device) if train
                              else None)
    f, aux = block(functools.partial(_ffn_block, p, cfg=cfg, train=train), x)
    return x + f, new_state, aux


def _mamba_step(p, x, cfg, *, mode, state, n_valid, block=_call):
    """A mamba layer as the stack runs it: prefill copies the final state
    and conv tail into the layer's ``state`` views.  Returns (x, aux)."""
    x, st, aux = mamba_layer(p, x, cfg, mode=mode, state=state,
                             n_valid=n_valid, block=block)
    if mode == "prefill":
        state["h"].copy_(st["h"])
        state["conv"].copy_(st["conv"])
    return x, aux


# ---------------------------------------------------------------------------
# stack
# ---------------------------------------------------------------------------
def sublayers(layer_params: Sequence, cfg):
    """(params, kind, cache index) of every layer in order.  dense, moe,
    ssm and audio: one a stack entry, indexed by layer (an audio layer's
    self and cross K/V both).  hybrid: a period's
    ``s0``…``s{attn_period-1}``, kinds by ``cfg.layer_kind``; period i's
    attention sub-layer takes attention slot i and its m-th mamba
    sub-layer recurrent slot i x (attn_period - 1) + m.  vlm: a period's
    ``s0``…``s{per-2}``, attention layers in self slots i x (per - 1) +
    j, then its ``cross`` layer in cross slot i."""
    if cfg.family == "vlm":
        per = cfg.cross_attn_period
        out = []
        for i, period in enumerate(layer_params):
            out += [(period[f"s{j}"], "attn", i * (per - 1) + j)
                    for j in range(per - 1)]
            out.append((period["cross"], "cross", i))
        return out
    if cfg.family != "hybrid":
        kind = cfg.layer_kind(0)
        return [(p, kind, i) for i, p in enumerate(layer_params)]
    n_mamba = cfg.attn_period - 1
    out = []
    for i, period in enumerate(layer_params):
        m = 0
        for j in range(cfg.attn_period):
            if cfg.layer_kind(j) == "attn":
                out.append((period[f"s{j}"], "attn", i))
            else:
                out.append((period[f"s{j}"], "mamba", i * n_mamba + m))
                m += 1
    return out


def kv_cache(cfg, cache):
    """The attention layers' K/V and position counter within a family's
    cache: the hybrid's ``"attn"``, the vlm's and audio's ``"self"``,
    else the cache itself."""
    if cfg.family == "hybrid":
        return cache["attn"]
    if cfg.family in ("vlm", "audio"):
        return cache["self"]
    return cache


def ssm_state(cfg, cache):
    """The recurrent state within a family's cache: the hybrid's
    ``"ssm"``, the ssm's cache itself, else ``None``."""
    if cfg.family == "hybrid":
        return cache["ssm"]
    return cache if cfg.family == "ssm" else None


def _cross_views(cache, c):
    return {"k": cache["cross_k"][c], "v": cache["cross_v"][c]}


def run_stack(x: torch.Tensor, layer_params: Sequence, cfg, *,
              mode: str = "decode", rope=None, positions=None, cache=None,
              write=None, paged=None, n_valid=None, ctx=None,
              causal: bool = True, remat: str = "none"):
    """Run every layer over ``x``, kinds by the config; returns (x, aux):
    in train mode the sum of the layers' MoE load-balance losses (0
    without MoE), else ``None``.

    Prefill and decode modes' ``cache``: dense and moe, layer-stacked K/V
    (n_layers, B, S_cache, NKV, H), indexed per layer as views; ssm, the
    layer-stacked recurrent state (``mamba2.init_state``); hybrid, both,
    under ``"attn"`` (one entry a period) and ``"ssm"`` (one a mamba
    sub-layer); vlm and audio, the self-attention K/V under ``"self"``
    and each cross layer's read-only K/V under ``"cross_k"`` /
    ``"cross_v"``.  Prefill writes each mamba layer's final state and
    each cross layer's K/V of ``ctx`` into it and decode (``n_valid``:
    ragged rows) updates the rest in place.  ``ctx`` (B, T, d): the
    context of the cross layers in train and prefill modes.  Train mode:
    ``causal`` (False: the audio encoder), ``remat`` in
    ``REMAT_MODES``."""
    if remat not in REMAT_MODES:
        raise NotImplementedError(f"remat={remat!r}; the port has "
                                  f"{REMAT_MODES}")
    train = mode == "train"
    kv = ssm = None
    if not train:
        kv = kv_cache(cfg, cache)
        ssm = ssm_state(cfg, cache)
    aux = (torch.zeros((), dtype=torch.float32, device=x.device) if train
           else None)
    remat = remat if train else "none"
    block = _kept if remat == "save_blocks" else _call
    for p, kind, c in sublayers(layer_params, cfg):
        if kind == "attn":
            fn = functools.partial(
                attn_layer, p, cfg=cfg, mode=mode, rope=rope,
                positions=positions, write=write, paged=paged,
                causal=causal, ctx=ctx, block=block,
                cache=None if train else {"k": kv["k"][c],
                                          "v": kv["v"][c]},
                cross=(None if train or "xattn" not in p
                       else _cross_views(cache, c)))
        elif kind == "cross":
            fn = functools.partial(
                cross_layer, p, cfg=cfg, mode=mode, ctx=ctx, block=block,
                cache=None if train else _cross_views(cache, c))
        else:
            fn = functools.partial(
                _mamba_step, p, cfg=cfg, mode=mode, n_valid=n_valid,
                block=block,
                state=None if train else {"h": ssm["h"][c],
                                          "conv": ssm["conv"][c]})
        if remat == "full":
            x, a = checkpoint(fn, x, use_reentrant=False)
        elif remat == "dots":
            x, a = checkpoint(fn, x, use_reentrant=False,
                              context_fn=_save_dots)
        else:
            x, a = fn(x)
        if train:
            aux = aux + a
    return x, aux
