"""The LM (dense, moe, ssm and hybrid families): parameters, forward
modes, slotted cache.

Counterpart of ``repro.models.model.LM`` for the dense, moe, ssm and
hybrid families.  The parameters are a dict with the JAX tree's keys —
``embed.table``, ``final_norm.scale``, ``unembed.table`` when untied —
except that the layer stack is a list of per-layer dicts (dense:
``stack[i]`` holds ``ln1``, ``attn``, ``ln2``, ``mlp``; moe: ``moe`` in
place of ``mlp`` where ``cfg.layer_uses_moe(i)``; ssm: ``ln1``,
``mamba``; hybrid: one dict a period of ``attn_period`` layers, its
sub-layers ``s0``…``s7`` an attention layer or a mamba layer with an
FFN, as ``cfg.layer_kind`` says) instead of leaves with a leading layer
(or period) axis.  Weights are random, drawn from an explicit
``torch.Generator``.

Modes: ``train``, ``prefill`` and ``decode``, for every family.
Prefill runs the prompt through causal ``chunked_attention`` in an
attention layer, writing its K/V to the cache, and through the SSD
kernel in a mamba layer, leaving its final state in the cache.  Decode
attends over the K/V cache through the paged kernel under a page map,
else through the dense-cache flash-decode kernel; a mamba layer advances
its recurrent state.  The moe family is the dense one with
``models.moe``'s experts in place of the MLP, each mode calling them
with its own (B, S) (the capacity depends on S); the hybrid (jamba)
interleaves 1 attention layer with 7 mamba layers a period, MoE on every
other layer, and keeps both kinds of state (``HybridDecodeState``).  A
parameter tree from ``models.quant.quantize_params`` or
``init_params(int8=True)`` (int8 packs) runs every mode's matmuls
through the int8 GEMM kernel, the experts one call an expert and
projection.
"""
from __future__ import annotations

from typing import Any, Dict, Optional

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels.common import resolve_device
from repro_torch.models import attention, blocks, decode_state, layers, quant
from repro_torch.models.layers import dtype_of

Params = Dict[str, Any]


class LM:
    def __init__(self, cfg: ModelConfig, device=None):
        self.cfg = cfg
        self.device = resolve_device(device)
        self.param_dtype = dtype_of(cfg.param_dtype)
        self.compute_dtype = dtype_of(cfg.compute_dtype)
        self.n_periods = cfg.n_layers
        if cfg.family == "hybrid":
            if cfg.attn_period <= 0 or cfg.n_layers % cfg.attn_period:
                raise ValueError(
                    f"hybrid n_layers {cfg.n_layers} is not a multiple of "
                    f"attn_period {cfg.attn_period}")
            self.n_periods = cfg.n_layers // cfg.attn_period
        # the family's DecodeState adapter (raises for families not ported)
        self.decode_state = decode_state.get_adapter(cfg.family)

    # ------------------------------------------------------------------
    # params
    # ------------------------------------------------------------------
    def _normal(self, gen, shape, scale):
        w = torch.randn(shape, generator=gen, dtype=torch.float32,
                        device=self.device) * scale
        return w.to(self.param_dtype)

    def _ones(self, n):
        return torch.ones((n,), dtype=self.param_dtype, device=self.device)

    def init_params(self, generator: Optional[torch.Generator], *,
                    int8: bool = False) -> Params:
        """Random parameters with the reference's initializer scales,
        drawn from ``generator`` (which must live on ``self.device``).

        ``int8``: the weight-only int8 tree, equal bit for bit to
        ``quant.quantize_params(init_params(generator))`` but never held
        in the param dtype: the embedding tables and each layer (hybrid:
        each sub-layer of a period) are drawn and quantized before the
        next is drawn, so the peak is the int8 tree and one layer in the
        param dtype."""
        cfg = self.cfg
        d = cfg.d_model
        g = generator
        q = quant.quantize_params if int8 else (lambda tree: tree)
        p: Params = {
            "embed": q({"table": self._normal(g, (cfg.padded_vocab, d),
                                              0.02)}),
            "final_norm": {"scale": self._ones(d)},
        }
        if not cfg.tie_embeddings:
            p["unembed"] = q({"table": self._normal(
                g, (cfg.padded_vocab, d), 0.02)})
        p["stack"] = [self._init_layer(g, i, q)
                      for i in range(self.n_periods)]
        return p

    def _init_layer(self, g, i: int, q) -> Params:
        """Stack entry i, each layer passed through ``q`` as it is drawn:
        a layer, or (hybrid) a period of sub-layers ``s0``…, attention
        where ``cfg.layer_kind(j)`` says so, MoE where
        ``cfg.layer_uses_moe(j)``."""
        cfg, dev = self.cfg, self.device
        if cfg.family == "ssm":
            return q(blocks.init_mamba_layer(g, cfg, dev))
        if cfg.family != "hybrid":
            return q(blocks.init_attn_layer(g, cfg, dev,
                                            cfg.layer_uses_moe(i)))
        init = {"attn": blocks.init_attn_layer,
                "mamba": blocks.init_mamba_layer}
        return {f"s{j}": q(init[cfg.layer_kind(j)](
            g, cfg, dev, cfg.layer_uses_moe(j)))
            for j in range(cfg.attn_period)}

    def init_param_bytes(self) -> int:
        """Bytes of ``init_params``' tree in the param dtype, reckoned
        from the shapes on the meta device (nothing is allocated)."""
        meta = LM(self.cfg, device="meta")
        return quant.param_bytes(meta.init_params(None))

    # ------------------------------------------------------------------
    # cache (DecodeState protocol)
    # ------------------------------------------------------------------
    def init_cache(self, batch: int, max_len: int) -> Params:
        return self.decode_state.init(self, batch, max_len)

    def cache_specs(self) -> Params:
        return self.decode_state.specs(self)

    def cache_row(self, cache: Params, slot: int) -> Params:
        """Batch row ``slot`` as a batch-1 cache of views (in place)."""
        return decode_state.state_row(cache, self.cache_specs(), slot)

    def set_cache_row(self, cache: Params, slot: int, row: Params) -> Params:
        return decode_state.set_state_row(cache, self.cache_specs(), slot,
                                          row)

    def reset_cache_slots(self, cache: Params,
                          slot_mask: torch.Tensor) -> Params:
        """Zero the cache rows of the slots selected by ``slot_mask``."""
        return decode_state.reset_state_slots(cache, self.cache_specs(),
                                              slot_mask)

    # ------------------------------------------------------------------
    # forward
    # ------------------------------------------------------------------
    def forward(self, params: Params, tokens: torch.Tensor,
                positions: torch.Tensor, *, mode: str = "decode",
                cache: Optional[Params] = None,
                n_valid: Optional[torch.Tensor] = None,
                paged: Optional[attention.PagedDecodeState] = None):
        """tokens / positions (B, S).

        ``mode="train"``: the whole sequence (attention: causal through
        ``cfg.attention_impl``; mamba: the chunked SSD), each layer
        rematerialised as ``cfg.remat`` says; returns (fp32 logits (B, S,
        V), None, aux) — aux is the sum of the layers' MoE load-balance
        losses (fp32; 0 without MoE).

        ``mode="prefill"``: the prompt from position 0 into a fresh
        ``cache`` (from ``init_cache``), in place.  Attention layers:
        causal attention over the prompt; its K/V go to cache positions
        [0, S) and the position counter advances by S.  Mamba layers: the
        chunked SSD (the CUDA kernel on the card); each layer's final
        recurrent state and conv tail are written into ``cache``.
        Returns (fp32 logits, cache).

        ``mode="decode"``: ``n_valid`` (B,) real tokens per row (``None``:
        all S).  Attention layers write the step's K/V into ``cache`` in
        place, and the position counter advances by ``n_valid``;
        ``paged`` names the page map of the cache's pool view and attends
        through the paged kernel; ``None`` attends over the cache as it is
        (the reference's ``_full_attention_with_cache``, outside any
        ``paged_decode`` context).  Mamba layers advance the recurrent
        state in place through rows' valid columns only (the ssm reads
        neither ``positions`` nor ``paged``).  Returns (fp32 logits,
        cache)."""
        if mode == "train":
            return self._forward_train(params, tokens, positions)
        if mode not in ("decode", "prefill"):
            raise NotImplementedError(
                f"mode={mode!r}: the port runs train, prefill and decode "
                f"modes")
        cfg = self.cfg
        x = layers.embed(tokens, params["embed"], self.compute_dtype)
        if cfg.family == "ssm":
            x, _ = blocks.run_stack(x, params["stack"], cfg, mode=mode,
                                    cache=cache, n_valid=n_valid)
            return self._logits(params, x), cache
        # the attention layers' K/V and position counter
        kv = cache["attn"] if cfg.family == "hybrid" else cache
        rope = self._rope(positions)
        if mode == "prefill":
            x, _ = blocks.run_stack(x, params["stack"], cfg,
                                    mode="prefill", rope=rope, cache=cache)
            kv["pos"].add_(tokens.shape[1])
            return self._logits(params, x), cache
        write = attention.decode_write(kv["pos"], tokens.shape[1],
                                       kv["k"].shape[2], n_valid)
        x, _ = blocks.run_stack(x, params["stack"], cfg,
                                positions=positions, rope=rope, cache=cache,
                                write=write, paged=paged, n_valid=n_valid)
        kv["pos"].copy_(write.kv_valid)
        return self._logits(params, x), cache

    def _rope(self, positions):
        """The forward's fp32 (cos, sin) tables, shared by every attention
        layer; ``None`` without RoPE (the ssm, or ``rope_theta`` 0)."""
        cfg = self.cfg
        if cfg.family == "ssm" or cfg.rope_theta <= 0:
            return None
        return layers.rope_tables(positions, cfg.resolved_head_dim,
                                  cfg.rope_theta)

    def _forward_train(self, params, tokens, positions):
        cfg = self.cfg
        x = layers.embed(tokens, params["embed"], self.compute_dtype)
        x, aux = blocks.run_stack(x, params["stack"], cfg, mode="train",
                                  rope=self._rope(positions),
                                  remat=cfg.remat)
        return self._logits(params, x), None, aux

    def _logits(self, params, x):
        cfg = self.cfg
        x = layers.rms_norm(x, params["final_norm"], cfg.norm_eps)
        emb = params["embed"] if cfg.tie_embeddings else params["unembed"]
        return layers.unembed(x, emb).float()


def build_model(cfg: ModelConfig, device=None) -> LM:
    return LM(cfg, device=device)
