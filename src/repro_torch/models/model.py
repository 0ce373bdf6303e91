"""The LM (dense, moe and ssm families): parameters, forward modes,
slotted cache.

Counterpart of ``repro.models.model.LM`` for the dense, moe and ssm
families.  The parameters are a dict with the JAX tree's keys —
``embed.table``, ``final_norm.scale``, ``unembed.table`` when untied —
except that the layer stack is a list of per-layer dicts (dense:
``stack[i]`` holds ``ln1``, ``attn``, ``ln2``, ``mlp``; moe: ``moe`` in
place of ``mlp`` where ``cfg.layer_uses_moe(i)``; ssm: ``ln1``,
``mamba``) instead of leaves with a leading layer axis.  Weights are
random, drawn from an explicit ``torch.Generator``.

Modes: ``train``, ``prefill`` and ``decode``, for every family.
Prefill runs the prompt through (dense, moe) causal
``chunked_attention``, writing its K/V to the cache, or (ssm) the SSD
kernel, leaving each layer's final state in the cache.  Decode attends
over the K/V cache through the paged kernel under a page map, else
through the dense-cache flash-decode kernel; the ssm advances its
recurrent state.  The moe family is the dense one with ``models.moe``'s
experts in place of the MLP, each mode calling them with its own (B, S)
(the capacity depends on S).  A parameter tree from
``models.quant.quantize_params`` or ``init_params(int8=True)`` (int8
packs) runs every mode's matmuls through the int8 GEMM kernel, the
experts one call an expert and projection.
"""
from __future__ import annotations

from typing import Any, Dict, Optional

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels.common import resolve_device
from repro_torch.models import (attention, blocks, decode_state, layers, moe,
                                quant)
from repro_torch.models.layers import dtype_of

Params = Dict[str, Any]


class LM:
    def __init__(self, cfg: ModelConfig, device=None):
        self.cfg = cfg
        self.device = resolve_device(device)
        self.param_dtype = dtype_of(cfg.param_dtype)
        self.compute_dtype = dtype_of(cfg.compute_dtype)
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

    def _dense(self, gen, d_in, d_out, scale=None):
        return {"w": self._normal(gen, (d_in, d_out),
                                  d_in ** -0.5 if scale is None else scale)}

    def init_params(self, generator: Optional[torch.Generator], *,
                    int8: bool = False) -> Params:
        """Random parameters with the reference's initializer scales,
        drawn from ``generator`` (which must live on ``self.device``).

        ``int8``: the weight-only int8 tree, equal bit for bit to
        ``quant.quantize_params(init_params(generator))`` but never held
        in the param dtype: the embedding tables and each layer are drawn
        and quantized before the next is drawn, so the peak is the int8
        tree and one layer in the param dtype."""
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
        p["stack"] = [q(self._init_layer(g, i)) for i in range(cfg.n_layers)]
        return p

    def _init_layer(self, g, i: int) -> Params:
        cfg = self.cfg
        if cfg.family == "ssm":
            return blocks.init_mamba_layer(g, cfg, self.device)
        d, h = cfg.d_model, cfg.resolved_head_dim
        nq, nkv = cfg.n_heads, cfg.n_kv_heads
        attn = {
            "wq": self._dense(g, d, nq * h),
            "wk": self._dense(g, d, nkv * h),
            "wv": self._dense(g, d, nkv * h),
            "wo": self._dense(g, nq * h, d, (nq * h) ** -0.5),
        }
        if cfg.qk_norm:
            attn["q_norm"] = {"scale": self._ones(h)}
            attn["k_norm"] = {"scale": self._ones(h)}
        layer = {"ln1": {"scale": self._ones(d)}, "attn": attn,
                 "ln2": {"scale": self._ones(d)}}
        if cfg.layer_uses_moe(i):
            layer["moe"] = moe.init_moe(g, cfg, self.device)
        else:
            layer["mlp"] = {"gate": self._dense(g, d, cfg.d_ff),
                            "up": self._dense(g, d, cfg.d_ff),
                            "down": self._dense(g, cfg.d_ff, d,
                                                cfg.d_ff ** -0.5)}
        return layer

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

        ``mode="train"``: the whole sequence (dense: causal attention
        through ``cfg.attention_impl``; ssm: the chunked SSD), each layer
        rematerialised as ``cfg.remat`` says; returns (fp32 logits (B, S,
        V), None, aux) — aux is the sum of the layers' MoE load-balance
        losses (fp32; 0 for the dense and ssm families).

        ``mode="prefill"``: the prompt from position 0 into a fresh
        ``cache`` (from ``init_cache``), in place.  dense: causal
        attention over the prompt; its K/V go to cache positions [0, S)
        and ``cache["pos"]`` advances by S.  ssm: the chunked SSD (the
        CUDA kernel on the card); each layer's final recurrent state and
        conv tail are written into ``cache``.  Returns (fp32 logits,
        cache).

        ``mode="decode"``: ``n_valid`` (B,) real tokens per row (``None``:
        all S).  dense: writes the step's K/V into ``cache`` in place,
        advances ``cache["pos"]`` by ``n_valid``; ``paged`` names the page
        map of the cache's pool view and attends through the paged
        kernel; ``None`` attends over the cache as it is (the reference's
        ``_full_attention_with_cache``, outside any ``paged_decode``
        context).  ssm: advances the recurrent state in
        place through rows' valid columns only; ``positions`` and
        ``paged`` are not read.  Returns (fp32 logits, cache)."""
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
        rope = layers.rope_tables(positions, cfg.resolved_head_dim,
                                  cfg.rope_theta)
        if mode == "prefill":
            x, _ = blocks.run_stack(x, params["stack"], cfg,
                                    mode="prefill", rope=rope, cache=cache)
            cache["pos"].add_(tokens.shape[1])
            return self._logits(params, x), cache
        S_cache = cache["k"].shape[2]
        write = attention.decode_write(cache["pos"], tokens.shape[1],
                                       S_cache, n_valid)
        x, _ = blocks.run_stack(x, params["stack"], cfg,
                                positions=positions, rope=rope, cache=cache,
                                write=write, paged=paged)
        cache["pos"].copy_(write.kv_valid)
        return self._logits(params, x), cache

    def _forward_train(self, params, tokens, positions):
        cfg = self.cfg
        x = layers.embed(tokens, params["embed"], self.compute_dtype)
        rope = (None if cfg.family == "ssm" else layers.rope_tables(
            positions, cfg.resolved_head_dim, cfg.rope_theta))
        x, aux = blocks.run_stack(x, params["stack"], cfg, mode="train",
                                  rope=rope, remat=cfg.remat)
        return self._logits(params, x), None, aux

    def _logits(self, params, x):
        cfg = self.cfg
        x = layers.rms_norm(x, params["final_norm"], cfg.norm_eps)
        emb = params["embed"] if cfg.tie_embeddings else params["unembed"]
        return layers.unembed(x, emb).float()


def build_model(cfg: ModelConfig, device=None) -> LM:
    return LM(cfg, device=device)
