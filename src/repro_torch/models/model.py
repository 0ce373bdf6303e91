"""The LM (every family: dense, moe, ssm, hybrid, vlm and audio):
parameters, forward modes, slotted cache.

Counterpart of ``repro.models.model.LM``.  The parameters are a dict
with the JAX tree's keys — ``embed.table``, ``final_norm.scale``
(``unembed.table`` when untied) — except that a layer stack is a list of
per-layer dicts (dense: ``stack[i]`` holds ``ln1``, ``attn``, ``ln2``,
``mlp``; moe: ``moe`` in place of ``mlp`` where ``cfg.layer_uses_moe(i)``;
ssm: ``ln1``, ``mamba``; hybrid: one dict a period of ``attn_period``
layers, its sub-layers ``s0``…``s7`` an attention layer or a mamba layer
with an FFN, as ``cfg.layer_kind`` says; vlm: one dict a period of
``cross_attn_period`` layers, ``s0``…``s3`` attention layers and
``cross`` a gated cross-attention layer; audio: a decoder layer with
``lnx`` and ``xattn`` beside its attention and GELU MLP, and
``encoder = {"stack": [...], "final_norm"}``) instead of leaves with a
leading layer (or period) axis.  Weights are random, drawn from an
explicit ``torch.Generator``.

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
other layer, and keeps both kinds of state (``HybridDecodeState``).  The
cross-attention families take a context in ``extra`` in train and
prefill modes (vlm: ``image_embeds``; audio: ``audio_frames``, which the
encoder, ``encode_audio``, turns into the context); prefill writes each
cross layer's K/V of it into the cache, and decode mode only reads it,
or what ``install_slot_context`` put there.  A parameter tree from
``models.quant.quantize_params`` or ``init_params(int8=True)`` (int8
packs) runs every mode's matmuls through the int8 GEMM kernel, the
experts one call an expert and projection.

``param_specs`` is the reference's logical-axis spec tree, keyed as the
port's tree (a spec dict a layer).  Under a sharding context (the
serving engine's mesh: ``parallel.axes``) a decode-mode forward of the
dense, moe, ssm and hybrid families runs on this rank's blocks of the
parameters and the cache: a vocab-parallel embedding and unembedding,
column- and row-parallel projections, the sequence-parallel decode where
the cache length is split (``attention._attn_decode_spkv``), the
experts a rank holds or its block of each (``moe.moe_apply``), and the
Mamba-2 mixer over the rank's heads (``mamba2.mamba_forward``).  The
vlm and audio families and every other mode raise
``NotImplementedError`` there (ROADMAP A10).  ``init_params(shard=...)``
cuts each layer to the rank's block as it is drawn, so a rank never
holds more than one whole layer.
"""
from __future__ import annotations

from typing import Any, Callable, Dict, Optional

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels.common import resolve_device
from repro_torch.models import attention, blocks, decode_state, layers, quant
from repro_torch.models.layers import dtype_of
from repro_torch.parallel import axes as paxes

Params = Dict[str, Any]

# the families whose decode-mode forward runs on a rank's blocks
MESH_FAMILIES = ("dense", "moe", "ssm", "hybrid")


class LM:
    def __init__(self, cfg: ModelConfig, device=None):
        self.cfg = cfg
        self.device = resolve_device(device)
        self.param_dtype = dtype_of(cfg.param_dtype)
        self.compute_dtype = dtype_of(cfg.compute_dtype)
        self.n_periods = cfg.n_layers
        period = {"hybrid": ("attn_period", cfg.attn_period),
                  "vlm": ("cross_attn_period", cfg.cross_attn_period)}
        if cfg.family in period:
            name, per = period[cfg.family]
            if per <= 0 or cfg.n_layers % per:
                raise ValueError(
                    f"{cfg.family} n_layers {cfg.n_layers} is not a "
                    f"multiple of {name} {per}")
            self.n_periods = cfg.n_layers // per
        # the family's DecodeState adapter (raises for an unknown family)
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
                    int8: bool = False,
                    shard: Optional[Callable[[Params, Params], Params]] = None
                    ) -> Params:
        """Random parameters with the reference's initializer scales,
        drawn from ``generator`` (which must live on ``self.device``).

        ``int8``: the weight-only int8 tree, equal bit for bit to
        ``quant.quantize_params(init_params(generator))`` but never held
        in the param dtype: the embedding tables and each layer (hybrid,
        vlm: each sub-layer of a period; audio: the encoder's layers
        too) are drawn and quantized before the next is drawn, so the
        peak is the int8 tree and one layer in the param dtype.

        ``shard(tree, specs)``: applied to each piece as it is drawn (and
        quantized) with its spec tree (``layout_specs`` of the piece), e.g.
        a rank's ``parallel.axes.shard_tree``: the same draws, each piece
        cut before the next is drawn."""
        cfg = self.cfg
        d = cfg.d_model
        g = generator
        specs = self.param_specs()

        def q(tree, spec):
            if int8:
                tree = quant.quantize_params(tree)
            if shard is None:
                return tree
            return shard(tree, quant.quantize_specs(spec, tree) if int8
                         else spec)

        p: Params = {
            "embed": q({"table": self._normal(g, (cfg.padded_vocab, d),
                                              0.02)}, specs["embed"]),
            "final_norm": {"scale": self._ones(d)},
        }
        if not cfg.tie_embeddings:
            p["unembed"] = q({"table": self._normal(
                g, (cfg.padded_vocab, d), 0.02)}, specs["unembed"])
        p["stack"] = [self._init_layer(g, i, q, specs["stack"][i])
                      for i in range(self.n_periods)]
        if cfg.is_encdec:
            enc = specs["encoder"]["stack"]
            p["encoder"] = {
                "stack": [q(blocks.init_attn_layer(g, cfg, self.device,
                                                   use_moe=False), enc[i])
                          for i in range(cfg.n_encoder_layers)],
                "final_norm": {"scale": self._ones(d)}}
        return p

    def param_specs(self) -> Params:
        """The reference's logical-axis spec of every parameter, keyed as
        ``init_params``' tree (one spec dict a stack entry)."""
        cfg = self.cfg
        p: Params = {"embed": layers.embedding_specs(),
                     "final_norm": layers.rmsnorm_specs()}
        if not cfg.tie_embeddings:
            p["unembed"] = layers.embedding_specs()
        p["stack"] = [self._layer_specs(i) for i in range(self.n_periods)]
        if cfg.is_encdec:
            p["encoder"] = {
                "stack": [blocks.attn_layer_specs(cfg, use_moe=False)
                          for _ in range(cfg.n_encoder_layers)],
                "final_norm": layers.rmsnorm_specs()}
        return p

    def _layer_specs(self, i: int) -> Params:
        cfg = self.cfg
        if cfg.family == "ssm":
            return blocks.mamba_layer_specs(cfg, with_ffn=cfg.d_ff > 0)
        if cfg.family == "audio":
            return blocks.decoder_layer_specs(cfg)
        if cfg.family == "vlm":
            per = cfg.cross_attn_period
            period = {f"s{j}": blocks.attn_layer_specs(cfg, use_moe=False)
                      for j in range(per - 1)}
            period["cross"] = blocks.cross_layer_specs(cfg)
            return period
        if cfg.family != "hybrid":
            return blocks.attn_layer_specs(cfg, cfg.layer_uses_moe(i))
        spec = {"attn": blocks.attn_layer_specs,
                "mamba": blocks.mamba_layer_specs}
        return {f"s{j}": spec[cfg.layer_kind(j)](cfg, cfg.layer_uses_moe(j))
                for j in range(cfg.attn_period)}

    def layout_specs(self, params: Params) -> Params:
        """The spec tree of ``params``: ``param_specs``, or where the tree
        holds int8 packs, ``quant.quantize_specs`` of it."""
        specs = self.param_specs()
        if quant.has_qpack(params):
            return quant.quantize_specs(specs, params)
        return specs

    def _init_layer(self, g, i: int, q, spec) -> Params:
        """Stack entry i, each layer passed through ``q`` as it is drawn:
        a layer (audio: the decoder layer with its cross-attention), or a
        period of sub-layers ``s0``… — hybrid: attention where
        ``cfg.layer_kind(j)`` says so, MoE where ``cfg.layer_uses_moe(j)``;
        vlm: attention layers, then the gated ``cross`` layer."""
        cfg, dev = self.cfg, self.device
        if cfg.family == "ssm":
            return q(blocks.init_mamba_layer(g, cfg, dev), spec)
        if cfg.family == "audio":
            return q(blocks.init_decoder_layer(g, cfg, dev), spec)
        if cfg.family == "vlm":
            per = cfg.cross_attn_period
            period = {f"s{j}": q(blocks.init_attn_layer(g, cfg, dev, False),
                                 spec[f"s{j}"])
                      for j in range(per - 1)}
            period["cross"] = q(blocks.init_cross_layer(g, cfg, dev),
                                spec["cross"])
            return period
        if cfg.family != "hybrid":
            return q(blocks.init_attn_layer(g, cfg, dev,
                                            cfg.layer_uses_moe(i)), spec)
        init = {"attn": blocks.init_attn_layer,
                "mamba": blocks.init_mamba_layer}
        return {f"s{j}": q(init[cfg.layer_kind(j)](
            g, cfg, dev, cfg.layer_uses_moe(j)), spec[f"s{j}"])
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

    def adjust_cache_counters(self, cache: Params,
                              delta: torch.Tensor) -> Params:
        """Subtract the per-slot ``delta`` (B,) from the cache's position
        counters, in place: the speculative rewind to the accepted
        frontier (only for ``decode_state.token_addressable``
        families)."""
        return decode_state.adjust_state_counters(cache, self.cache_specs(),
                                                  delta)

    def install_cache_prefix(self, cache: Params, src_slot: int,
                             dst_slot: int, n_tokens: int,
                             kv_offset: int = 0) -> Params:
        """Copy the first ``n_tokens`` K/V entries of ``src_slot``'s rows
        into ``dst_slot`` and set its position counter to ``n_tokens``,
        in place: the device half of the prefix cache (only for
        ``decode_state.prefix_cachable`` families); ``src_slot ==
        dst_slot`` trims in place.  ``kv_offset``: the first cache
        position of a rank's slice of the cache length (sequence-
        parallel serving)."""
        return decode_state.copy_state_prefix(cache, self.cache_specs(),
                                              src_slot, dst_slot, n_tokens,
                                              kv_offset=kv_offset)

    def install_slot_context(self, params: Params, cache: Params, slot: int,
                             extra: Dict[str, Any]) -> Params:
        """Admission-time write of a request's read-only context (the
        cross K/V of its image embeddings or, the encoder run first, of
        its audio frames: (T, d) or (1, T, d)) into row ``slot`` of the
        cache, in place.  A no-op for a family without such state."""
        self.decode_state.install_context(self, params,
                                          self.cache_row(cache, slot), extra)
        return cache

    def cross_attention_params(self, params: Params):
        """Each cross layer's ``xattn`` params, in cross-slot order."""
        if self.cfg.family == "vlm":
            return [period["cross"]["xattn"] for period in params["stack"]]
        return [layer["xattn"] for layer in params["stack"]]

    def encode_audio(self, params: Params, frames: torch.Tensor, *,
                     remat: str = "none"):
        """The whisper encoder over (B, T, d) frame embeddings: each layer
        non-causal attention (RoPE at positions 0…T-1) and its GELU MLP,
        in train mode, then the encoder's final norm.  Returns (the
        encoder's output, aux: 0, its layers have no MoE).  Used by the
        train and prefill forwards and by the audio adapter's install."""
        cfg = self.cfg
        enc = frames.to(self.compute_dtype)
        pos = torch.arange(enc.shape[1], device=enc.device)[None].expand(
            enc.shape[:2])
        enc, aux = blocks.run_stack(enc, params["encoder"]["stack"], cfg,
                                    mode="train", rope=self._rope(pos),
                                    causal=False, remat=remat)
        enc = layers.rms_norm(enc, params["encoder"]["final_norm"],
                              cfg.norm_eps)
        return enc, aux

    def _context(self, params, mode, extra, remat="none"):
        """(ctx, aux) of the cross layers in train and prefill modes: the
        vlm's image embeddings, or the encoder over the audio frames
        (aux its loss); (None, None) otherwise."""
        fam = self.cfg.family
        if mode == "decode" or fam not in ("vlm", "audio"):
            return None, None
        if fam == "vlm":
            return extra["image_embeds"].to(self.compute_dtype), None
        return self.encode_audio(params, extra["audio_frames"].to(
            self.compute_dtype), remat=remat)

    # ------------------------------------------------------------------
    # forward
    # ------------------------------------------------------------------
    def forward(self, params: Params, tokens: torch.Tensor,
                positions: torch.Tensor, *, mode: str = "decode",
                cache: Optional[Params] = None,
                n_valid: Optional[torch.Tensor] = None,
                paged: Optional[attention.PagedDecodeState] = None,
                extra: Optional[Dict[str, torch.Tensor]] = None):
        """tokens / positions (B, S); ``extra``: the vlm's
        ``image_embeds`` or the audio's ``audio_frames`` (B, T, d), read in
        train and prefill modes (decode mode reads the cross K/V in the
        cache).

        ``mode="train"``: the whole sequence (attention: causal through
        ``cfg.attention_impl``; mamba: the chunked SSD), each layer
        rematerialised as ``cfg.remat`` says; returns (fp32 logits (B, S,
        V), None, aux) — aux is the sum of the layers' MoE load-balance
        losses (fp32; 0 without MoE; audio: plus the encoder's).

        ``mode="prefill"``: the prompt from position 0 into a fresh
        ``cache`` (from ``init_cache``), in place.  Attention layers:
        causal attention over the prompt; its K/V go to cache positions
        [0, S) and the position counter advances by S.  Mamba layers: the
        chunked SSD (the CUDA kernel on the card); each layer's final
        recurrent state and conv tail are written into ``cache``.  Cross
        layers attend to the context and write its K/V into the cache.
        Returns (fp32 logits, cache).

        ``mode="decode"``: ``n_valid`` (B,) real tokens per row (``None``:
        all S).  Attention layers write the step's K/V into ``cache`` in
        place, and the position counter advances by ``n_valid``;
        ``paged`` names the page map of the cache's pool view and attends
        through the paged kernel; ``None`` attends over the cache as it is
        (the reference's ``_full_attention_with_cache``, outside any
        ``paged_decode`` context).  Mamba layers advance the recurrent
        state in place through rows' valid columns only (the ssm reads
        neither ``positions`` nor ``paged``).  Cross layers attend over
        their K/V in the cache (from a prefill or an install), every key
        valid, and write nothing.  Returns (fp32 logits, cache)."""
        if mode == "train":
            return self._forward_train(params, tokens, positions, extra)
        if mode not in ("decode", "prefill"):
            raise NotImplementedError(
                f"mode={mode!r}: the port runs train, prefill and decode "
                f"modes")
        cfg = self.cfg
        if paxes.active() and (mode != "decode"
                               or cfg.family not in MESH_FAMILIES):
            raise NotImplementedError(
                f"a {cfg.family} forward in mode {mode!r} under a mesh: the "
                f"port shards the decode mode of the {', '.join(MESH_FAMILIES)}"
                f" families (ROADMAP A10; the vlm and audio families wait on "
                f"its item 6, left 1)")
        x = layers.embed(tokens, params["embed"], self.compute_dtype,
                         cfg.padded_vocab)
        if cfg.family == "ssm":
            x, _ = blocks.run_stack(x, params["stack"], cfg, mode=mode,
                                    cache=cache, n_valid=n_valid)
            return self._logits(params, x), cache
        # the attention layers' K/V and position counter
        kv = blocks.kv_cache(cfg, cache)
        rope = self._rope(positions)
        if mode == "prefill":
            ctx, _ = self._context(params, mode, extra)
            x, _ = blocks.run_stack(x, params["stack"], cfg,
                                    mode="prefill", rope=rope, cache=cache,
                                    ctx=ctx)
            kv["pos"].add_(tokens.shape[1])
            return self._logits(params, x), cache
        write = attention.decode_write(
            kv["pos"], tokens.shape[1],
            kv["k"].shape[2] * paxes.rule_size("kv_seq"), n_valid)
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

    def _forward_train(self, params, tokens, positions, extra):
        x, aux = self.hidden_train(params, tokens, positions, extra)
        return self._unembed(params, x), None, aux

    def hidden_train(self, params: Params, tokens: torch.Tensor,
                     positions: torch.Tensor,
                     extra: Optional[Dict[str, torch.Tensor]] = None):
        """The train forward up to the final norm, without the unembedding
        (the fused cross-entropy's input): returns (hidden states (B, S,
        d) in the compute dtype, aux as ``forward``'s)."""
        cfg = self.cfg
        x = layers.embed(tokens, params["embed"], self.compute_dtype)
        ctx, enc_aux = self._context(params, "train", extra, cfg.remat)
        x, aux = blocks.run_stack(x, params["stack"], cfg, mode="train",
                                  rope=self._rope(positions), ctx=ctx,
                                  remat=cfg.remat)
        if enc_aux is not None:
            aux = aux + enc_aux
        return layers.rms_norm(x, params["final_norm"], cfg.norm_eps), aux

    def _logits(self, params, x):
        x = layers.rms_norm(x, params["final_norm"], self.cfg.norm_eps)
        return self._unembed(params, x)

    def _unembed(self, params, x):
        emb = params["embed"] if self.cfg.tie_embeddings else params["unembed"]
        return layers.unembed(x, emb, self.cfg.padded_vocab).float()


def build_model(cfg: ModelConfig, device=None) -> LM:
    return LM(cfg, device=device)
