"""DecodeState protocol (every family: dense, moe, ssm, hybrid, vlm and
audio): the slotted cache, its row primitives, and the admission-time
install of a request's read-only context.

Counterpart of ``repro.models.decode_state``.  An adapter lays the
whole per-slot decode state out as a dict of tensors whose every leaf
has a batch ("slot") axis named by its spec tuple; the engine drives it
through ``state_row`` / ``set_state_row`` / ``reset_state_slots``
without knowing the family.  Unlike the reference's pure functions,
these update in place: ``state_row`` returns *views* into the slotted
state, so a batch-1 forward on a row writes straight into its slot and
``set_state_row`` has nothing left to copy.  The cross-attention families
(vlm, audio) keep each cross layer's K/V of the request's context
(image embeddings; the encoder's output over audio frames) beside the
self-attention cache: the engine installs it into the slot's row at
every (re-)admission (``install_context``) and decode steps only read
it.  The serving features have two more primitives, in place too:
``copy_state_prefix`` (the prefix cache's copy of a donor slot's K/V
prefix) and ``adjust_state_counters`` (the speculative rewind of the
position counters).
"""
from __future__ import annotations

from typing import Any, Callable, Dict, Optional, Tuple

import numpy as np
import torch

from repro_torch.models import attention, mamba2

Params = Dict[str, Any]


def _map(fn: Callable, state: Params, specs: Params) -> Params:
    """Apply ``fn(leaf, batch_axis)`` to every leaf; same dict structure."""
    if isinstance(state, dict):
        return {k: _map(fn, state[k], specs[k]) for k in state}
    return fn(state, specs.index("batch"))


def _zip(fn: Callable, state: Params, row: Params, specs: Params) -> None:
    if isinstance(state, dict):
        for k in state:
            _zip(fn, state[k], row[k], specs[k])
        return
    fn(state, row, specs.index("batch"))


def state_row(state: Params, specs: Params, slot: int) -> Params:
    """Batch row ``slot`` as a batch-1 state of views into ``state``."""
    return _map(lambda leaf, ax: leaf.narrow(ax, slot, 1), state, specs)


def set_state_row(state: Params, specs: Params, slot: int,
                  row: Params) -> Params:
    """Write a batch-1 state into batch row ``slot`` (in place; a no-op
    for a row that already is a view of that slot)."""
    def put(leaf, r, ax):
        dst = leaf.narrow(ax, slot, 1)
        if dst.data_ptr() != r.data_ptr():
            dst.copy_(r)
    _zip(put, state, row, specs)
    return state


def state_leaves(state: Params, specs: Params):
    """(leaf, spec) pairs of every leaf, in the dict's order."""
    if isinstance(state, dict):
        for k in state:
            yield from state_leaves(state[k], specs[k])
    else:
        yield state, specs


def _is_counter(leaf: torch.Tensor, spec) -> bool:
    """A per-slot integer counter (the attention cache's ``pos``): an
    integer leaf whose spec names no axis but ``"batch"``."""
    return (not leaf.is_floating_point() and not leaf.is_complex()
            and all(a is None or a == "batch" for a in spec))


def copy_state_prefix(state: Params, specs: Params, src: int, dst: int,
                      n_tokens: int, kv_offset: int = 0) -> Params:
    """Token-range copy between slots, in place: the device half of the
    prefix cache (the reference's ``copy_state_prefix``).

    Every leaf with a ``"kv_seq"`` axis gets the first ``n_tokens``
    entries of slot ``src``'s row in slot ``dst``'s row, and zeros past
    them; every per-slot integer counter (``pos``) is set to
    ``n_tokens`` in ``dst``; every other leaf (the cross K/V, which the
    engine installs again after the copy) is left alone.  ``src == dst``
    trims in place: only the entries past ``n_tokens`` are zeroed.  The
    source rows are read before anything of ``dst`` is written, and for
    ``src != dst`` the two rows do not overlap.  Only adapters with
    ``prefix_cachable`` may be driven through this.  ``kv_offset``: the
    cache position of the leaves' first ``kv_seq`` entry, where a rank
    holds a slice of the cache length (its part of the prefix is the
    first ``n_tokens - kv_offset`` entries, clamped to the slice)."""
    for leaf, spec in state_leaves(state, specs):
        bax = spec.index("batch")
        if "kv_seq" in spec:
            tax = spec.index("kv_seq")
            n = min(max(n_tokens - kv_offset, 0), leaf.shape[tax])
            row = leaf.narrow(bax, dst, 1)
            if src != dst:
                row.narrow(tax, 0, n).copy_(
                    leaf.narrow(bax, src, 1).narrow(tax, 0, n))
            row.narrow(tax, n, leaf.shape[tax] - n).zero_()
        elif _is_counter(leaf, spec):
            leaf.narrow(bax, dst, 1).fill_(n_tokens)
    return state


def adjust_state_counters(state: Params, specs: Params,
                          delta: torch.Tensor) -> Params:
    """Subtract the per-slot ``delta`` (B,) from every per-slot integer
    counter, in place: the speculative rewind to the accepted frontier
    (the reference's ``adjust_state_counters``).  K/V entries past the
    rewound counter stay, invisible under the ``kv_valid`` mask, and the
    next step overwrites them.  Only for ``token_addressable``
    adapters."""
    for leaf, spec in state_leaves(state, specs):
        if _is_counter(leaf, spec):
            shape = [1] * leaf.dim()
            bax = spec.index("batch")
            shape[bax] = leaf.shape[bax]
            leaf.sub_(delta.to(leaf.dtype).view(shape))
    return state


def reset_state_slots(state: Params, specs: Params,
                      slot_mask: torch.Tensor) -> Params:
    """Zero, in place, the rows of the slots selected by ``slot_mask``
    (B,) bool — the slot-recycling primitive of the paged cache."""
    def reset(leaf, ax):
        shape = [1] * leaf.dim()
        shape[ax] = leaf.shape[ax]
        return leaf.masked_fill_(slot_mask.view(shape), 0)
    return _map(reset, state, specs)


def ensure_request_context(arr):
    """The one (T, d)-or-(1, T, d) per-request context shape rule, shared
    by ``ContinuousBatchingEngine.submit`` (host side, numpy) and the
    adapters' install (device side, torch).  A batched (B, T, d) array —
    the static engine's convention — is refused, so an install can never
    write B consecutive slots."""
    if arr.ndim == 2:
        arr = arr[None]
    if arr.ndim != 3 or arr.shape[0] != 1:
        raise ValueError(
            f"per-request context must be (T, d) or (1, T, d); got "
            f"{tuple(arr.shape)}")
    return arr


def stub_context(cfg, rng, batch: Optional[int] = None,
                 scale: float = 0.02) -> Optional[Dict[str, np.ndarray]]:
    """Random stub frontend context satisfying a family's required extra
    inputs, drawn from the numpy generator ``rng`` as the reference's:
    per-request (T, d) arrays, or batched (B, T, d) with ``batch`` (the
    static engine's convention).  ``None`` for a family without
    context (no draw is made)."""
    adapter = get_adapter(cfg.family)
    out = {}
    for key in adapter.requires_extra:
        t = adapter.context_tokens(cfg)
        shape = ((t, cfg.d_model) if batch is None
                 else (batch, t, cfg.d_model))
        out[key] = (rng.standard_normal(shape) * scale).astype(np.float32)
    return out or None


class DecodeStateAdapter:
    """What the engine may ask of a family's decode state.

    ``token_addressable``: the state is a per-token prefix (KV entries
    and position counters) that can be truncated or copied by token.
    ``prefix_cachable``: the prefix cache may share it between requests.
    ``paged``: the family attends through the paged KV cache, so the
    engine hands the forward a page map.  ``requires_extra``: the
    context keys a request must bring (``submit(extra=…)``)."""

    token_addressable = True
    prefix_cachable = False
    paged = False
    requires_extra: Tuple[str, ...] = ()

    def context_tokens(self, cfg) -> int:
        return 0

    def install_context(self, model, params, row: Params,
                        extra: Dict[str, Any]) -> None:
        """Write a request's read-only context into its batch-1 ``row``
        (views into the slot) at admission.  Default: the family has no
        such state."""


class AttentionDecodeState(DecodeStateAdapter):
    """dense and moe: layer-stacked K/V plus one position counter per
    slot."""

    prefix_cachable = True
    paged = True

    def init(self, model, batch: int, max_len: int) -> Params:
        cfg = model.cfg
        return attention.init_cache(cfg, cfg.n_layers, batch, max_len,
                                    model.compute_dtype, model.device)

    def specs(self, model) -> Params:
        return attention.cache_specs()


class SSMDecodeState(DecodeStateAdapter):
    """ssm: one recurrent state (conv window + SSD ``h``) per layer,
    layer-stacked; no position counter and no KV."""

    token_addressable = False

    def init(self, model, batch: int, max_len: int) -> Params:
        cfg = model.cfg
        return mamba2.init_state(cfg, cfg.n_layers, batch,
                                 model.compute_dtype, model.device)

    def specs(self, model) -> Params:
        return mamba2.state_specs()


class HybridDecodeState(DecodeStateAdapter):
    """hybrid (jamba): one attention K/V a period (and one position
    counter a slot) under ``"attn"``, and one recurrent state a mamba
    sub-layer, period-major, under ``"ssm"``.  The recurrent state cannot
    be cut to a token prefix; the attention layers attend through the
    paged cache, as the reference's do."""

    token_addressable = False
    paged = True

    def init(self, model, batch: int, max_len: int) -> Params:
        cfg = model.cfg
        n = model.n_periods
        return {
            "attn": attention.init_cache(cfg, n, batch, max_len,
                                         model.compute_dtype, model.device),
            "ssm": mamba2.init_state(cfg, n * (cfg.attn_period - 1), batch,
                                     model.compute_dtype, model.device),
        }

    def specs(self, model) -> Params:
        return {"attn": attention.cache_specs(),
                "ssm": mamba2.state_specs()}


class _CrossContextDecodeState(DecodeStateAdapter):
    """vlm and audio: the self-attention K/V (one entry a self-attention
    layer, one position counter a slot) under ``"self"``, attended
    through the paged cache as the reference's; and read-only cross K/V
    over the context, one entry a cross layer, under ``"cross_k"`` /
    ``"cross_v"``, installed at admission.  The prompt's K/V depends on
    the context, so a prefix key is seeded with its hash
    (``cache.context_key``)."""

    prefix_cachable = True
    paged = True
    axis = ""               # the cross K/V's token axis, by its spec name

    def n_self(self, model) -> int:
        return model.cfg.n_layers

    def init(self, model, batch: int, max_len: int) -> Params:
        cfg = model.cfg
        shape = (model.n_periods, batch, self.context_tokens(cfg),
                 cfg.n_kv_heads, cfg.resolved_head_dim)
        state = {"self": attention.init_cache(
            cfg, self.n_self(model), batch, max_len, model.compute_dtype,
            model.device)}
        for key in ("cross_k", "cross_v"):
            state[key] = torch.zeros(shape, dtype=model.compute_dtype,
                                     device=model.device)
        return state

    def specs(self, model) -> Params:
        spec = (None, "batch", self.axis, "kv_heads", None)
        return {"self": attention.cache_specs(), "cross_k": spec,
                "cross_v": spec}

    def context(self, model, params, ctx: torch.Tensor) -> torch.Tensor:
        """What the cross layers attend to, from the request's (1, T, d)
        context."""
        return ctx

    def install_context(self, model, params, row, extra):
        """Project the context through every cross layer's K/V and copy
        it into the row's ``cross_k`` / ``cross_v`` in place."""
        (key,) = self.requires_extra
        ctx = torch.as_tensor(extra[key]).to(model.device,
                                             model.compute_dtype)
        ctx = self.context(model, params, ensure_request_context(ctx))
        for c, xattn in enumerate(model.cross_attention_params(params)):
            k, v = attention.project_cross_kv(xattn, ctx, model.cfg)
            row["cross_k"][c].copy_(k)
            row["cross_v"][c].copy_(v)


class VLMDecodeState(_CrossContextDecodeState):
    """vlm: a period's (period - 1) self-attention layers, period-major,
    and its cross layer's K/V over the image tokens."""

    requires_extra = ("image_embeds",)
    axis = "image_tokens"

    def context_tokens(self, cfg) -> int:
        return cfg.num_image_tokens

    def n_self(self, model) -> int:
        return model.n_periods * (model.cfg.cross_attn_period - 1)


class AudioDecodeState(_CrossContextDecodeState):
    """audio (whisper enc-dec): one self-attention K/V and one cross K/V
    over the encoder's output a decoder layer; the encoder runs at
    install, once a request."""

    requires_extra = ("audio_frames",)
    axis = "audio_ctx"

    def context_tokens(self, cfg) -> int:
        return cfg.n_audio_ctx

    def context(self, model, params, ctx):
        return model.encode_audio(params, ctx)[0]


_ADAPTERS = {"dense": AttentionDecodeState(), "moe": AttentionDecodeState(),
             "ssm": SSMDecodeState(), "hybrid": HybridDecodeState(),
             "vlm": VLMDecodeState(), "audio": AudioDecodeState()}


def get_adapter(family: str) -> DecodeStateAdapter:
    if family not in _ADAPTERS:
        raise ValueError(
            f"no DecodeState adapter registered for family {family!r}; "
            f"known: {sorted(_ADAPTERS)}")
    return _ADAPTERS[family]
