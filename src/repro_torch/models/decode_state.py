"""DecodeState protocol (dense, moe, ssm and hybrid families): the
slotted cache and its row primitives.

Counterpart of ``repro.models.decode_state``.  An adapter lays the
whole per-slot decode state out as a dict of tensors whose every leaf
has a batch ("slot") axis named by its spec tuple; the engine drives it
through ``state_row`` / ``set_state_row`` / ``reset_state_slots``
without knowing the family.  Unlike the reference's pure functions,
these update in place: ``state_row`` returns *views* into the slotted
state, so a batch-1 forward on a row writes straight into its slot and
``set_state_row`` has nothing left to copy.
"""
from __future__ import annotations

from typing import Any, Callable, Dict

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


def reset_state_slots(state: Params, specs: Params,
                      slot_mask: torch.Tensor) -> Params:
    """Zero, in place, the rows of the slots selected by ``slot_mask``
    (B,) bool — the slot-recycling primitive of the paged cache."""
    def reset(leaf, ax):
        shape = [1] * leaf.dim()
        shape[ax] = leaf.shape[ax]
        return leaf.masked_fill_(slot_mask.view(shape), 0)
    return _map(reset, state, specs)


class DecodeStateAdapter:
    """What the engine may ask of a family's decode state.

    ``token_addressable``: the state is a per-token prefix (KV entries
    and position counters) that can be truncated or copied by token.
    ``prefix_cachable``: the prefix cache may share it between requests.
    ``paged``: the family attends through the paged KV cache, so the
    engine hands the forward a page map."""

    token_addressable = True
    prefix_cachable = False
    paged = False

    def context_tokens(self, cfg) -> int:
        return 0


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


_ADAPTERS = {"dense": AttentionDecodeState(), "moe": AttentionDecodeState(),
             "ssm": SSMDecodeState(), "hybrid": HybridDecodeState()}
# the reference's families the port has not ported yet
NOT_PORTED = ("vlm", "audio")


def get_adapter(family: str) -> DecodeStateAdapter:
    if family not in _ADAPTERS:
        raise NotImplementedError(
            f"family {family!r} is not ported yet (the port serves "
            f"{sorted(_ADAPTERS)}; not yet {', '.join(NOT_PORTED)})")
    return _ADAPTERS[family]
