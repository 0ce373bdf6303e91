"""GQA attention for decode-mode steps against a paged KV cache.

Counterpart of ``repro.models.attention``'s decode path: projections
with optional qk-norm, RoPE, the ragged ``n_valid`` KV write, and
``_paged_attention_with_cache``, which views the cache as a page pool
and runs ``kernels/paged_attention``.  Where the reference enters a
global ``paged_decode`` context, the port passes a ``PagedDecodeState``
as an argument.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional

import torch

from repro_torch.kernels.paged_attention import ops as pa_ops
from repro_torch.models import layers
from repro_torch.models.layers import dense, rms_norm_nd


@dataclasses.dataclass
class PagedDecodeState:
    """page_idx: (B, pages_per_seq) int32 tensor of page ids into the pool
    view of the cache, or ``None`` for the row-local identity map (the
    engine's batch-1 prefill rows)."""
    page_idx: Optional[torch.Tensor]
    page_size: int


@dataclasses.dataclass
class DecodeWrite:
    """Where one decode-mode step writes its K/V, shared by every layer.

    ``rows`` / ``cols`` (B, S) index the cache; ``keep`` (B, S) marks the
    columns whose K/V is written — the reference's ``n_valid`` contract:
    a column at or past ``n_valid`` (or past the cache end) is dropped.
    A dropped column's target is ``(pos + c) % S_cache``, distinct from
    every other column's, and gets its old value back, so the write is
    one in-place ``index_put_`` with no data-dependent shape (no host
    sync).  ``kv_valid`` (B,) is ``pos + n_valid``, the attention length
    after the write."""
    rows: torch.Tensor
    cols: torch.Tensor
    keep: torch.Tensor
    kv_valid: torch.Tensor


def decode_write(pos: torch.Tensor, S: int, S_cache: int,
                 n_valid: Optional[torch.Tensor]) -> DecodeWrite:
    B = pos.shape[0]
    c = torch.arange(S, device=pos.device)
    idx = pos[:, None].long() + c[None]                        # (B, S)
    step = (torch.full((B,), S, dtype=torch.int32, device=pos.device)
            if n_valid is None else n_valid.to(torch.int32))
    keep = (c[None] < step[:, None]) & (idx < S_cache)
    rows = torch.arange(B, device=pos.device)[:, None].expand(B, S)
    return DecodeWrite(rows=rows, cols=idx % S_cache, keep=keep,
                       kv_valid=(pos + step).to(torch.int32))


# ---------------------------------------------------------------------------
# projections
# ---------------------------------------------------------------------------
def _project_q(params, x, cfg):
    B, S, _ = x.shape
    q = dense(x, params["wq"]).reshape(B, S, cfg.n_heads,
                                       cfg.resolved_head_dim)
    if cfg.qk_norm:
        q = rms_norm_nd(q, params["q_norm"]["scale"], cfg.norm_eps)
    return q


def _project_kv(params, x, cfg):
    B, S, _ = x.shape
    h, nkv = cfg.resolved_head_dim, cfg.n_kv_heads
    k = dense(x, params["wk"]).reshape(B, S, nkv, h)
    v = dense(x, params["wv"]).reshape(B, S, nkv, h)
    if cfg.qk_norm:
        k = rms_norm_nd(k, params["k_norm"]["scale"], cfg.norm_eps)
    return k, v


def _out_proj(params, out):
    B, S = out.shape[:2]
    return dense(out.reshape(B, S, -1), params["wo"])


# ---------------------------------------------------------------------------
# decode
# ---------------------------------------------------------------------------
def _write_kv(cache_t: torch.Tensor, new: torch.Tensor,
              w: DecodeWrite) -> None:
    """In-place ragged write of ``new`` (B, S, NKV, H) into ``cache_t``
    (B, S_cache, NKV, H): kept columns get ``new``, dropped columns
    their old value (see ``DecodeWrite``)."""
    old = cache_t[w.rows, w.cols]
    val = torch.where(w.keep[..., None, None], new.to(cache_t.dtype), old)
    cache_t.index_put_((w.rows, w.cols), val)


def attn_decode(params, x, cfg, *, positions, rope, cache, write: DecodeWrite,
                paged: PagedDecodeState) -> torch.Tensor:
    """Decode-mode attention: write this step's K/V into ``cache``
    ({"k", "v"}: (B, S_cache, NKV, H), updated **in place**), then attend
    over it through the paged kernel.

    The ragged ``n_valid`` contract of the reference: columns at or past
    a row's ``n_valid`` are not written and the valid length is
    ``pos + n_valid`` (``write``); the caller advances ``pos`` by
    ``n_valid`` once for the whole stack, since every layer writes the
    same positions.  ``rope`` is the step's fp32 (cos, sin) pair."""
    q = _project_q(params, x, cfg)
    k, v = _project_kv(params, x, cfg)
    if cfg.rope_theta > 0:
        q = layers.apply_rope(q, *rope)
        k = layers.apply_rope(k, *rope)
    _write_kv(cache["k"], k, write)
    _write_kv(cache["v"], v, write)
    out = _paged_attention_with_cache(
        q, cache["k"], cache["v"], paged, positions=positions,
        kv_valid_len=write.kv_valid, softcap=cfg.attn_logit_softcap)
    return _out_proj(params, out)


def _paged_attention_with_cache(q, k, v, ps: PagedDecodeState, *, positions,
                                kv_valid_len, softcap):
    """The cache (B, S_cache, NKV, H) is *viewed* as a page pool
    (B*pps, page_size, NKV, H) — a reshape, not a gather — and
    kernels/paged_attention walks it by page id with the ragged mask."""
    B, S_cache, NKV, H = k.shape
    pps = S_cache // ps.page_size
    k_pages = k.view(B * pps, ps.page_size, NKV, H)
    v_pages = v.view(B * pps, ps.page_size, NKV, H)
    page_idx = ps.page_idx
    if page_idx is None:
        # row-local identity map (engine prefill rows run batch=1)
        page_idx = torch.arange(B * pps, dtype=torch.int32,
                                device=k.device).view(B, pps)
    return pa_ops.paged_attention(
        q, k_pages, v_pages, page_idx, positions, kv_valid_len,
        page_size=ps.page_size, softcap=softcap)


# ---------------------------------------------------------------------------
# KV cache
# ---------------------------------------------------------------------------
def init_cache(cfg, n_layers: int, batch: int, max_len: int, dtype,
               device) -> Dict[str, torch.Tensor]:
    """Layer-stacked K/V (n_layers, batch, max_len, NKV, H) and one
    position counter per slot (every layer writes the same positions)."""
    h, nkv = cfg.resolved_head_dim, cfg.n_kv_heads
    shape = (n_layers, batch, max_len, nkv, h)
    return {
        "k": torch.zeros(shape, dtype=dtype, device=device),
        "v": torch.zeros(shape, dtype=dtype, device=device),
        "pos": torch.zeros((batch,), dtype=torch.int32, device=device),
    }


def cache_specs() -> Dict[str, tuple]:
    return {
        "k": (None, "batch", "kv_seq", "kv_heads", None),
        "v": (None, "batch", "kv_seq", "kv_heads", None),
        "pos": ("batch",),
    }
