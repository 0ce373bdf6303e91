"""GQA attention: train-mode causal attention, and decode-mode steps
against the KV cache, paged or dense.

Counterpart of ``repro.models.attention``.  Train half: ``attn_train``
dispatches on ``cfg.attention_impl`` as the reference does —
``reference`` is the port of the jnp chunked flash (``chunked_attention``:
an online softmax over KV chunks with its own memory-flat backward, the
comparison point), ``pallas`` the hand-written CUDA flash kernel
(``kernels/flash_attention``).  Decode half: projections with optional
qk-norm, RoPE, the ragged ``n_valid`` KV write, and then one of the
reference's two decode attentions: ``_paged_attention_with_cache``, which
views the cache as a page pool and runs ``kernels/paged_attention``, or
the dense-cache ``_full_attention_with_cache``, which on the card is one
launch of the flash-decode kernel (``kernels/flash_attention``) over the
cache in place.  Where the reference enters a global ``paged_decode``
context, the port passes a ``PagedDecodeState`` as an argument; ``None``
(no context) selects the dense-cache path, as in the reference.  Prefill
half: ``attn_prefill``, causal attention over a prompt through
``chunked_attention`` that fills the cache's first S positions.  Cross
half (vlm, audio): ``project_cross_kv`` and ``cross_attn``, non-causal
attention to a read-only context (image embeddings, encoder output)
without RoPE; over the context itself through ``chunked_attention``, or
over its installed K/V, which on the card is one launch of the
flash-decode kernel with every key valid.  A gated cross-attention's
output is scaled by ``tanh(gate_attn)``.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional

import torch
import torch.nn.functional as F

from repro_torch.kernels.flash_attention import ops as fa_ops
from repro_torch.kernels.paged_attention import ops as pa_ops
from repro_torch.models import layers
from repro_torch.models.layers import dense, rms_norm_nd


@dataclasses.dataclass
class PagedDecodeState:
    """page_idx: (B, pages_per_seq) int32 tensor of page ids into the pool
    view of the cache, or ``None`` for the row-local identity map (the
    engine's batch-1 prefill rows).  ``splits``: the paged kernel's KV
    split count (the engine's tuned one, on its pure-decode forward);
    ``None`` lets ``split_plan`` pick.  The CPU twin ignores it, as the
    reference's ``xla`` twin ignores ``block_pages``."""
    page_idx: Optional[torch.Tensor]
    page_size: int
    splits: Optional[int] = None


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
    y = dense(out.reshape(B, S, -1), params["wo"])
    if "gate_attn" in params:               # gated cross-attention
        y = torch.tanh(params["gate_attn"].to(y.dtype)) * y
    return y


# ---------------------------------------------------------------------------
# train: chunked online-softmax reference and the flash kernel
# ---------------------------------------------------------------------------
NEG_INF = fa_ops.NEG_INF


def _chunk_attend(q, k_c, v_c, m, l, acc, *, scale, softcap, mask):
    """One online-softmax step.  q: (B,N,Sq,H) fp32; k_c/v_c: (B,N,Ck,H);
    mask: (Sq, Ck) boolean (True = attend)."""
    s = torch.einsum("bnqh,bnkh->bnqk", q, k_c.float()) * scale
    if softcap:
        s = softcap * torch.tanh(s / softcap)
    s = torch.where(mask, s, NEG_INF)
    m_new = torch.maximum(m, s.amax(dim=-1))
    corr = torch.exp(m - m_new)
    p = torch.exp(s - m_new[..., None])
    l_new = l * corr + p.sum(dim=-1)
    # p rounded to V's dtype, accumulated in fp32, as the reference does
    acc_new = acc * corr[..., None] + torch.einsum(
        "bnqk,bnkh->bnqh", p.to(v_c.dtype).float(), v_c.float())
    return m_new, l_new, acc_new


def _expand_kv(q, k, v):
    """Broadcast KV heads to query heads; transpose to (B,N,S,H)."""
    G = q.shape[2] // k.shape[2]
    k = k.repeat_interleave(G, dim=2)
    v = v.repeat_interleave(G, dim=2)
    return q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2)


def _chunk_mask(Sq, kv_chunk, c_idx, causal, skv_real, device):
    """(Sq, Ck) mask of KV chunk ``c_idx``."""
    q_pos = torch.arange(Sq, device=device)[:, None]
    kv_pos = c_idx * kv_chunk + torch.arange(kv_chunk, device=device)[None]
    mask = kv_pos < skv_real
    if causal:
        return mask & (kv_pos <= q_pos)
    return mask.expand(Sq, kv_chunk)


def _flash_fwd_impl(qT, kT, vT, causal, softcap, skv_real, kv_chunk):
    """qT: (B,N,Sq,H) fp32; kT/vT: (B,N,n_chunks*kv_chunk,H).  Returns
    out, m, l (fp32), skipping chunks wholly above the causal diagonal."""
    B, N, Sq, H = qT.shape
    m = torch.full((B, N, Sq), NEG_INF, dtype=torch.float32,
                   device=qT.device)
    l = torch.zeros((B, N, Sq), dtype=torch.float32, device=qT.device)
    acc = torch.zeros((B, N, Sq, H), dtype=torch.float32, device=qT.device)
    for c in range(kT.shape[2] // kv_chunk):
        if causal and Sq - 1 < c * kv_chunk:
            break
        sl = slice(c * kv_chunk, (c + 1) * kv_chunk)
        mask = _chunk_mask(Sq, kv_chunk, c, causal, skv_real, qT.device)
        m, l, acc = _chunk_attend(qT, kT[:, :, sl], vT[:, :, sl], m, l, acc,
                                  scale=H ** -0.5, softcap=softcap,
                                  mask=mask)
    out = acc / l.clamp_min(1e-30)[..., None]
    return out, m, l


class _Flash(torch.autograd.Function):
    """The jnp flash's custom VJP: forward saves (q, k, v, out, lse); the
    backward (``flash_backward``) recomputes each chunk's probabilities
    from ``lse``, so only out + lse are kept per layer."""

    @staticmethod
    def forward(ctx, qT, kT, vT, causal, softcap, skv_real, kv_chunk):
        out, m, l = _flash_fwd_impl(qT, kT, vT, causal, softcap, skv_real,
                                    kv_chunk)
        lse = m + torch.log(l.clamp_min(1e-30))
        ctx.save_for_backward(qT, kT, vT, out, lse)
        ctx.opts = (causal, softcap, skv_real, kv_chunk)
        return out

    @staticmethod
    def backward(ctx, dout):
        causal, softcap, skv_real, kv_chunk = ctx.opts
        qT, kT, vT, out, lse = ctx.saved_tensors
        B, N, Sq, H = qT.shape
        flat = lambda t: t.reshape(B * N, t.shape[2], H)     # noqa: E731
        grads = fa_ops.flash_backward(
            flat(qT), flat(kT), flat(vT), flat(out),
            lse.reshape(B * N, Sq), flat(dout.contiguous()), causal=causal,
            softcap=softcap, sq_real=Sq, skv_real=skv_real,
            kv_chunk=kv_chunk)
        dq, dk, dv = (g.reshape(B, N, -1, H) for g in grads)
        return dq, dk, dv, None, None, None, None


def chunked_attention(q, k, v, *, causal: bool, softcap: float = 0.0,
                      kv_chunk: int = 1024):
    """q: (B, Sq, NQ, H); k/v: (B, Skv, NKV, H) -> (B, Sq, NQ, H) in q's
    dtype.  The port of the reference's jnp flash: K/V heads repeated to
    the query heads, padded to whole chunks, online softmax in fp32."""
    B, Sq, NQ, H = q.shape
    Skv = k.shape[1]
    kv_chunk = min(kv_chunk, Skv)
    pad = -Skv % kv_chunk
    if pad:
        k = F.pad(k, (0, 0, 0, 0, 0, pad))
        v = F.pad(v, (0, 0, 0, 0, 0, pad))
    qT, kT, vT = _expand_kv(q, k, v)
    out = _Flash.apply(qT.float(), kT, vT, causal, float(softcap), Skv,
                       kv_chunk)
    return out.transpose(1, 2).to(q.dtype)                   # (B,Sq,NQ,H)


def attn_train(params, x, cfg, *, rope, causal: bool = True):
    """Train-mode attention over the whole sequence, causal unless
    ``causal=False`` (the audio encoder).  ``rope`` is the forward's fp32
    (cos, sin) pair; ``cfg.attention_impl`` picks the jnp flash port
    (``reference``) or the CUDA flash kernel (``pallas``)."""
    q = _project_q(params, x, cfg)
    k, v = _project_kv(params, x, cfg)
    if cfg.rope_theta > 0:
        q = layers.apply_rope(q, *rope)
        k = layers.apply_rope(k, *rope)
    if cfg.attention_impl == "pallas":
        out = fa_ops.flash_attention(q, k, v, causal=causal,
                                     softcap=cfg.attn_logit_softcap)
    elif cfg.attention_impl == "reference":
        out = chunked_attention(q, k, v, causal=causal,
                                softcap=cfg.attn_logit_softcap)
    else:
        raise ValueError(f"attention_impl {cfg.attention_impl!r}")
    return _out_proj(params, out)


# ---------------------------------------------------------------------------
# prefill
# ---------------------------------------------------------------------------
def attn_prefill(params, x, cfg, *, rope, cache) -> torch.Tensor:
    """Prefill: causal attention over the prompt, and its K/V written to
    positions [0, S) of ``cache`` ({"k", "v"}: (B, S_cache, NKV, H),
    updated **in place**).  The caller advances ``pos`` by S once for the
    whole stack.  As in the reference, the attention is the jnp flash's
    port (``chunked_attention``), not a kernel.  ``rope`` is the
    forward's fp32 (cos, sin) pair."""
    S = x.shape[1]
    q = _project_q(params, x, cfg)
    k, v = _project_kv(params, x, cfg)
    if cfg.rope_theta > 0:
        q = layers.apply_rope(q, *rope)
        k = layers.apply_rope(k, *rope)
    out = chunked_attention(q, k, v, causal=True,
                            softcap=cfg.attn_logit_softcap)
    cache["k"][:, :S].copy_(k)
    cache["v"][:, :S].copy_(v)
    return _out_proj(params, out)


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
                paged: Optional[PagedDecodeState] = None) -> torch.Tensor:
    """Decode-mode attention: write this step's K/V into ``cache``
    ({"k", "v"}: (B, S_cache, NKV, H), updated **in place**), then attend
    over it: through the paged kernel under ``paged`` (a page map of the
    cache's pool view), else through the dense-cache attention.

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
    if paged is not None:
        out = _paged_attention_with_cache(
            q, cache["k"], cache["v"], paged, positions=positions,
            kv_valid_len=write.kv_valid, softcap=cfg.attn_logit_softcap)
    else:
        out = _full_attention_with_cache(
            q, cache["k"], cache["v"], positions=positions,
            kv_valid_len=write.kv_valid, softcap=cfg.attn_logit_softcap)
    return _out_proj(params, out)


def query_lens(positions, kv_valid_len, S_cache: int) -> torch.Tensor:
    """(B, Sq) int32 valid length of each query: the reference's mask
    ``t <= positions[b, c] && t < kv_valid_len[b]`` is ``t <
    min(positions[b, c] + 1, kv_valid_len[b])``, clamped to [0,
    S_cache]."""
    lens = torch.minimum(positions + 1, kv_valid_len[:, None].to(
        positions.dtype))
    return lens.clamp(0, S_cache).to(torch.int32)


def _full_attention_with_cache(q, k, v, *, positions, kv_valid_len, softcap):
    """Dense-cache attention: q (B, Sq, NQ, H) against the whole cache
    k/v (B, S_cache, NKV, H) under the reference's mask.

    On the CPU, the reference's jnp code as it is: K/V heads repeated to
    the query heads, fp32 scores, a full softmax, ``p`` rounded to the
    cache's dtype before P.V (a query with no valid key gets the uniform
    mean of v).  On the card, one launch of the flash-decode kernel over
    the cache in place, with a valid length a query (``query_lens``): fp32
    ``p``, and zeros for a query with no valid key.  The two agree on
    every query with a valid key, which is every query whose output a
    caller commits."""
    if q.device.type != "cpu":
        return fa_ops.flash_decode(
            q, k, v, query_lens(positions, kv_valid_len, k.shape[1]),
            softcap=softcap)
    B, Sq, NQ, H = q.shape
    Skv, NKV = k.shape[1], k.shape[2]
    G = NQ // NKV
    kT = k.repeat_interleave(G, dim=2).transpose(1, 2)      # (B,NQ,Skv,H)
    vT = v.repeat_interleave(G, dim=2).transpose(1, 2)
    qT = q.transpose(1, 2).float()
    s = torch.einsum("bnqh,bnkh->bnqk", qT, kT.float()) * (H ** -0.5)
    if softcap:
        s = softcap * torch.tanh(s / softcap)
    kv_pos = torch.arange(Skv, device=q.device)[None, None, None, :]
    mask = kv_pos <= positions[:, None, :, None]
    mask &= kv_pos < kv_valid_len[:, None, None, None]
    s = torch.where(mask, s, NEG_INF)
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bnqk,bnkh->bnqh", p.to(v.dtype).float(), vT.float())
    return out.transpose(1, 2).to(q.dtype)


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
        page_size=ps.page_size, softcap=softcap, splits=ps.splits)


# ---------------------------------------------------------------------------
# cross-attention (vlm, audio)
# ---------------------------------------------------------------------------
def project_cross_kv(params, ctx, cfg):
    """K/V (B, T, NKV, H) of a read-only context ``ctx`` (B, T, d), no
    RoPE: what the engine installs into a slot's row at admission and
    decode steps then only read."""
    return _project_kv(params, ctx, cfg)


def cross_attn(params, x, cfg, *, ctx=None, cached_kv=None):
    """Non-causal attention of x (B, S, d) to a static context, no RoPE.

    ``ctx`` (B, T, d) (train, prefill): K/V projected from it, attended
    through ``chunked_attention`` as in the reference; returns (y, (k,
    v)) for the caller to cache.  ``cached_kv`` (k, v), each (B, T, NKV,
    H) (decode mode): the installed K/V, every key valid, through the
    flash-decode op over the cache in place with each query's valid
    length T (on the card one kernel launch).  Returns (y, None)."""
    q = _project_q(params, x, cfg)
    softcap = cfg.attn_logit_softcap
    if ctx is not None:
        k, v = project_cross_kv(params, ctx, cfg)
        out = chunked_attention(q, k, v, causal=False, softcap=softcap)
        return _out_proj(params, out), (k, v)
    k, v = cached_kv
    lens = torch.full((q.shape[0],), k.shape[1], dtype=torch.int32,
                      device=q.device)
    out = fa_ops.flash_decode(q, k, v, lens, softcap=softcap)
    return _out_proj(params, out), None


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
