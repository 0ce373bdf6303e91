"""Plain PyTorch versions of the flash-attention forward and of the
dense-cache decode: the CPU paths and the on-card oracles of the CUDA
kernels.

``flash_fwd`` computes exactly what the kernel computes over the grouped
layout of ``ops._group``: q (BN, R, H) with row ``r`` the query column
``r % sq_real``, k/v (BN, Skv, H); the mask ``kv_pos < Skv`` and, when
causal, ``kv_pos <= r % sq_real``; the softcap ``softcap * tanh(s /
softcap)`` applied before the mask.  It takes a full masked softmax in
fp32 (the kernel's online softmax is the same function) and returns
``out`` in q's dtype and the per-row log-sum-exp ``lse`` in fp32, the
residual the backward recomputes the probabilities from.

``flash_decode`` is the twin of the TPU decode kernel (``_decode_kernel``)
in the layout of its JAX op: queries (B, Sq, NQ, H) against a whole K/V
cache (B, S, NKV, H), GQA by grouping the G = NQ / NKV query heads of a
KV head.  A query attends to the keys ``t < kv_valid``; scores, softmax
and P.V are fp32, and a query with no valid key comes out all zero, as
the kernel's ``acc / max(l, 1e-30)`` gives.  ``flash_decode_split`` is
the same function as the kernel's KV split computes it: per-split
partials folded in rank order, then normalized.
"""
from __future__ import annotations

import torch

NEG_INF = -1e30
# the forward kernel's tolerance against ``flash_fwd``, (rtol, atol) of
# ``out`` by dtype.  fp32: the sums in another order.  bf16: both versions
# compute in fp32 and round once to bf16, so they are at most one bf16 ulp
# apart, which is 2^-7 = 7.8e-3 of the value at most.  ``lse``: 1e-4, 1e-4.
FLASH_TOL = {torch.float32: (1e-4, 1e-4), torch.bfloat16: (8e-3, 1e-4)}
LSE_TOL = (1e-4, 1e-4)


def flash_fwd(q, k, v, *, causal: bool = True, softcap: float = 0.0,
              sq_real: int = 0):
    """q: (BN, R, H); k/v: (BN, Skv, H); ``sq_real`` 0 means R.

    Returns ``(out (BN, R, H) in q.dtype, lse (BN, R) fp32)``."""
    BN, R, H = q.shape
    Skv = k.shape[1]
    sq = sq_real or R
    s = torch.einsum("brh,bkh->brk", q.float(), k.float()) * (H ** -0.5)
    if softcap:
        s = softcap * torch.tanh(s / softcap)
    if causal:
        kv_pos = torch.arange(Skv, device=q.device)[None, :]
        q_pos = (torch.arange(R, device=q.device) % sq)[:, None]
        s = torch.where(kv_pos <= q_pos, s, NEG_INF)
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp(s - m)
    l = p.sum(dim=-1, keepdim=True).clamp_min(1e-30)
    out = torch.einsum("brk,bkh->brh", p, v.float()) / l
    lse = (m + torch.log(l)).squeeze(-1)
    return out.to(q.dtype), lse


def flash_decode(q, k, v, kv_valid, *, softcap: float = 0.0):
    """q: (B, Sq, NQ, H); k/v: (B, S, NKV, H); kv_valid: (B,) (every
    query of row b attends to keys ``t < kv_valid[b]``) or (B, Sq) (query
    c to ``t < kv_valid[b, c]``).  Returns (B, Sq, NQ, H) in q's dtype."""
    B, Sq, NQ, H = q.shape
    S, NKV = k.shape[1], k.shape[2]
    G = NQ // NKV
    lens = kv_valid.reshape(B, -1).expand(B, Sq)
    qg = q.float().reshape(B, Sq, NKV, G, H)
    s = torch.einsum("bcngh,btnh->bcngt", qg, k.float()) * (H ** -0.5)
    if softcap:
        s = softcap * torch.tanh(s / softcap)
    mask = (torch.arange(S, device=q.device)[None, None]
            < lens[..., None])[:, :, None, None]          # (B, Sq, 1, 1, S)
    s = torch.where(mask, s, NEG_INF)
    p = torch.exp(s - s.amax(dim=-1, keepdim=True)) * mask
    l = p.sum(dim=-1, keepdim=True).clamp_min(1e-30)
    out = torch.einsum("bcngt,btnh->bcngh", p, v.float()) / l
    return out.reshape(B, Sq, NQ, H).to(q.dtype)


def flash_decode_split(q, k, v, kv_valid, *, splits: int,
                       tokens_per_split: int, softcap: float = 0.0):
    """``flash_decode`` as the kernel's cluster split computes it: split s
    covers cache tokens [s * tokens_per_split, (s + 1) * tokens_per_split)
    and holds (m, l, acc) over its valid keys (the neutral m = NEG_INF,
    l = 0, acc = 0 where it has none); the splits are folded in rank
    order, m the largest m_s and l and acc sums of l_s and acc_s times
    exp(m_s - m), added split by split; out = acc / max(l, 1e-30)."""
    B, Sq, NQ, H = q.shape
    S, NKV = k.shape[1], k.shape[2]
    G = NQ // NKV
    lens = kv_valid.reshape(B, -1).expand(B, Sq)
    qg = q.float().reshape(B, Sq, NKV, G, H)
    s = torch.einsum("bcngh,btnh->bcngt", qg, k.float()) * (H ** -0.5)
    if softcap:
        s = softcap * torch.tanh(s / softcap)
    t = torch.arange(S, device=q.device)
    valid = t[None, None] < lens[..., None]                  # (B, Sq, S)
    parts = []
    for sp in range(splits):
        lo, hi = sp * tokens_per_split, (sp + 1) * tokens_per_split
        mask = (valid & (t >= lo) & (t < hi))[:, :, None, None]
        ss = torch.where(mask, s, NEG_INF)
        m = ss.amax(dim=-1)
        p = torch.where(mask, torch.exp(ss - m[..., None]), 0.0)
        parts.append((m, p.sum(dim=-1),
                      torch.einsum("bcngt,btnh->bcngh", p, v.float())))
    m = torch.stack([pt[0] for pt in parts]).amax(dim=0)
    l = torch.zeros_like(parts[0][1])
    acc = torch.zeros_like(parts[0][2])
    for m_s, l_s, acc_s in parts:
        w = torch.exp(m_s - m)
        l = l + l_s * w
        acc = acc + acc_s * w[..., None]
    out = acc / l.clamp_min(1e-30)[..., None]
    return out.reshape(B, Sq, NQ, H).to(q.dtype)
