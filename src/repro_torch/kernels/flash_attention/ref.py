"""Plain PyTorch version of the flash-attention forward: the CPU path and
the on-card oracle of the CUDA kernel.

``flash_fwd`` computes exactly what the kernel computes over the grouped
layout of ``ops._group``: q (BN, R, H) with row ``r`` the query column
``r % sq_real``, k/v (BN, Skv, H); the mask ``kv_pos < Skv`` and, when
causal, ``kv_pos <= r % sq_real``; the softcap ``softcap * tanh(s /
softcap)`` applied before the mask.  It takes a full masked softmax in
fp32 (the kernel's online softmax is the same function) and returns
``out`` in q's dtype and the per-row log-sum-exp ``lse`` in fp32, the
residual the backward recomputes the probabilities from.
"""
from __future__ import annotations

import torch

NEG_INF = -1e30


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
