"""Plain PyTorch versions of paged flash-decode: the CPU path and the
on-card oracle of the CUDA kernel.

``paged_attention`` is the gather oracle of
``repro.kernels.paged_attention.ref``: it gathers every row's pages into a
dense cache view, repeats KV heads up to the query heads and runs a full
masked softmax.  ``paged_partials`` computes exactly what the kernel
computes — grouped fp32 ``(acc, m, l)`` partials — by the same gather.
``split_partials`` follows the kernel's KV split: partials over each
split's token range, folded in rank order as the cluster's rank 0 folds
them.
"""
from __future__ import annotations

import torch

NEG_INF = -1e30


def paged_attention(q, k_pages, v_pages, page_idx, positions, kv_valid_len,
                    *, softcap: float = 0.0):
    """q: (B, Sq, NQ, H); k_pages/v_pages: (P, page_size, NKV, H) pool;
    page_idx: (B, pages_per_seq) int (any layout — rows gathered);
    positions: (B, Sq) query positions; kv_valid_len: (B,).

    KV token t of row b is attended by query column c iff
    ``t <= positions[b, c]`` and ``t < kv_valid_len[b]``.  Rows with
    ``kv_valid_len == 0`` return all-zero outputs, NaN-free."""
    B, Sq, NQ, H = q.shape
    NKV = k_pages.shape[2]
    G = NQ // NKV
    k = k_pages[page_idx.long()].reshape(B, -1, NKV, H)     # (B, L, NKV, H)
    v = v_pages[page_idx.long()].reshape(B, -1, NKV, H)
    L = k.shape[1]
    k = k.repeat_interleave(G, dim=2).transpose(1, 2).float()  # (B, NQ, L, H)
    v = v.repeat_interleave(G, dim=2).transpose(1, 2).float()
    qT = q.transpose(1, 2).float()                           # (B, NQ, Sq, H)
    s = torch.einsum("bnqh,bnkh->bnqk", qT, k) * (H ** -0.5)
    if softcap:
        s = softcap * torch.tanh(s / softcap)
    kv_pos = torch.arange(L, device=q.device)[None, None, None, :]
    mask = kv_pos <= positions[:, None, :, None]
    mask &= kv_pos < kv_valid_len[:, None, None, None]
    s = torch.where(mask, s, NEG_INF)
    m = s.amax(dim=-1, keepdim=True)
    p = torch.where(mask, torch.exp(s - m), 0.0)
    l = p.sum(dim=-1, keepdim=True).clamp_min(1e-30)
    out = torch.einsum("bnqk,bnkh->bnqh", p / l, v)
    return out.transpose(1, 2).to(q.dtype)                   # (B, Sq, NQ, H)


def paged_partials(qg, k_pages, v_pages, page_idx, pos0, kv_valid, *,
                   sq: int, softcap: float = 0.0):
    """The kernel's function, plainly: qg (B, NKV, G*Sq, H) grouped
    queries (row r is query column r % sq at position pos0 + r % sq);
    k/v_pages (P, page, NKV, H); page_idx (B, pps); pos0 / kv_valid (B,).

    Returns fp32 ``(acc, m, l)`` shaped (B, NKV, G*Sq, H) / (B, NKV, G*Sq)
    / (B, NKV, G*Sq).  Masked scores add exactly 0 to ``l`` and ``acc``;
    a row with nothing to attend has ``m = NEG_INF`` and ``l = 0``."""
    return _range_partials(qg, k_pages, v_pages, page_idx, pos0, kv_valid,
                           sq=sq, softcap=softcap, lo=0, hi=None)


def split_partials(qg, k_pages, v_pages, page_idx, pos0, kv_valid, *,
                   sq: int, splits: int, tokens_per_split: int,
                   softcap: float = 0.0):
    """``paged_partials`` as the kernel's KV split computes it: split s
    covers table tokens [s * tokens_per_split, (s + 1) * tokens_per_split)
    (a split at or past a row's kv_valid holds the neutral partial m =
    NEG_INF, l = 0, acc = 0), and the splits' partials are folded in rank
    order: m = the largest m_s, then l and acc are sums of l_s and acc_s
    times exp(m_s - m), added split by split."""
    parts = [_range_partials(qg, k_pages, v_pages, page_idx, pos0, kv_valid,
                             sq=sq, softcap=softcap,
                             lo=s * tokens_per_split,
                             hi=(s + 1) * tokens_per_split)
             for s in range(splits)]
    m = torch.stack([p[1] for p in parts]).amax(dim=0)
    acc = torch.zeros_like(parts[0][0])
    l = torch.zeros_like(parts[0][2])
    for acc_s, m_s, l_s in parts:
        w = torch.exp(m_s - m)
        l = l + l_s * w
        acc = acc + acc_s * w[..., None]
    return acc, m, l


def _range_partials(qg, k_pages, v_pages, page_idx, pos0, kv_valid, *,
                    sq, softcap, lo, hi):
    """Partials over table tokens lo <= t < hi (hi None: no bound)."""
    B, NKV, R, H = qg.shape
    k = k_pages[page_idx.long()].reshape(B, -1, NKV, H).transpose(1, 2)
    v = v_pages[page_idx.long()].reshape(B, -1, NKV, H).transpose(1, 2)
    L = k.shape[2]
    s = torch.einsum("bnrh,bnlh->bnrl", qg.float(), k.float()) * (H ** -0.5)
    if softcap:
        s = softcap * torch.tanh(s / softcap)
    dev = qg.device
    t = torch.arange(L, device=dev)[None, None, :]            # (1, 1, L)
    qpos = (pos0[:, None, None]
            + (torch.arange(R, device=dev) % sq)[None, :, None])  # (B, R, 1)
    mask = (t <= qpos) & (t < kv_valid[:, None, None])        # (B, R, L)
    mask &= t >= lo
    if hi is not None:
        mask &= t < hi
    mask = mask[:, None]                                      # (B, 1, R, L)
    s = torch.where(mask, s, NEG_INF)
    m = s.amax(dim=-1)
    p = torch.where(mask, torch.exp(s - m[..., None]), 0.0)
    l = p.sum(dim=-1)
    acc = torch.einsum("bnrl,bnlh->bnrh", p, v.float())
    return acc, m, l
