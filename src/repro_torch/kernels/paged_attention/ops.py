"""Paged flash-decode entry: dispatch by device, normalization, combine.

``paged_attention`` has the signature and layouts of
``repro.kernels.paged_attention.ops.paged_attention``.  It groups the
queries as (B, NKV, G*Sq, H) — GQA by query grouping, no K/V head
repeat — and computes fp32 ``(acc, m, l)`` partials: a CPU tensor runs
the plain version (``ref.paged_partials``); a CUDA tensor launches the
CUDA kernel (``kernel.paged_flash_decode``) or raises — there is no
fallback.  The normalization ``acc / max(l, 1e-30)`` is a torch op, as
``_finalize`` is jnp in the reference.

``decode_partials`` is the SP-KV half: grouped (m, l, acc) partials over a
dense slice of the cache whose first position is ``kv_offset``, which
``models.attention._attn_decode_spkv`` combines across the slices.  On
the card it is the same kernel over the slice viewed as one page a row,
with the mask shifted by the offset.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels.paged_attention import kernel as K
from repro_torch.kernels.paged_attention import ref


def _finalize(m, l, acc, dtype):
    """(B, NKV, G, Sq[, H]) partials -> normalized (B, Sq, NQ, H)."""
    B, NKV, G, Sq, H = acc.shape
    out = acc / l.clamp_min(1e-30)[..., None]
    out = out.reshape(B, NKV * G, Sq, H).transpose(1, 2)
    return out.to(dtype)


def paged_attention(q, k_pages, v_pages, page_idx, positions, kv_valid, *,
                    page_size: int, softcap: float = 0.0,
                    return_partials: bool = False,
                    splits: Optional[int] = None):
    """q: (B, Sq, NQ, H); k/v_pages: (P, page_size, NKV, H) pool;
    page_idx: (B, pages_per_seq) int32; positions: (B, Sq) int32 (query
    positions, contiguous per row); kv_valid: (B,) int32 ragged lengths.
    ``splits``: the kernel's KV split count (``kernel.split_plan``'s own
    when ``None``; the engine passes its tuned count); the plain version
    on the CPU takes no split and ignores it.

    Returns (B, Sq, NQ, H) in q.dtype, or fp32 partials ``(m, l, acc)``
    shaped (B, NQ, Sq) / (B, NQ, Sq) / (B, NQ, Sq, H) when
    ``return_partials`` (feed to :func:`combine_partials`)."""
    B, Sq, NQ, H = q.shape
    NKV = k_pages.shape[2]
    G = NQ // NKV
    if k_pages.shape[1] != page_size:
        raise ValueError(f"pool page size {k_pages.shape[1]} != "
                         f"page_size={page_size}")
    qg = q.reshape(B, Sq, NKV, G, H).permute(0, 2, 3, 1, 4)
    qg = qg.reshape(B, NKV, G * Sq, H)
    pos0 = positions[:, 0]
    if q.device.type == "cpu":
        acc, m, l = ref.paged_partials(qg, k_pages, v_pages, page_idx, pos0,
                                       kv_valid, sq=Sq, softcap=softcap)
    else:
        acc, m, l = K.paged_flash_decode(
            qg.to(torch.float32).contiguous(), k_pages, v_pages,
            page_idx.to(torch.int32).contiguous(),
            pos0.to(torch.int32).contiguous(),
            kv_valid.to(torch.int32).contiguous(), sq=Sq, softcap=softcap,
            splits=splits)
    acc = acc.reshape(B, NKV, G, Sq, H)
    m = m.reshape(B, NKV, G, Sq)
    l = l.reshape(B, NKV, G, Sq)
    if return_partials:
        return (m.reshape(B, NQ, Sq), l.reshape(B, NQ, Sq),
                acc.reshape(B, NQ, Sq, H))
    return _finalize(m, l, acc, q.dtype)


def decode_partials(q, k, v, positions, kv_valid, *, kv_offset=0,
                    softcap: float = 0.0):
    """Grouped-GQA flash-decode partials over a dense KV slice (the
    reference's signature; no head repeat).

    q: (B, Sq, NQ, H); k/v: (B, S, NKV, H), cache positions kv_offset ...
    kv_offset + S - 1; positions: (B, Sq) absolute, contiguous per row;
    kv_valid: (B,) absolute; kv_offset: an int or (B,).  Returns fp32
    ``(m, l, acc)`` shaped (B, NQ, Sq) / (B, NQ, Sq) / (B, NQ, Sq, H).

    Each row of the slice is one page of S tokens (``page_idx`` the
    identity), and the mask ``t + off <= pos0 + c && t + off <
    kv_valid`` is the kernel's own with ``pos0 - off`` (negative where a
    chunk's first columns lie before the slice) and ``clamp(kv_valid -
    off, 0, S)``.  A row with no valid key in the slice gets m = NEG_INF,
    l = 0, acc = 0 (the reference's jnp version has l = S and acc the sum
    of v there instead; the cross-slice combine weighs both by exp(NEG_INF
    - m) = 0, and the combined output of a row with no valid key anywhere
    is zero here).  A CPU tensor runs the plain version; a CUDA tensor
    launches the kernel (``decode_partials.launches`` counts those
    launches apart) or raises."""
    B, S, NKV, H = k.shape
    # an int offset stays on the host (no copy to the card, no sync)
    off = (kv_offset.to(device=q.device, dtype=torch.int32)
           if torch.is_tensor(kv_offset) else int(kv_offset))
    pos0 = positions[:, 0].to(torch.int32) - off
    valid = (kv_valid.to(torch.int32) - off).clamp(0, S)
    page_idx = torch.arange(B, dtype=torch.int32,
                            device=q.device).view(B, 1)
    out = paged_attention(q, k, v, page_idx, pos0[:, None], valid,
                          page_size=S,
                          softcap=softcap, return_partials=True)
    if q.device.type != "cpu":
        decode_partials.launches += 1
    return out


decode_partials.launches = 0


def combine_partials(parts, dtype=torch.float32):
    """Fold a list of (m, l, acc) partials (each (B, NQ, Sq)[, H]) into
    the normalized output (B, Sq, NQ, H) — the order-insensitive
    flash-decoding combine."""
    ms = torch.stack([p[0] for p in parts])
    ls = torch.stack([p[1] for p in parts])
    accs = torch.stack([p[2] for p in parts])
    m = ms.amax(dim=0)
    corr = torch.exp(ms - m[None])
    l = (ls * corr).sum(dim=0)
    acc = (accs * corr[..., None]).sum(dim=0)
    out = acc / l.clamp_min(1e-30)[..., None]               # (B, NQ, Sq, H)
    return out.transpose(1, 2).to(dtype)
