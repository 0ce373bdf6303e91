"""Losses: masked cross-entropy over a padded vocab, and a fused
(logit-free) cross-entropy that never holds the (B, S, V) logits.

Counterpart of ``repro.train.losses``.  The gold logit is taken with
``gather``: the reference's one-hot contraction over the (B, S, V)
logits keeps a vocab-sharded layout local on a TPU mesh, which the port
does not have.  ``fused_cross_entropy``'s logsumexp is an autograd
Function whose backward recomputes each vocab chunk's logits, so the
backward keeps the forward's O(B*S*vocab_chunk) peak: a plain autograd
loop over the chunks would save every chunk, the whole (B, S, V).
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

NEG = -1e30                  # the masked logit, as the reference's


def cross_entropy(
    logits: torch.Tensor,        # (B, S, V_pad) fp32
    labels: torch.Tensor,        # (B, S) int
    vocab_size: int,             # true (unpadded) vocab
    mask: Optional[torch.Tensor] = None,   # (B, S) 1.0 = count
    z_loss: float = 0.0,
) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    V_pad = logits.shape[-1]
    if V_pad > vocab_size:
        pad = torch.arange(V_pad, device=logits.device) >= vocab_size
        logits = logits.masked_fill(pad, NEG)
    lse = torch.logsumexp(logits, dim=-1)                      # (B, S)
    labels = labels.long()
    gold = logits.gather(-1, labels[..., None]).squeeze(-1)
    nll = lse - gold
    if z_loss > 0:
        nll = nll + z_loss * torch.square(lse)
    if mask is None:
        mask = torch.ones_like(nll)
    denom = mask.sum().clamp_min(1.0)
    loss = (nll * mask).sum() / denom
    with torch.no_grad():
        acc = ((logits.argmax(-1) == labels) * mask).sum() / denom
    return loss, {"nll": loss, "accuracy": acc}


def _chunk_logits(xf, table, lo, hi, vocab_size):
    """fp32 logits of vocab rows [lo, hi), rows past ``vocab_size`` at
    ``NEG``: (B, S, hi - lo)."""
    logit = xf @ table[lo:hi].float().t()
    if hi > vocab_size:
        pos = torch.arange(lo, hi, device=xf.device)
        logit = logit.masked_fill(pos >= vocab_size, NEG)
    return logit


class ChunkedLogSumExp(torch.autograd.Function):
    """``logsumexp(xf @ table.T)`` over the first ``vocab_size`` rows,
    chunk by chunk with an online max and sum (the reference's scan).
    The backward recomputes each chunk's logits: d lse / d logit is the
    softmax, ``exp(logit - lse)``."""

    @staticmethod
    def forward(ctx, xf, table, vocab_size, chunk):
        B, S, _ = xf.shape
        m = torch.full((B, S), NEG, dtype=torch.float32, device=xf.device)
        l = torch.zeros((B, S), dtype=torch.float32, device=xf.device)
        for lo in range(0, table.shape[0], chunk):
            logit = _chunk_logits(xf, table, lo, min(lo + chunk,
                                                     table.shape[0]),
                                  vocab_size)
            m_new = torch.maximum(m, logit.amax(-1))
            l = l * torch.exp(m - m_new) + torch.exp(
                logit - m_new[..., None]).sum(-1)
            m = m_new
        lse = m + torch.log(torch.clamp(l, min=1e-30))
        ctx.save_for_backward(xf, table, lse)
        ctx.opts = (vocab_size, chunk)
        return lse

    @staticmethod
    def backward(ctx, dlse):
        xf, table, lse = ctx.saved_tensors
        vocab_size, chunk = ctx.opts
        want_x, want_t = ctx.needs_input_grad[:2]
        dx = torch.zeros_like(xf) if want_x else None
        dtable = torch.zeros_like(table) if want_t else None
        for lo in range(0, table.shape[0], chunk):
            hi = min(lo + chunk, table.shape[0])
            logit = _chunk_logits(xf, table, lo, hi, vocab_size)
            dlogit = torch.exp(logit - lse[..., None]) * dlse[..., None]
            if want_x:
                dx += dlogit @ table[lo:hi].float()
            if want_t:
                dtable[lo:hi] = torch.einsum(
                    "bsv,bsd->vd", dlogit, xf).to(table.dtype)
        return dx, dtable, None, None


def fused_cross_entropy(
    x: torch.Tensor,             # (B, S, d) final hidden states
    emb_table: torch.Tensor,     # (V_pad, d)
    labels: torch.Tensor,
    vocab_size: int,
    mask: Optional[torch.Tensor] = None,
    vocab_chunk: int = 8192,
) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Cross-entropy over vocab chunks with an online logsumexp: peak
    memory O(B*S*vocab_chunk) instead of O(B*S*V), forward and backward.
    The gold logit is an embedding gather."""
    xf = x.float()
    lse = ChunkedLogSumExp.apply(xf, emb_table, vocab_size, vocab_chunk)
    gold = (xf * emb_table[labels.long()].float()).sum(-1)
    nll = lse - gold
    if mask is None:
        mask = torch.ones_like(nll)
    denom = mask.sum().clamp_min(1.0)
    loss = (nll * mask).sum() / denom
    return loss, {"nll": loss}
