"""Losses: masked cross-entropy over a padded vocab.

Counterpart of ``repro.train.losses.cross_entropy``.  The gold logit is
taken with ``gather``: the reference's one-hot contraction over the
(B, S, V) logits keeps a vocab-sharded layout local on a TPU mesh, which
the port does not have.  ``fused_cross_entropy`` is not ported yet.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch


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
        logits = logits.masked_fill(pad, -1e30)
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
