"""Tail-handling entry (counterpart of
``repro.kernels.tailmask.ops.tail_compute``).

A CPU tensor runs the plain version (``ref.py``); a CUDA tensor launches
the CUDA kernel of the idiom (``kernel.exact_tail`` or
``kernel.masked_full``) or raises — there is no fallback.  On either
device ``masked_full`` raises ``ValueError`` unless ``block_rows``
divides the rows (the JAX kernel asserts it).
"""
from __future__ import annotations

import torch

from repro_torch.kernels.tailmask import kernel as K
from repro_torch.kernels.tailmask import ref

IDIOMS = ("exact_tail", "masked_full")


def tail_compute(x, idiom: str = "exact_tail", n_valid=None, *,
                 block_rows: int = 8) -> torch.Tensor:
    """x: (rows, lane).  Returns silu(x) * 2; ``masked_full`` writes 0 at
    every flat index >= ``n_valid``."""
    if idiom not in IDIOMS:
        raise ValueError(idiom)
    K.check_block_rows(block_rows)
    if idiom == "masked_full":
        if n_valid is None:
            raise ValueError("masked_full needs n_valid")
        K.check_divides(x.shape[0], block_rows)
    if x.device.type == "cpu":
        return (ref.compute(x) if idiom == "exact_tail"
                else ref.compute_masked(x, n_valid))
    if idiom == "exact_tail":
        return K.exact_tail(x, block_rows=block_rows)
    return K.masked_full(x, n_valid, block_rows=block_rows)
