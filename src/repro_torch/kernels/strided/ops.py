"""Strided row gather entry (counterpart of
``repro.kernels.strided.ops.strided_gather``).

A CPU tensor runs the plain version (``ref.py``); a CUDA tensor launches
the CUDA kernel of the idiom (``kernel.strided_rowwise`` or
``kernel.overfetch_select``) or raises — there is no fallback.  The two
idioms keep the JAX package's output lengths: ``cdiv(rows, stride)`` rows
for ``strided_rowwise`` and ``rows // stride`` for ``overfetch_select``.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.common import check_multiplier
from repro_torch.kernels.strided import kernel as K
from repro_torch.kernels.strided import ref

IDIOMS = ("strided_rowwise", "overfetch_select")


def strided_gather(x, stride: int, idiom: str = "overfetch_select", *,
                   block_multiplier: int = 1) -> torch.Tensor:
    """x: (rows, lane) array.  Returns every ``stride``-th row."""
    if idiom not in IDIOMS:
        raise ValueError(idiom)
    K.check_stride(stride)
    rowwise = idiom == "strided_rowwise"
    if not rowwise:
        check_multiplier(block_multiplier)
    if x.device.type == "cpu":
        return ref.strided_gather(
            x, stride, None if rowwise else x.shape[0] // stride)
    if rowwise:
        return K.strided_rowwise(x, stride)
    return K.overfetch_select(x, stride, block_multiplier=block_multiplier)
