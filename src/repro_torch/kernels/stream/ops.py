"""STREAM entry (counterpart of ``repro.kernels.stream.ops.stream``).

A CPU tensor runs the plain version (``ref.py``); a CUDA tensor launches
the CUDA kernel (``kernel.stream_call``) or raises — there is no
fallback.  ``block_multiplier`` is checked as in the JAX package on
either device; on the card it sets the vectors each thread moves.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.common import check_multiplier
from repro_torch.kernels.stream import kernel as K
from repro_torch.kernels.stream import ref

KINDS = K.KINDS


def stream(kind, x, y=None, alpha=2.0, *, block_multiplier=1
           ) -> torch.Tensor:
    """x, y: (rows, lane) arrays (lane 128 in the benchmarks).  Returns
    copy ``x``, scale ``alpha*x``, add ``x+y`` or triad ``x+alpha*y``."""
    check_multiplier(block_multiplier)
    if kind not in KINDS:
        raise ValueError(kind)
    if kind in ("add", "triad") and y is None:
        raise ValueError(f"stream {kind!r} needs y")
    if x.device.type == "cpu":
        return ref.stream(kind, x, y, alpha)
    return K.stream_call(kind, x, y, alpha,
                         block_multiplier=block_multiplier)
