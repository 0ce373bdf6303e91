"""conv2d entry (counterpart of ``repro.kernels.conv2d.ops.conv2d_same``).

A CPU tensor runs the plain version (``ref.conv2d_same``); a CUDA tensor
launches the CUDA kernel (``kernel.conv2d_same``) or raises — there is
no fallback.  As in the JAX package, the row block is ``min(block_h, H)``
and H must be a multiple of it.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.conv2d import kernel as K
from repro_torch.kernels.conv2d import ref


def conv2d_same(x, w, *, block_h=8) -> torch.Tensor:
    """x: (N, H, W, Cin); w: (kh, kw, Cin, Cout); stride 1, SAME padding
    (the TPU kernel's: ``(k // 2, k - 1 - k // 2)``)."""
    H = x.shape[1]
    bh = min(block_h, H)
    if bh < 1 or H % bh:
        raise ValueError(f"conv2d_same: H={H} must be a multiple of "
                         f"block_h={bh}")
    if x.device.type == "cpu":
        return ref.conv2d_same(x, w)
    return K.conv2d_same(x, w, bh=bh)
