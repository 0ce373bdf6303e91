"""GEMM entry (counterpart of ``repro.kernels.gemm.ops.gemm``).

A CPU tensor runs the plain version (``ref.gemm``); a CUDA tensor
launches the CUDA kernel (``kernel.gemm``) or raises — there is no
fallback.  Types are fp32 and fp64 on either device; other types raise.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.common import check_multiplier
from repro_torch.kernels.gemm import kernel as K
from repro_torch.kernels.gemm import ref


def gemm(a, b, *, block_multiplier=1, bk=512, out_dtype=None
         ) -> torch.Tensor:
    """C = A @ B in the inputs' type (fp32 or fp64), cast to ``out_dtype``
    if given.  ``bk`` is the JAX kernel's K block, which sizes its VMEM
    tile; it is checked and kept for the same call sites, but Hopper's
    shared memory takes a fixed 64-byte K slice, so it does not change
    the kernel."""
    check_multiplier(block_multiplier)
    if int(bk) != bk or bk < 1:
        raise ValueError(f"bk must be a positive integer, got {bk}")
    if a.dtype not in K.DTYPES or b.dtype != a.dtype:
        raise ValueError(f"gemm takes fp32 or fp64 operands of one type, "
                         f"got {a.dtype} and {b.dtype}")
    if a.device.type == "cpu":
        return ref.gemm(a, b, out_dtype)
    c = K.gemm(a, b, block_multiplier=block_multiplier)
    return c if out_dtype in (None, c.dtype) else c.to(out_dtype)
