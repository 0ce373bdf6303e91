"""ELL SpMV entry (counterpart of ``repro.kernels.spmv.ops.spmv_ell``).

Two idioms, as in the JAX package: ``"take"`` (the gather: ``x[cols]``)
and ``"onehot"`` (the TPU's one-hot contraction: every nonzero compared
with every column of x, so a column outside [0, C) contributes 0).  A
CPU tensor runs the idiom's plain version (``ref.spmv_ell``,
``ref.spmv_ell_onehot``); a CUDA tensor launches its CUDA kernel
(``kernel.spmv_ell``, ``kernel.spmv_ell_onehot``) or raises — there is
no fallback.  ``block_multiplier`` is checked for both and sets the
take kernel's rows a lane group walks; the one-hot kernel has no such
knob.  Any other idiom raises ``ValueError``.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.common import check_multiplier
from repro_torch.kernels.spmv import kernel as K
from repro_torch.kernels.spmv import ref


def spmv_ell(vals, cols, x, *, idiom="take", block_multiplier=1
             ) -> torch.Tensor:
    """vals/cols: (R, K) ELL data; x: (C,).  Returns y: (R, 1)."""
    check_multiplier(block_multiplier)
    if idiom not in ("take", "onehot"):
        raise ValueError(idiom)
    cpu = vals.device.type == "cpu"
    if idiom == "onehot":
        return (ref.spmv_ell_onehot(vals, cols, x) if cpu
                else K.spmv_ell_onehot(vals, cols, x))
    if cpu:
        return ref.spmv_ell(vals, cols, x)
    return K.spmv_ell(vals, cols, x, block_multiplier=block_multiplier)
