"""ELL SpMV entry (counterpart of ``repro.kernels.spmv.ops.spmv_ell``).

A CPU tensor runs the plain version (``ref.spmv_ell``); a CUDA tensor
launches the CUDA kernel (``kernel.spmv_ell``) or raises — there is no
fallback.  Only the gather idiom is ported: ``idiom="onehot"`` (the TPU's
one-hot contraction, ``_spmv_onehot_kernel``) waits in ROADMAP B8.
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
    if idiom == "onehot":
        raise NotImplementedError(
            "spmv idiom 'onehot' (the TPU's _spmv_onehot_kernel) is not "
            "ported yet: ROADMAP B8")
    if idiom != "take":
        raise ValueError(idiom)
    if vals.device.type == "cpu":
        return ref.spmv_ell(vals, cols, x)
    return K.spmv_ell(vals, cols, x, block_multiplier=block_multiplier)
