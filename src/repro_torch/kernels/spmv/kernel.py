"""ctypes binding of the CUDA ELL SpMV kernel (csrc/spmv.cu).

``spmv_ell`` is the counterpart of the TPU launcher
(``repro.kernels.spmv.kernel.spmv_ell`` with ``idiom="take"``).  It
checks device, dtype, shape and contiguity, allocates the output with
``torch.empty``, launches on the current stream without synchronising,
and raises if the launch returns a CUDA error.  ``spmv_ell.launches``
counts the kernel launches made through it.
"""
from __future__ import annotations

import ctypes
import functools
import pathlib

import torch

from repro_torch.kernels import common

SOURCES = (pathlib.Path(__file__).parent / "csrc" / "spmv.cu",)


@functools.lru_cache(maxsize=None)
def load_library() -> ctypes.CDLL:
    """Build (at first use) and load the kernel library, once a process."""
    lib = common.build_library("spmv", SOURCES)
    p, i = ctypes.c_void_p, ctypes.c_int
    common.bind(lib, "spmv_ell_launch", p, p, p, p, i, i, i, i)
    return lib


def spmv_ell(vals: torch.Tensor, cols: torch.Tensor, x: torch.Tensor, *,
             block_multiplier: int = 1) -> torch.Tensor:
    """vals (R, K) fp32, cols (R, K) int32, x (C,) fp32, contiguous on a
    Hopper card.  Returns y (R, 1) fp32.  ``block_multiplier`` in {1, 2,
    4, 8} is the rows each lane group walks."""
    dev = vals.device
    common.require_hopper(dev)
    common.check_multiplier(block_multiplier)
    if vals.dim() != 2 or x.dim() != 1:
        raise ValueError(f"vals must be (R, K) and x (C,), got "
                         f"{tuple(vals.shape)} and {tuple(x.shape)}")
    R, Kn = vals.shape
    common.check_operand("vals", vals, torch.float32, dev)
    common.check_operand("cols", cols, torch.int32, dev, vals.shape)
    common.check_operand("x", x, torch.float32, dev)
    y = torch.empty((R, 1), dtype=torch.float32, device=dev)
    if R == 0:
        return y
    lib = load_library()
    err = lib.spmv_ell_launch(vals.data_ptr(), cols.data_ptr(), x.data_ptr(),
                              y.data_ptr(), R, Kn, x.shape[0],
                              block_multiplier, common.stream_of(vals))
    common.check_launch(lib, "spmv_ell_launch", err)
    spmv_ell.launches += 1
    return y


spmv_ell.launches = 0
