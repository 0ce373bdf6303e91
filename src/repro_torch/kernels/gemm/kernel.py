"""ctypes binding of the CUDA GEMM kernel (csrc/gemm.cu).

``gemm`` is the counterpart of the TPU launcher
(``repro.kernels.gemm.kernel.gemm``): a (M, K) and b (K, N), both fp32 or
both fp64, in; c (M, N) of the same type out.  It checks device, dtype,
shape and contiguity, allocates the output with ``torch.empty``,
launches on the current stream without synchronising, and raises if the
launch returns a CUDA error.  ``gemm.launches`` counts the kernel
launches made through it.
"""
from __future__ import annotations

import ctypes
import functools
import pathlib

import torch

from repro_torch.kernels import common

SOURCES = (pathlib.Path(__file__).parent / "csrc" / "gemm.cu",)
DTYPES = {torch.float32: 0, torch.float64: 1}


@functools.lru_cache(maxsize=None)
def load_library() -> ctypes.CDLL:
    """Build (at first use) and load the kernel library, once a process."""
    lib = common.build_library("gemm", SOURCES)
    p, i = ctypes.c_void_p, ctypes.c_int
    common.bind(lib, "gemm_launch", p, p, p, i, i, i, i, i)
    return lib


def gemm(a: torch.Tensor, b: torch.Tensor, *,
         block_multiplier: int = 1) -> torch.Tensor:
    """a (M, K), b (K, N): contiguous, both fp32 or both fp64, on a
    Hopper card.  ``block_multiplier`` in {1, 2, 4, 8} scales the
    per-thread register tile (and so the block tile)."""
    dev = a.device
    common.require_hopper(dev)
    common.check_multiplier(block_multiplier)
    if a.dim() != 2 or b.dim() != 2 or a.shape[1] != b.shape[0]:
        raise ValueError(f"gemm: shapes {tuple(a.shape)} @ "
                         f"{tuple(b.shape)} do not chain")
    if a.dtype not in DTYPES:
        raise ValueError(f"gemm kernel takes {list(DTYPES)}, got {a.dtype}")
    M, K = a.shape
    N = b.shape[1]
    common.check_operand("a", a, a.dtype, dev)
    common.check_operand("b", b, a.dtype, dev)
    c = torch.empty((M, N), dtype=a.dtype, device=dev)
    if M == 0 or N == 0:
        return c
    lib = load_library()
    err = lib.gemm_launch(a.data_ptr(), b.data_ptr(), c.data_ptr(), M, N, K,
                          DTYPES[a.dtype], block_multiplier,
                          common.stream_of(a))
    common.check_launch(lib, "gemm_launch", err)
    gemm.launches += 1
    return c


gemm.launches = 0
