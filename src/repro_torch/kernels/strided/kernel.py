"""ctypes binding of the CUDA strided-gather kernels (csrc/strided.cu).

``strided_rowwise`` and ``overfetch_select`` are the counterparts of the
TPU launchers of the same names (``repro.kernels.strided.kernel``): a
(rows, cols) fp32 array in, every ``stride``-th row out, as
``cdiv(rows, stride)`` and ``rows // stride`` rows respectively.  Each
checks device, dtype and contiguity, allocates the output with
``torch.empty``, launches on the current stream without synchronising,
and raises if the launch returns a CUDA error.  Their ``.launches``
count the kernel launches made through each.
"""
from __future__ import annotations

import ctypes
import functools
import pathlib

import torch

from repro_torch.kernels import common

SOURCES = (pathlib.Path(__file__).parent / "csrc" / "strided.cu",)
SUBLANE = 8          # output rows per block of overfetch_select, times m


@functools.lru_cache(maxsize=None)
def load_library() -> ctypes.CDLL:
    """Build (at first use) and load the kernel library, once a process."""
    lib = common.build_library("strided", SOURCES)
    ll, i = ctypes.c_longlong, ctypes.c_int
    common.bind(lib, "strided_launch", ctypes.c_void_p, ctypes.c_void_p, ll,
                ll, i, i, i, i)
    return lib


def check_stride(stride: int) -> int:
    if stride < 1:
        raise ValueError(f"stride must be >= 1, got {stride}")
    return stride


def _launch(x: torch.Tensor, stride: int, idiom: int, out_rows: int,
            br: int) -> torch.Tensor:
    dev = x.device
    common.require_hopper(dev)
    if x.dim() != 2:
        raise ValueError(f"x must be (rows, cols), got {tuple(x.shape)}")
    common.check_operand("x", x, torch.float32, dev)
    rows, cols = x.shape
    out = torch.empty((out_rows, cols), dtype=x.dtype, device=dev)
    if out.numel() == 0:
        return out
    vec = cols % 4 == 0 and x.data_ptr() % 16 == 0
    lib = load_library()
    err = lib.strided_launch(x.data_ptr(), out.data_ptr(), rows, cols,
                             stride, idiom, br, int(vec),
                             common.stream_of(x))
    common.check_launch(lib, "strided_launch", err)
    return out


def strided_rowwise(x: torch.Tensor, stride: int) -> torch.Tensor:
    """out[i] = x[i * stride] for i < cdiv(rows, stride); only the rows
    needed are read (the vlse idiom)."""
    check_stride(stride)
    out = _launch(x, stride, 0, -(-x.shape[0] // stride), 1)
    if out.numel():
        strided_rowwise.launches += 1
    return out


def overfetch_select(x: torch.Tensor, stride: int, *,
                     block_multiplier: int = 1) -> torch.Tensor:
    """out[i] = x[i * stride] for i < rows // stride; every row of each
    group of ``stride`` is read and row 0 kept (the masked-vle idiom).
    A block owns ``8 * block_multiplier`` output rows."""
    check_stride(stride)
    common.check_multiplier(block_multiplier)
    out = _launch(x, stride, 1, x.shape[0] // stride,
                  SUBLANE * block_multiplier)
    if out.numel():
        overfetch_select.launches += 1
    return out


strided_rowwise.launches = 0
overfetch_select.launches = 0
