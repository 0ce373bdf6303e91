"""ctypes bindings of the CUDA ELL SpMV kernels (csrc/spmv.cu).

``spmv_ell`` is the counterpart of the TPU launcher
(``repro.kernels.spmv.kernel.spmv_ell``) with ``idiom="take"``,
``spmv_ell_onehot`` with ``idiom="onehot"``.  Each checks device, dtype,
shape and contiguity, allocates the output with ``torch.empty``,
launches on the current stream without synchronising, and raises if the
launch returns a CUDA error.  ``spmv_ell.launches`` and
``spmv_ell_onehot.launches`` count the kernel launches made through
them.
"""
from __future__ import annotations

import ctypes
import functools
import pathlib

import torch

from repro_torch.kernels import common

SOURCES = (pathlib.Path(__file__).parent / "csrc" / "spmv.cu",)
ONEHOT_PER_LANE = 4       # nonzeros a lane holds in a pass (K > 4)
ONEHOT_MAX_LANES = 32     # lanes of a row
ONEHOT_X_CHUNK = 16384    # x floats staged in shared memory at a time


def onehot_plan(K: int, C: int):
    """(lanes, per_lane, passes, chunk) of the one-hot kernel: a row's K
    nonzeros go to ``lanes`` lanes (a power of two) holding ``per_lane``
    each a pass, four where K > 4 (so one broadcast of x feeds sixteen
    compare-selects a lane), in ``passes`` passes; x is staged ``chunk``
    floats at a time (C rounded up to 4, at most ``ONEHOT_X_CHUNK``)."""
    if K <= ONEHOT_PER_LANE:
        lanes, per_lane = 1, 1 << max(K - 1, 0).bit_length()
    else:
        lanes = min(1 << (-(-K // ONEHOT_PER_LANE) - 1).bit_length(),
                    ONEHOT_MAX_LANES)
        per_lane = ONEHOT_PER_LANE
    passes = -(-K // (lanes * per_lane))
    chunk = min(max(-(-C // 4) * 4, 4), ONEHOT_X_CHUNK)
    return lanes, per_lane, passes, chunk


@functools.lru_cache(maxsize=None)
def load_library() -> ctypes.CDLL:
    """Build (at first use) and load the kernel library, once a process."""
    lib = common.build_library("spmv", SOURCES)
    p, i = ctypes.c_void_p, ctypes.c_int
    common.bind(lib, "spmv_ell_launch", p, p, p, p, i, i, i, i)
    common.bind(lib, "spmv_onehot_launch", p, p, p, p, *[i] * 7)
    return lib


def _operands(vals, cols, x):
    dev = vals.device
    common.require_hopper(dev)
    if vals.dim() != 2 or x.dim() != 1:
        raise ValueError(f"vals must be (R, K) and x (C,), got "
                         f"{tuple(vals.shape)} and {tuple(x.shape)}")
    common.check_operand("vals", vals, torch.float32, dev)
    common.check_operand("cols", cols, torch.int32, dev, vals.shape)
    common.check_operand("x", x, torch.float32, dev)
    return torch.empty((vals.shape[0], 1), dtype=torch.float32, device=dev)


def spmv_ell(vals: torch.Tensor, cols: torch.Tensor, x: torch.Tensor, *,
             block_multiplier: int = 1) -> torch.Tensor:
    """vals (R, K) fp32, cols (R, K) int32, x (C,) fp32, contiguous on a
    Hopper card.  Returns y (R, 1) fp32.  ``block_multiplier`` in {1, 2,
    4, 8} is the rows each lane group walks."""
    common.check_multiplier(block_multiplier)
    y = _operands(vals, cols, x)
    R, Kn = vals.shape
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


def spmv_ell_onehot(vals: torch.Tensor, cols: torch.Tensor,
                    x: torch.Tensor) -> torch.Tensor:
    """The one-hot idiom: vals (R, K) fp32, cols (R, K) int32, x (C,)
    fp32, contiguous on a Hopper card.  Returns y (R, 1) fp32; a column
    outside [0, C) contributes 0.  Every nonzero is compared with every
    column of x (R * K * C compare-selects)."""
    y = _operands(vals, cols, x)
    R, Kn = vals.shape
    if R == 0:
        return y
    C = x.shape[0]
    lib = load_library()
    err = lib.spmv_onehot_launch(vals.data_ptr(), cols.data_ptr(),
                                 x.data_ptr(), y.data_ptr(), R, Kn, C,
                                 *onehot_plan(Kn, C), common.stream_of(vals))
    common.check_launch(lib, "spmv_onehot_launch", err)
    spmv_ell_onehot.launches += 1
    return y


spmv_ell_onehot.launches = 0
