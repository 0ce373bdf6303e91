"""ctypes binding of the CUDA direct conv2d kernel (csrc/conv2d.cu).

``conv2d_same`` is the counterpart of the TPU launcher
(``repro.kernels.conv2d.kernel.conv2d_same``): x (N, H, W, Cin) and w
(kh, kw, Cin, Cout) fp32 in, (N, H, W, Cout) fp32 out.  It checks
device, dtype, shape, contiguity and the shared memory the filter needs,
allocates the output with ``torch.empty``, launches on the current stream
without synchronising, and raises if the launch returns a CUDA error.
``conv2d_same.launches`` counts the kernel launches made through it.
"""
from __future__ import annotations

import ctypes
import functools
import pathlib

import torch

from repro_torch.kernels import common

SOURCES = (pathlib.Path(__file__).parent / "csrc" / "conv2d.cu",)
MAX_SMEM_BYTES = 232448          # what one Hopper block may use


@functools.lru_cache(maxsize=None)
def load_library() -> ctypes.CDLL:
    """Build (at first use) and load the kernel library, once a process."""
    lib = common.build_library("conv2d", SOURCES)
    p, i = ctypes.c_void_p, ctypes.c_int
    common.bind(lib, "conv2d_launch", p, p, p, *[i] * 8)
    lib.conv2d_smem_bytes.argtypes = [i, i]
    lib.conv2d_smem_bytes.restype = ctypes.c_longlong
    return lib


def conv2d_same(x: torch.Tensor, w: torch.Tensor, *, bh: int
                ) -> torch.Tensor:
    """x (N, H, W, Cin), w (kh, kw, Cin, Cout): contiguous fp32 on a Hopper
    card; ``bh`` output rows per block, H % bh == 0."""
    dev = x.device
    common.require_hopper(dev)
    if x.dim() != 4 or w.dim() != 4 or w.shape[2] != x.shape[3]:
        raise ValueError(f"conv2d: x {tuple(x.shape)} (NHWC) and w "
                         f"{tuple(w.shape)} (HWIO) do not match")
    N, H, W, Cin = x.shape
    kh, kw, _, Cout = w.shape
    if bh < 1 or H % bh:
        raise ValueError(f"conv2d: H={H} is not a multiple of block_h={bh}")
    common.check_operand("x", x, torch.float32, dev)
    common.check_operand("w", w, torch.float32, dev)
    lib = load_library()
    smem = lib.conv2d_smem_bytes(kh, kw)
    if smem > MAX_SMEM_BYTES:
        raise ValueError(f"conv2d: a {kh}x{kw} filter needs {smem} bytes of "
                         f"shared memory per block, over {MAX_SMEM_BYTES}")
    out = torch.empty((N, H, W, Cout), dtype=torch.float32, device=dev)
    if out.numel() == 0:
        return out
    err = lib.conv2d_launch(x.data_ptr(), w.data_ptr(), out.data_ptr(), N, H,
                            W, Cin, Cout, kh, kw, bh, common.stream_of(x))
    common.check_launch(lib, "conv2d_launch", err)
    conv2d_same.launches += 1
    return out


conv2d_same.launches = 0
