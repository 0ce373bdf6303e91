"""ctypes binding of the CUDA SSD chunked scan (csrc/ssd_scan.cu).

``ssd_scan_fwd`` is the counterpart of the TPU kernel's launcher
(``repro.kernels.ssd_scan.kernel.ssd_scan``) over the model's layout:
x (b, S, H, P), dt (b, S, H), B/C (b, S, N), A/D (b*H,) in, all fp32;
``y`` (b, S, H, P) and the final state ``h_final`` (b, H, P, N) out.  It
checks device, dtype, shape and contiguity, allocates the outputs with
``torch.empty``, launches on the current stream without synchronising,
and raises if the launch returns a CUDA error.  ``ssd_scan_fwd.launches``
counts the kernel launches made through it.
"""
from __future__ import annotations

import ctypes
import functools
import pathlib

import torch

from repro_torch.kernels import common

SOURCES = (pathlib.Path(__file__).parent / "csrc" / "ssd_scan.cu",)
HEAD_DIMS = (16, 32, 64)              # P
STATE_DIMS = (16, 32, 64, 128)        # N
MAX_CHUNK = 1024
_MAX_STREAMS = 2 ** 31 - 1            # the grid's x dimension


@functools.lru_cache(maxsize=None)
def load_library() -> ctypes.CDLL:
    """Build (at first use) and load the kernel library, once a process."""
    lib = common.build_library("ssd_scan", SOURCES)
    p, i = ctypes.c_void_p, ctypes.c_int
    common.bind(lib, "ssd_scan_launch", *[p] * 8, *[i] * 6)
    return lib


def ssd_scan_fwd(x, dt, B, C, A, D, *, chunk: int):
    """x: (b, S, H, P); dt: (b, S, H); B/C: (b, S, N); A/D: (b*H,); all
    fp32, contiguous, on a Hopper card.

    Returns ``(y (b, S, H, P), h_final (b, H, P, N))``, both fp32."""
    dev = x.device
    common.require_hopper(dev)
    b, S, H, P = x.shape
    N = B.shape[-1]
    if P not in HEAD_DIMS:
        raise ValueError(f"head_dim {P}: the kernel takes {HEAD_DIMS}")
    if N not in STATE_DIMS:
        raise ValueError(f"d_state {N}: the kernel takes {STATE_DIMS}")
    if not 1 <= chunk <= MAX_CHUNK:
        raise ValueError(f"chunk {chunk} not in [1, {MAX_CHUNK}]")
    if b * H > _MAX_STREAMS:
        raise ValueError(f"{b * H} streams > {_MAX_STREAMS}")
    f32 = torch.float32
    common.check_operand("x", x, f32, dev)
    common.check_operand("dt", dt, f32, dev, (b, S, H))
    common.check_operand("B", B, f32, dev, (b, S, N))
    common.check_operand("C", C, f32, dev, (b, S, N))
    common.check_operand("A", A, f32, dev, (b * H,))
    common.check_operand("D", D, f32, dev, (b * H,))
    y = torch.empty((b, S, H, P), dtype=f32, device=dev)
    h_final = torch.empty((b, H, P, N), dtype=f32, device=dev)
    if b * H == 0:
        return y, h_final
    lib = load_library()
    err = lib.ssd_scan_launch(
        x.data_ptr(), dt.data_ptr(), B.data_ptr(), C.data_ptr(),
        A.data_ptr(), D.data_ptr(), y.data_ptr(), h_final.data_ptr(), b, S,
        H, P, N, chunk, common.stream_of(x))
    common.check_launch(lib, "ssd_scan_launch", err)
    ssd_scan_fwd.launches += 1
    return y, h_final


ssd_scan_fwd.launches = 0
