"""ctypes binding of the CUDA SSD chunked scan (csrc/ssd_scan.cu).

``ssd_scan_fwd`` is the counterpart of the TPU kernel's launcher
(``repro.kernels.ssd_scan.kernel.ssd_scan``) over the model's layout:
x (b, S, H, P), dt (b, S, H), B/C (b, S, N), A/D (b*H,) in, all fp32;
``y`` (b, S, H, P) and the final state ``h_final`` (b, H, P, N) out.  It
checks device, dtype, shape, contiguity and alignment, allocates the
outputs and the workspaces (``workspace_shapes``) with ``torch.empty``,
launches on the current stream without synchronising, and raises if the
launch returns a CUDA error.  ``ssd_scan_fwd.launches`` counts the calls
made through it, one a layer; a call issues four kernels (C.B^T, chunk
states, the state pass, chunk outputs), or only the state pass when S is
0.
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
TILE = 64                             # rows of a query, key and C.B^T tile
_MAX_BLOCKS = 2 ** 31 - 1             # the grids' x dimension


def workspace_shapes(b: int, S: int, H: int, P: int, N: int,
                     chunk: int) -> dict:
    """The fp32 workspaces of one call (csrc's contract): C.B^T ``cb``
    (b, nc, Lp, Lp), the within-chunk ``cum`` (b, H, nc, Lp) and the
    chunk ``states`` (b, nc, H, P, N), which the state pass overwrites
    with the state before each chunk; nc = ceil(S / chunk), Lp = chunk
    rounded up to a multiple of TILE."""
    nc = -(-S // chunk)
    Lp = -(-chunk // TILE) * TILE
    return {"cb": (b, nc, Lp, Lp), "cum": (b, H, nc, Lp),
            "states": (b, nc, H, P, N)}


@functools.lru_cache(maxsize=None)
def load_library() -> ctypes.CDLL:
    """Build (at first use) and load the kernel library, once a process."""
    lib = common.build_library("ssd_scan", SOURCES)
    p, i = ctypes.c_void_p, ctypes.c_int
    common.bind(lib, "ssd_scan_launch", *[p] * 11, *[i] * 6)
    return lib


def ssd_scan_fwd(x, dt, B, C, A, D, *, chunk: int,
                 return_states: bool = False):
    """x: (b, S, H, P); dt: (b, S, H); B/C: (b, S, N); A/D: (b*H,); all
    fp32, contiguous (x, B and C starting on a 16-byte boundary), on a
    Hopper card.

    Returns ``(y (b, S, H, P), h_final (b, H, P, N))``, both fp32, and
    with ``return_states`` (tests only) the state before each chunk,
    (b, nc, H, P, N): the states workspace after the state pass."""
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
    ws = workspace_shapes(b, S, H, P, N, chunk)
    _, nc, Lp, _ = ws["cb"]
    T = Lp // TILE                    # query tiles a chunk
    if b * nc * max(H * T, T * (T + 1) // 2) > _MAX_BLOCKS:
        raise ValueError(f"b {b} x {H} heads x {nc} chunks: more blocks "
                         f"than a grid takes")
    f32 = torch.float32
    # the kernels read x, B and C as 16-byte vectors
    common.check_operand("x", x, f32, dev, align=16)
    common.check_operand("dt", dt, f32, dev, (b, S, H))
    common.check_operand("B", B, f32, dev, (b, S, N), align=16)
    common.check_operand("C", C, f32, dev, (b, S, N), align=16)
    common.check_operand("A", A, f32, dev, (b * H,))
    common.check_operand("D", D, f32, dev, (b * H,))
    y = torch.empty((b, S, H, P), dtype=f32, device=dev)
    h_final = torch.empty((b, H, P, N), dtype=f32, device=dev)
    if b * H == 0:
        return (y, h_final, y.new_empty(ws["states"])) if return_states \
            else (y, h_final)
    cb, cum, states = (torch.empty(ws[k], dtype=f32, device=dev)
                       for k in ("cb", "cum", "states"))
    lib = load_library()
    err = lib.ssd_scan_launch(
        x.data_ptr(), dt.data_ptr(), B.data_ptr(), C.data_ptr(),
        A.data_ptr(), D.data_ptr(), y.data_ptr(), h_final.data_ptr(),
        cb.data_ptr(), cum.data_ptr(), states.data_ptr(), b, S, H, P, N,
        chunk, common.stream_of(x))
    common.check_launch(lib, "ssd_scan_launch", err)
    ssd_scan_fwd.launches += 1
    return (y, h_final, states) if return_states else (y, h_final)


ssd_scan_fwd.launches = 0
