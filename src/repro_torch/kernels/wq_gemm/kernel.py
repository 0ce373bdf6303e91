"""ctypes binding of the CUDA weight-only int8 GEMM (csrc/wq_gemm.cu).

``wq_gemm`` is the counterpart of the TPU launcher
(``repro.kernels.wq_gemm.kernel.wq_gemm``): x (M, K) fp32 or bf16, q int8
(K, N) — or (N, K) with ``q_transposed`` — and scale (N,) fp32 in; y (M,
N) out, in x's type or fp32.  It checks device, dtype, shape and
contiguity, allocates the output (and, for a K split, the fp32 partials)
with ``torch.empty``, launches on the current stream without
synchronising, and raises if the launch returns a CUDA error.
``wq_gemm.launches`` counts the kernel launches made through it.
"""
from __future__ import annotations

import ctypes
import functools
import pathlib

import torch

from repro_torch.kernels import common

SOURCES = (pathlib.Path(__file__).parent / "csrc" / "wq_gemm.cu",)
DTYPES = {torch.float32: 0, torch.bfloat16: 1}
SMALL_M = 8           # rows up to which the GEMV kernels run
KN_COLS = 64          # columns a GEMV block of the (K, N) layout owns
KN_TILE = 256         # a K split is a whole number of these rows
_counters = {}        # (device, stream) -> the K split's ticket counters


@functools.lru_cache(maxsize=None)
def load_library() -> ctypes.CDLL:
    """Build (at first use) and load the kernel library, once a process."""
    lib = common.build_library("wq_gemm", SOURCES)
    p, i = ctypes.c_void_p, ctypes.c_int
    common.bind(lib, "wq_gemm_launch", *[p] * 6, *[i] * 9)
    return lib


@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def k_split(M: int, N: int, K: int, transposed: bool, sms: int):
    """(splits, rows a split) of the (K, N) GEMV: as many blocks as two a
    SM hold (one wave), each split a whole number of ``KN_TILE`` rows."""
    if M > SMALL_M or transposed or K <= KN_TILE:
        return 1, max(K, 1)
    strips = -(-N // KN_COLS)
    want = min(max(2 * sms // strips, 1), -(-K // KN_TILE))
    rows = -(-K // want)
    rows = -(-rows // KN_TILE) * KN_TILE
    return -(-K // rows), rows


def _ticket_counters(index: int, stream: int, n: int) -> torch.Tensor:
    """Zeroed int32 counters, one a column strip, for the K splits launched
    on one stream: a launch leaves them zero again, and launches on one
    stream run in order, so they never share a counter.  Each stream has
    its own."""
    buf = _counters.get((index, stream))
    if buf is None or buf.numel() < n:
        buf = torch.zeros(max(n, 1024), dtype=torch.int32,
                          device=torch.device("cuda", index))
        _counters[(index, stream)] = buf
    return buf


def wq_gemm(x: torch.Tensor, q: torch.Tensor, scale: torch.Tensor, *,
            out_dtype=None, q_transposed: bool = False) -> torch.Tensor:
    """x (M, K) fp32 or bf16; q int8 (K, N), or (N, K) with
    ``q_transposed``; scale (N,) fp32; all contiguous on a Hopper card.
    Returns y (M, N) in ``out_dtype``: x's type (the default) or fp32."""
    dev = x.device
    common.require_hopper(dev)
    if x.dtype not in DTYPES:
        raise ValueError(f"wq_gemm kernel takes x in {list(DTYPES)}, got "
                         f"{x.dtype}")
    out_dtype = out_dtype or x.dtype
    if out_dtype not in (x.dtype, torch.float32):
        raise ValueError(f"wq_gemm kernel writes x's type or fp32, not "
                         f"{out_dtype} from {x.dtype}")
    if x.dim() != 2 or q.dim() != 2:
        raise ValueError(f"wq_gemm: x {tuple(x.shape)} and q "
                         f"{tuple(q.shape)} must be 2-d")
    M, K = x.shape
    N = q.shape[0] if q_transposed else q.shape[1]
    common.check_operand("x", x, x.dtype, dev)
    common.check_operand("q", q, torch.int8, dev,
                         (N, K) if q_transposed else (K, N))
    common.check_operand("scale", scale, torch.float32, dev, (N,))
    y = torch.empty((M, N), dtype=out_dtype, device=dev)
    if M == 0 or N == 0:
        return y
    index = dev.index if dev.index is not None else torch.cuda.current_device()
    splits, rows = k_split(M, N, K, q_transposed, _sm_count(index))
    stream = common.stream_of(x)
    ws = counters = None
    if splits > 1:
        ws = torch.empty((splits, M, N), dtype=torch.float32, device=dev)
        counters = _ticket_counters(index, stream, -(-N // KN_COLS))
    # 4-byte loads along K (q (N, K)), 8-byte loads along N (q (K, N))
    width = 4 if q_transposed else 8
    vec = int((K if q_transposed else N) % width == 0
              and q.data_ptr() % width == 0)
    lib = load_library()
    err = lib.wq_gemm_launch(
        x.data_ptr(), q.data_ptr(), scale.data_ptr(), y.data_ptr(),
        None if ws is None else ws.data_ptr(),
        None if counters is None else counters.data_ptr(),
        M, N, K, DTYPES[x.dtype], DTYPES[out_dtype], int(q_transposed),
        splits, rows, vec, stream)
    common.check_launch(lib, "wq_gemm_launch", err)
    wq_gemm.launches += 1
    return y


wq_gemm.launches = 0
