"""ctypes binding of the CUDA weight-only int8 GEMM (csrc/wq_gemm.cu).

``wq_gemm`` is the counterpart of the TPU launcher
(``repro.kernels.wq_gemm.kernel.wq_gemm``): x (M, K) fp32 or bf16, q int8
(K, N) — or (N, K) with ``q_transposed`` — and scale (N,) fp32 in; y (M,
N) out, in x's type or fp32.  It checks device, dtype, shape and
contiguity, allocates the output with ``torch.empty``, launches on the
current stream without synchronising, and raises if the launch returns a
CUDA error.  ``plan`` picks the kernel and its grid from x's dtype, M, N
and K; the binding checks and plans each call signature once, so a decode
call costs little host time.  ``wq_gemm.launches`` counts the kernel
launches made through it.
"""
from __future__ import annotations

import ctypes
import functools
import pathlib
from typing import NamedTuple

import torch

from repro_torch.kernels import common

SOURCES = (pathlib.Path(__file__).parent / "csrc" / "wq_gemm.cu",)
SMALL_M = 8           # rows up to which the GEMV runs
# paths of wq_gemm_launch
FP32_TILED, GEMV, WGMMA = 0, 1, 2
TILED_TILES = ((64, 64), (128, 128))        # (BM, BN): 4 x 4, 8 x 8 a thread
WGMMA_TILES = ((128, 256), (64, 128), (64, 64))
GEMV_BN = 64          # output columns a GEMV block
GEMV_BK = 128         # k a GEMV stage: a K split is a whole number of these
MAX_SPLITS = 8        # a K split is one thread-block cluster (portable size)
# flags of wq_gemm_launch
OUT_BF16, TRANSPOSED, VEC, X_FP32 = 1, 2, 4, 8


class Plan(NamedTuple):
    """The kernel (``path``, ``tile``: an index into the path's tiles) and
    its grid: ``blocks`` = (along N, along M or the K split), ``splits``
    ranges of ``k_per_split`` rows of K."""
    path: int
    tile: int
    splits: int
    k_per_split: int
    blocks: tuple


def plan(M: int, N: int, K: int, x_bf16: bool, sms: int) -> Plan:
    """Up to ``SMALL_M`` rows, either x type: the GEMV (tensor cores for
    bf16 x, CUDA cores for fp32), its K split (at most ``MAX_SPLITS``
    ranges, each a whole number of ``GEMV_BK``) only as far as it takes to
    give each SM about one block.  Above: fp32 x the CUDA-core tiled
    kernel (TF32 would break fp32 parity); bf16 x wgmma, with the largest
    tile whose grid fills the card (the smallest where none does)."""
    if M <= SMALL_M:
        strips = -(-N // GEMV_BN)
        stages = max(-(-K // GEMV_BK), 1)
        want = min(max(round(sms / strips), 1), MAX_SPLITS, stages)
        per = -(-stages // want)
        splits = -(-stages // per)
        return Plan(GEMV, 0, splits, per * GEMV_BK, (strips, splits))
    if not x_bf16:
        tile = 0 if M <= 64 else 1
        bm, bn = TILED_TILES[tile]
        return Plan(FP32_TILED, tile, 1, K, (-(-N // bn), -(-M // bm)))
    for tile, (bm, bn) in enumerate(WGMMA_TILES):
        blocks = (-(-N // bn), -(-M // bm))
        if blocks[0] * blocks[1] >= sms:
            break
    return Plan(WGMMA, tile, 1, K, blocks)


@functools.lru_cache(maxsize=None)
def load_library() -> ctypes.CDLL:
    """Build (at first use) and load the kernel library, once a process."""
    lib = common.build_library("wq_gemm", SOURCES)
    p = ctypes.c_void_p
    common.bind(lib, "wq_gemm_launch", p, p, p, p, p)
    return lib


class _Call(NamedTuple):
    """What one call signature needs, checked once: the output's shape,
    the launch plans (8 ints each, without and with 16-byte loads),
    whether 16-byte loads are possible at all, and the launcher."""
    y_shape: tuple
    plan: object
    plan_vec: object
    vec_rows: bool
    launch: object


_calls = common.CallTable()     # call signature -> _Call


def _call(x_shape, q_shape, s_shape, x_dtype, q_dtype, s_dtype, out_dtype,
          q_transposed, dev, q_dev, s_dev) -> _Call:
    """Check one call signature (device, dtypes, shapes) and plan it."""
    index = common.require_hopper(dev)
    if x_dtype is not torch.bfloat16 and x_dtype is not torch.float32:
        raise ValueError(f"wq_gemm kernel takes x in bf16 or fp32, got "
                         f"{x_dtype}")
    if out_dtype is not x_dtype and out_dtype is not torch.float32:
        raise ValueError(f"wq_gemm kernel writes x's type or fp32, not "
                         f"{out_dtype} from {x_dtype}")
    if len(x_shape) != 2 or len(q_shape) != 2:
        raise ValueError(f"wq_gemm: x {tuple(x_shape)} and q "
                         f"{tuple(q_shape)} must be 2-d")
    M, K = x_shape
    N, Kq = q_shape if q_transposed else q_shape[::-1]
    if (Kq != K or q_dtype is not torch.int8
            or s_dtype is not torch.float32 or tuple(s_shape) != (N,)
            or q_dev != dev or s_dev != dev):
        raise ValueError(
            f"wq_gemm: x {tuple(x_shape)} {x_dtype} on {dev} takes q int8 "
            f"{(N, K) if q_transposed else (K, N)} and scale fp32 ({N},) on "
            f"the same device, got q {q_dtype} {tuple(q_shape)} on {q_dev}, "
            f"scale {s_dtype} {tuple(s_shape)} on {s_dev}")
    x_bf16 = x_dtype is torch.bfloat16
    p = plan(M, N, K, x_bf16, common.sm_count(index))
    flags = ((OUT_BF16 if out_dtype is torch.bfloat16 else 0)
             | (TRANSPOSED if q_transposed else 0)
             | (0 if x_bf16 else X_FP32))
    ints = (M, N, K, p.path, p.tile, flags, p.splits, p.k_per_split)
    vec_ints = ints[:5] + (flags | VEC,) + ints[6:]
    # 16-byte chunks of x's and q's rows; the tiled kernel loads elements
    vec_rows = (p.path != FP32_TILED and K % (8 if x_bf16 else 4) == 0
                and (K if q_transposed else N) % 16 == 0)
    return _Call((M, N), (ctypes.c_int * 8)(*ints),
                 (ctypes.c_int * 8)(*vec_ints), vec_rows,
                 load_library().wq_gemm_launch)


def wq_gemm(x: torch.Tensor, q: torch.Tensor, scale: torch.Tensor, *,
            out_dtype=None, q_transposed: bool = False) -> torch.Tensor:
    """x (M, K) fp32 or bf16; q int8 (K, N), or (N, K) with
    ``q_transposed``; scale (N,) fp32; all contiguous on a Hopper card.
    Returns y (M, N) in ``out_dtype``: x's type (the default) or fp32.
    16-byte loads where the rows allow them and both bases lie on a
    16-byte boundary."""
    out_dtype = out_dtype or x.dtype
    key = (x.shape, q.shape, scale.shape, x.dtype, q.dtype, scale.dtype,
           out_dtype, q_transposed, x.device, q.device, scale.device)
    call = _calls.lookup(key, _call, *key)
    if not (x.is_contiguous() and q.is_contiguous()
            and scale.is_contiguous()):
        raise ValueError("wq_gemm: x, q and scale must be contiguous")
    y = x.new_empty(call.y_shape, dtype=out_dtype)
    if y.numel() == 0:
        return y
    xp, qp = x.data_ptr(), q.data_ptr()
    err = call.launch(
        xp, qp, scale.data_ptr(), y.data_ptr(),
        call.plan_vec if call.vec_rows and not (xp | qp) & 15 else call.plan,
        common.stream_of(x))
    if err:
        common.check_launch(load_library(), "wq_gemm_launch", err)
    wq_gemm.launches += 1
    return y


wq_gemm.launches = 0
