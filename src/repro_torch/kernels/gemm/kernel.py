"""ctypes binding of the CUDA GEMM kernel (csrc/gemm.cu).

``gemm`` is the counterpart of the TPU launcher
(``repro.kernels.gemm.kernel.gemm``): a (M, K) and b (K, N), both fp32 or
both fp64, in; c (M, N) of the same type out.  It checks device, dtype,
shape and contiguity, allocates the output with ``torch.empty``,
launches on the current stream without synchronising, and raises if the
launch returns a CUDA error.  ``plan`` is the host's copy of the tiles,
stages and grid the kernel picks for a dtype and block multiplier (fp64 on
the tensor cores, DMMA; fp32 on the CUDA cores, SIMT).  ``gemm.launches``
counts the kernel launches made through it.
"""
from __future__ import annotations

import ctypes
import functools
import pathlib
from typing import NamedTuple

import torch

from repro_torch.kernels import common

SOURCES = (pathlib.Path(__file__).parent / "csrc" / "gemm.cu",)
DTYPES = {torch.float32: 0, torch.float64: 1}
# the paths: fp64 on the tensor cores, fp32 on the CUDA cores
DMMA, SIMT = "DMMA", "SIMT"
# block_multiplier -> (BM, BN), both paths: the block tile grows with m as
# the TPU kernel's 128 m x 128 m tile does (Fig 7's LMUL axis)
TILES = {1: (64, 64), 2: (128, 128), 4: (256, 128), 8: (256, 256)}
BK = 16                            # k a stage
THREADS = 256                      # a block, both paths
STAGES = {DMMA: 3, SIMT: 2}        # cp.async ring depth
PAD = 4                            # elements a padded shared row adds
SMEM_LIMIT = 232448                # bytes of shared memory a block may take


class Plan(NamedTuple):
    """The path, the block tile (BM, BN, BK), the cp.async stages, the
    grid (blocks along N, along M) and the block's shared memory."""
    path: str
    tile: tuple
    stages: int
    grid: tuple
    smem: int


def plan(M: int, N: int, K: int, dtype, block_multiplier: int) -> Plan:
    """What csrc/gemm.cu launches for C (M, N) = A (M, K) @ B (K, N):
    fp64 through ``mma.sync`` f64 with fp64 accumulators (A row-major and
    B k-major rows, each padded by ``PAD`` doubles); fp32 through FMAs
    (A transposed to k-major, padded; B as it is)."""
    common.check_multiplier(block_multiplier)
    bm, bn = TILES[block_multiplier]
    if dtype == torch.float64:
        path = DMMA
        smem = STAGES[path] * 8 * (bm * (BK + PAD) + BK * (bn + PAD))
    elif dtype == torch.float32:
        path = SIMT
        smem = STAGES[path] * 4 * (BK * (bm + PAD) + BK * bn)
    else:
        raise ValueError(f"gemm kernel takes {list(DTYPES)}, got {dtype}")
    return Plan(path, (bm, bn, BK), STAGES[path],
                (-(-N // bn), -(-M // bm)), smem)


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
    Hopper card.  ``block_multiplier`` in {1, 2, 4, 8} picks the block
    tile (``plan``)."""
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
