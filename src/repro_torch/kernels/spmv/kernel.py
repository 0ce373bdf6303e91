"""ctypes bindings of the CUDA ELL SpMV kernels (csrc/spmv.cu).

``spmv_ell`` is the counterpart of the TPU launcher
(``repro.kernels.spmv.kernel.spmv_ell``) with ``idiom="take"``,
``spmv_ell_onehot`` with ``idiom="onehot"``.  Each checks device, dtype,
shape and contiguity, allocates the output with ``torch.empty``,
launches on the current stream without synchronising, and raises if the
launch returns a CUDA error.  ``spmv_ell.launches`` and
``spmv_ell_onehot.launches`` count the kernel launches made through
them.  ``take_plan`` is the host copy of what ``spmv_ell`` launches: the
vector path (a persistent grid over a ring of bulk-copied tiles) or the
general path (a scalar load a nonzero).
"""
from __future__ import annotations

import ctypes
import functools
import pathlib
from typing import NamedTuple

import torch

from repro_torch.kernels import common

SOURCES = (pathlib.Path(__file__).parent / "csrc" / "spmv.cu",)
ONEHOT_PER_LANE = 4       # nonzeros a lane holds in a pass (K > 4)
ONEHOT_MAX_LANES = 32     # lanes of a row
ONEHOT_X_CHUNK = 16384    # x floats staged in shared memory at a time
# the take idiom's vector path (csrc/spmv.cu: kTake*)
TAKE_CONSUMERS = 256      # consumer threads a block (and one producer warp)
TAKE_MAX_STAGES = 4
TAKE_RING_BYTES = 24 * 1024         # the ring a block aims for
TAKE_SMEM_LIMIT = 227 * 1024        # a block's shared memory
# the shared memory the blocks of an SM may take together: the 132 KB
# carveout, which leaves 124 KB of L1 for the gathers' lines in flight and
# x's hot lines (on an H100 a 196 KB carveout, 60 KB of L1, made the random
# gather and the gather from a 64 KB window of x slower)
TAKE_SMEM_PER_SM = 132 * 1024
BLOCK_RESERVED = 1024               # shared memory the system keeps a block
# blocks a SM at each block multiplier: the kernel's __launch_bounds__
# holds its registers to that many
TAKE_BLOCKS_PER_SM = {1: 4, 2: 3, 4: 2, 8: 1}
GENERAL_THREADS = 256


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


class TakePlan(NamedTuple):
    """What ``spmv_ell`` launches.  ``path`` "vector": ``grid`` persistent
    blocks walk tiles of ``tile_rows`` rows (tile t, t + grid, ...)
    through a ring of ``stages`` in ``smem`` bytes, ``lanes`` a row, a
    lane 4 nonzeros at a time; ``blocks_per_sm`` is what the grid counts
    on.  "general": ``grid`` blocks of ``tile_rows`` rows each, ``lanes``
    a row, a lane one nonzero at a time (``stages``, ``smem`` 0)."""
    path: str
    lanes: int
    tile_rows: int
    stages: int
    grid: int
    blocks_per_sm: int
    smem: int


def _pow2_at_least(n: int) -> int:
    return 1 << max(n - 1, 0).bit_length()


def take_smem_bytes(K: int, lanes: int, rpg: int, stages: int) -> int:
    """The vector path's ring: each stage a tile's vals and cols, and two
    mbarriers (csrc/spmv.cu ``take_smem_bytes``)."""
    return stages * (2 * (TAKE_CONSUMERS // lanes) * rpg * K * 4 + 16)


def _general_plan(R: int, K: int, block_multiplier: int) -> TakePlan:
    """The general path: ``lanes`` the power of two at or above K (at
    most 32), each lane group walking ``block_multiplier`` rows."""
    lanes = min(_pow2_at_least(K), 32)
    rows = GENERAL_THREADS // lanes * block_multiplier
    return TakePlan("general", lanes, rows, 0, -(-R // rows), 0, 0)


def _vector_plan(R: int, K: int, block_multiplier: int,
                sms: int) -> TakePlan | None:
    """The vector path for (R, K), K a multiple of 4 with aligned
    operands, or None where two stages of a tile do not fit
    ``TAKE_SMEM_LIMIT``.  Lanes: the power of two at or above K / 4 (at
    most 32); stages fill ``TAKE_RING_BYTES`` (2 to 4); blocks a SM: as
    many as ``TAKE_SMEM_PER_SM`` holds, at most ``TAKE_BLOCKS_PER_SM``, at
    least 1; the grid one wave of them, never more than the tiles."""
    lanes = min(_pow2_at_least(K // 4), 32)
    tile_rows = TAKE_CONSUMERS // lanes * block_multiplier
    tile = 2 * tile_rows * K * 4
    stages = max(2, min(TAKE_MAX_STAGES, TAKE_RING_BYTES // tile))
    smem = take_smem_bytes(K, lanes, block_multiplier, stages)
    if smem > TAKE_SMEM_LIMIT:
        return None
    blocks = max(min(TAKE_BLOCKS_PER_SM[block_multiplier],
                     TAKE_SMEM_PER_SM // (smem + BLOCK_RESERVED)), 1)
    grid = max(min(-(-R // tile_rows), sms * blocks), 1)
    return TakePlan("vector", lanes, tile_rows, stages, grid, blocks, smem)


@functools.lru_cache(maxsize=4096)
def take_plan(R: int, K: int, block_multiplier: int, sms: int,
              aligned: bool, path: str | None = None) -> TakePlan:
    """The take kernel's plan for (R, K) at ``block_multiplier`` (the
    rows a lane group takes a stage) on ``sms`` SMs.  The vector path
    (``_vector_plan``) needs K a multiple of 4 and ``aligned`` (vals and
    cols start on a 16-byte boundary, so a tile is whole 16-byte
    vectors) and a ring that fits; it is taken where some block walks a
    second tile (more tiles than the grid: with one tile a block the ring
    has nothing to overlap, and the general path's loads start sooner).
    Otherwise the general path.  ``path`` forces one (tests and timings
    only): "vector" raises where the vector path does not apply."""
    common.check_multiplier(block_multiplier)
    vector = (_vector_plan(R, K, block_multiplier, sms)
              if K and K % 4 == 0 and aligned else None)
    if path == "vector":
        if vector is None:
            raise ValueError(f"the vector path needs K a multiple of 4 "
                             f"(K {K}), aligned operands ({aligned}) and a "
                             f"ring that fits")
        return vector
    if path not in (None, "general"):
        raise ValueError(f"path {path!r}: 'vector', 'general' or None")
    if path is None and vector is not None and \
            -(-R // vector.tile_rows) > vector.grid:
        return vector
    return _general_plan(R, K, block_multiplier)


@functools.lru_cache(maxsize=None)
def load_library() -> ctypes.CDLL:
    """Build (at first use) and load the kernel library, once a process."""
    lib = common.build_library("spmv", SOURCES)
    p, i = ctypes.c_void_p, ctypes.c_int
    common.bind(lib, "spmv_ell_launch", p, p, p, p, i, i, i, i)
    common.bind(lib, "spmv_take_launch", p, p, p, p, *[i] * 8)
    common.bind(lib, "spmv_onehot_launch", p, p, p, p, *[i] * 7)
    for name, n in (("spmv_take_smem_bytes", 4), ("spmv_take_occupancy", 3)):
        getattr(lib, name).argtypes = [i] * n
        getattr(lib, name).restype = i
    return lib


def _operands(vals, cols, x):
    """The output y and the device's index."""
    dev = vals.device
    index = common.require_hopper(dev)
    if vals.dim() != 2 or x.dim() != 1:
        raise ValueError(f"vals must be (R, K) and x (C,), got "
                         f"{tuple(vals.shape)} and {tuple(x.shape)}")
    common.check_operand("vals", vals, torch.float32, dev)
    common.check_operand("cols", cols, torch.int32, dev, vals.shape)
    common.check_operand("x", x, torch.float32, dev)
    return (torch.empty((vals.shape[0], 1), dtype=torch.float32, device=dev),
            index)


def spmv_ell(vals: torch.Tensor, cols: torch.Tensor, x: torch.Tensor, *,
             block_multiplier: int = 1, path: str | None = None
             ) -> torch.Tensor:
    """vals (R, K) fp32, cols (R, K) int32, x (C,) fp32, contiguous on a
    Hopper card.  Returns y (R, 1) fp32; a column outside [0, C) adds
    nothing.  ``block_multiplier`` in {1, 2, 4, 8} is the rows each lane
    group takes a stage (vector path) or walks (general path).  ``path``
    forces "vector" or "general" (tests and timings only; see
    ``take_plan``)."""
    common.check_multiplier(block_multiplier)
    y, index = _operands(vals, cols, x)
    R, Kn = vals.shape
    if R == 0:
        return y
    aligned = vals.data_ptr() % 16 == 0 and cols.data_ptr() % 16 == 0
    plan = take_plan(R, Kn, block_multiplier, common.sm_count(index),
                     aligned, path)
    lib = load_library()
    stream = common.stream_of(vals)
    if plan.path == "vector":
        err = lib.spmv_take_launch(
            vals.data_ptr(), cols.data_ptr(), x.data_ptr(), y.data_ptr(), R,
            Kn, x.shape[0], plan.lanes, block_multiplier, plan.stages,
            plan.grid, plan.blocks_per_sm, stream)
        common.check_launch(lib, "spmv_take_launch", err)
    else:
        err = lib.spmv_ell_launch(
            vals.data_ptr(), cols.data_ptr(), x.data_ptr(), y.data_ptr(), R,
            Kn, x.shape[0], block_multiplier, stream)
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
    y, _ = _operands(vals, cols, x)
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
