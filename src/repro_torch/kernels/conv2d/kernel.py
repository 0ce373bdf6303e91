"""ctypes binding of the CUDA direct conv2d kernel (csrc/conv2d.cu).

``conv2d_same`` is the counterpart of the TPU launcher
(``repro.kernels.conv2d.kernel.conv2d_same``): x (N, H, W, Cin) and w
(kh, kw, Cin, Cout) fp32 in, (N, H, W, Cout) fp32 out.  It checks
device, dtype, shape and contiguity, plans the tile (``plan``: the
host's copy of what the kernel launches), allocates the output with
``torch.empty``, launches on the current stream without synchronising,
and raises if the launch returns a CUDA error.  ``conv2d_same.launches``
counts the kernel launches made through it.
"""
from __future__ import annotations

import ctypes
import functools
import pathlib
from typing import NamedTuple

import torch

from repro_torch.kernels import common

SOURCES = (pathlib.Path(__file__).parent / "csrc" / "conv2d.cu",)
MAX_SMEM_BYTES = 232448          # what one Hopper block may use
TILE_W = 32                      # output columns a block
TILE_H = 4                       # output rows a block
CI = 8                           # input channels a stage
ROW_PITCH = 36                   # floats a staged halo row (kw <= 5)
STAGES = 2                       # cp.async ring depth
# BN (output channels a block) -> (TC channels a thread, CG channel groups)
CHANNEL_TILES = {64: (8, 8), 32: (4, 8), 16: (2, 8), 8: (2, 4)}
KW_MAX = (1, 3, 5)               # the kernel's filter-width templates
ANY_WIDTH = 0                    # the template past them: taps as scalars


class Plan(NamedTuple):
    """The block tile: ``bn`` output channels (``tc`` a thread, ``cg``
    channel groups), ``TILE_H`` x ``TILE_W`` output pixels, the
    filter-width template ``kw_max``; the launch: ``threads``, ``grid``
    (column x channel tiles, row tiles, images) and the block's shared
    memory ``smem``."""
    bn: int
    tc: int
    cg: int
    kw_max: int
    threads: int
    grid: tuple
    smem: int


def smem_bytes(kh: int, kw: int, bn: int) -> int:
    """csrc's ``conv2d_smem_bytes``: two stages of the haloed input (one
    channel's TILE_H + kh - 1 rows, its pitch = 4 mod 32 floats) and the
    weights, 8 input channels each."""
    pitch = ROW_PITCH if kw <= KW_MAX[-1] else TILE_W + kw - 1
    raw = (TILE_H + kh - 1) * pitch
    chan = raw + (4 - raw) % 32
    return STAGES * 4 * (CI * chan + CI * kh * kw * bn)


def plan(N: int, H: int, W: int, Cin: int, Cout: int, kh: int, kw: int,
         sms: int) -> Plan:
    """BN is the narrowest of 8 / 16 / 32 / 64 that holds Cout (64 above);
    the template the narrowest of 1 / 3 / 5 that holds kw, ``ANY_WIDTH``
    past 5.  A block is 4 rows: 8-row blocks measured slower at every
    layer of the CNN apps (half the blocks, under 1.5 waves of ``sms`` at
    224^2).  Raises where the stages do not fit in a block's shared
    memory."""
    if kh < 1 or kw < 1:
        raise ValueError(f"conv2d: filter {kh}x{kw}")
    kw_max = next((k for k in KW_MAX if kw <= k), ANY_WIDTH)
    bn = next((b for b in sorted(CHANNEL_TILES) if Cout <= b), 64)
    tc, cg = CHANNEL_TILES[bn]
    smem = smem_bytes(kh, kw, bn)
    if smem > MAX_SMEM_BYTES:
        raise ValueError(f"conv2d: a {kh}x{kw} filter at {bn} output "
                         f"channels needs {smem} bytes of shared memory per "
                         f"block, over {MAX_SMEM_BYTES}")
    return Plan(bn, tc, cg, kw_max, 4 * TILE_H * cg,
                (-(-W // TILE_W) * -(-Cout // bn), -(-H // TILE_H), N), smem)


@functools.lru_cache(maxsize=None)
def load_library() -> ctypes.CDLL:
    """Build (at first use) and load the kernel library, once a process."""
    lib = common.build_library("conv2d", SOURCES)
    p, i = ctypes.c_void_p, ctypes.c_int
    common.bind(lib, "conv2d_launch", p, p, p, *[i] * 11)
    lib.conv2d_smem_bytes.argtypes = [i, i, i]
    lib.conv2d_smem_bytes.restype = ctypes.c_longlong
    return lib


def conv2d_same(x: torch.Tensor, w: torch.Tensor, *, bh: int) -> torch.Tensor:
    """x (N, H, W, Cin), w (kh, kw, Cin, Cout): contiguous fp32 on a Hopper
    card.  ``bh`` is the JAX entry's row block (H % bh == 0, checked for
    parity); the kernel's tile is ``plan``'s."""
    dev = x.device
    index = common.require_hopper(dev)
    if x.dim() != 4 or w.dim() != 4 or w.shape[2] != x.shape[3]:
        raise ValueError(f"conv2d: x {tuple(x.shape)} (NHWC) and w "
                         f"{tuple(w.shape)} (HWIO) do not match")
    N, H, W, Cin = x.shape
    kh, kw, _, Cout = w.shape
    if bh < 1 or H % bh:
        raise ValueError(f"conv2d: H={H} is not a multiple of block_h={bh}")
    common.check_operand("x", x, torch.float32, dev)
    common.check_operand("w", w, torch.float32, dev)
    out = torch.empty((N, H, W, Cout), dtype=torch.float32, device=dev)
    if out.numel() == 0:
        return out
    p = plan(N, H, W, Cin, Cout, kh, kw, common.sm_count(index))
    vec = int(Cout % 4 == 0 and w.data_ptr() % 16 == 0
              and out.data_ptr() % 16 == 0)
    lib = load_library()
    err = lib.conv2d_launch(x.data_ptr(), w.data_ptr(), out.data_ptr(), N, H,
                            W, Cin, Cout, kh, kw, p.tc, p.cg, p.kw_max, vec,
                            common.stream_of(x))
    common.check_launch(lib, "conv2d_launch", err)
    conv2d_same.launches += 1
    return out


conv2d_same.launches = 0
