"""ctypes binding of the CUDA tail-handling kernels (csrc/tailmask.cu).

``exact_tail`` and ``masked_full`` are the counterparts of the TPU
launchers of the same names (``repro.kernels.tailmask.kernel``): both
compute ``silu(x) * 2`` over a (rows, cols) fp32 array.  Each checks
device, dtype and contiguity, allocates the output with ``torch.empty``,
launches on the current stream without synchronising, and raises if a
launch returns a CUDA error.  ``exact_tail.launches`` counts its
launches (two per call when ``block_rows`` does not divide ``rows``: the
whole tiles, then the remainder); ``masked_full.launches`` counts one per
call.
"""
from __future__ import annotations

import ctypes
import functools
import pathlib

import torch

from repro_torch.kernels import common

SOURCES = (pathlib.Path(__file__).parent / "csrc" / "tailmask.cu",)


@functools.lru_cache(maxsize=None)
def load_library() -> ctypes.CDLL:
    """Build (at first use) and load the kernel library, once a process."""
    lib = common.build_library("tailmask", SOURCES)
    p, ll, i = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
    common.bind(lib, "tailmask_launch", p, p, ll, ll, ll, i, i)
    return lib


def check_block_rows(block_rows: int) -> int:
    if block_rows < 1:
        raise ValueError(f"block_rows must be >= 1, got {block_rows}")
    return block_rows


def _check(x: torch.Tensor) -> None:
    common.require_hopper(x.device)
    if x.dim() != 2:
        raise ValueError(f"x must be (rows, cols), got {tuple(x.shape)}")
    common.check_operand("x", x, torch.float32, x.device)


def _launch(lib, x: torch.Tensor, out: torch.Tensor, tiles: int, tile: int,
            n_valid: int, masked: bool) -> None:
    vec = tile % 4 == 0 and x.data_ptr() % 16 == 0 \
        and out.data_ptr() % 16 == 0
    err = lib.tailmask_launch(x.data_ptr(), out.data_ptr(), tiles, tile,
                              n_valid, int(masked), int(vec),
                              common.stream_of(x))
    common.check_launch(lib, "tailmask_launch", err)


def exact_tail(x: torch.Tensor, *, block_rows: int = 8) -> torch.Tensor:
    """silu(x) * 2 with no masked lane: the whole ``block_rows`` tiles in
    one launch, the remaining rows (if any) in a second launch of one
    block sized to them."""
    _check(x)
    check_block_rows(block_rows)
    rows, cols = x.shape
    out = torch.empty_like(x)
    full = rows // block_rows * block_rows
    lib = load_library() if x.numel() else None
    if full:
        _launch(lib, x, out, full // block_rows, block_rows * cols, 0, False)
        exact_tail.launches += 1
    if rows - full:
        _launch(lib, x[full:], out[full:], 1, (rows - full) * cols, 0, False)
        exact_tail.launches += 1
    return out


def masked_full(x: torch.Tensor, n_valid: int, *, block_rows: int = 8
                ) -> torch.Tensor:
    """silu(x) * 2 over every tile of an input padded to whole tiles,
    with 0 written at every flat index >= ``n_valid``.  Raises
    ``ValueError`` unless ``block_rows`` divides ``rows``."""
    _check(x)
    check_divides(x.shape[0], block_rows)
    rows, cols = x.shape
    out = torch.empty_like(x)
    if rows:
        _launch(load_library(), x, out, rows // block_rows,
                block_rows * cols, int(n_valid), True)
        masked_full.launches += 1
    return out


def check_divides(rows: int, block_rows: int) -> None:
    """masked_full's condition: the input is padded to whole tiles."""
    check_block_rows(block_rows)
    if rows % block_rows:
        raise ValueError(f"masked_full needs rows ({rows}) to be a multiple "
                         f"of block_rows ({block_rows}); pad the input")


exact_tail.launches = 0
masked_full.launches = 0
