"""ctypes binding of the CUDA STREAM kernel (csrc/stream.cu).

``stream_call`` is the counterpart of the TPU kernels' launcher
(``repro.kernels.stream.kernel._call``): one contiguous fp32 array (two
for add and triad) in, a new one out.  It checks device, dtype, shape,
contiguity and 16-byte alignment, allocates the output with
``torch.empty``, launches on the current stream without synchronising,
and raises if the launch returns a CUDA error.  ``plan`` is the host's
copy of the grid the kernel launches.  ``stream_call.launches`` counts
the kernel launches made through it.
"""
from __future__ import annotations

import ctypes
import functools
import pathlib
from typing import NamedTuple

import torch

from repro_torch.kernels import common

SOURCES = (pathlib.Path(__file__).parent / "csrc" / "stream.cu",)
KINDS = ("copy", "scale", "add", "triad")
THREADS = 256                  # a block
VECTOR = 4                     # fp32 elements a 16-byte vector


class Plan(NamedTuple):
    """``vectors`` 16-byte vectors a thread moves per array (the block
    multiplier), ``grid`` blocks of ``threads``."""
    vectors: int
    grid: int
    threads: int


def plan(n: int, block_multiplier: int) -> Plan:
    """What csrc/stream.cu launches over n fp32 elements: one slot a
    whole or partial vector, ``THREADS * block_multiplier`` slots a
    block."""
    common.check_multiplier(block_multiplier)
    slots = -(-n // VECTOR)
    per_block = THREADS * block_multiplier
    return Plan(block_multiplier, -(-slots // per_block), THREADS)


@functools.lru_cache(maxsize=None)
def load_library() -> ctypes.CDLL:
    """Build (at first use) and load the kernel library, once a process."""
    lib = common.build_library("stream", SOURCES)
    p, i = ctypes.c_void_p, ctypes.c_int
    common.bind(lib, "stream_launch", p, p, p, ctypes.c_longlong, i, i,
                ctypes.c_float)
    return lib


def stream_call(kind: str, x: torch.Tensor, y=None, alpha: float = 2.0, *,
                block_multiplier: int = 1) -> torch.Tensor:
    """x (and y for add/triad): contiguous fp32 of one shape, any rank,
    on a Hopper card.  ``block_multiplier`` in {1, 2, 4, 8} is the 16-byte
    vectors each thread moves per array."""
    dev = x.device
    common.require_hopper(dev)
    common.check_multiplier(block_multiplier)
    if kind not in KINDS:
        raise ValueError(kind)
    common.check_operand("x", x, torch.float32, dev, align=16)
    uses_y = kind in ("add", "triad")
    if uses_y:
        common.check_operand("y", y, torch.float32, dev, x.shape, align=16)
    out = torch.empty_like(x, memory_format=torch.contiguous_format)
    if x.numel() == 0:
        return out
    lib = load_library()
    err = lib.stream_launch(x.data_ptr(), y.data_ptr() if uses_y else None,
                            out.data_ptr(), x.numel(), KINDS.index(kind),
                            block_multiplier, float(alpha),
                            common.stream_of(x))
    common.check_launch(lib, "stream_launch", err)
    stream_call.launches += 1
    return out


stream_call.launches = 0
