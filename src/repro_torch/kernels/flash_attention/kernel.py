"""ctypes binding of the CUDA flash-attention forward (csrc/flash_attention.cu).

``flash_fwd`` is the counterpart of the TPU kernel's launcher
(``repro.kernels.flash_attention.kernel.flash_attention_fwd``) over the
grouped layout: q (BN, R, H), k/v (BN, Skv, H) in, ``out`` (q's dtype)
and the per-row log-sum-exp ``lse`` (fp32) out.  It checks device,
dtype, shape and contiguity, allocates the outputs with ``torch.empty``,
launches on the current stream without synchronising, and raises if the
launch returns a CUDA error.  ``flash_fwd.launches`` counts the kernel
launches made through it.
"""
from __future__ import annotations

import ctypes
import functools
import pathlib

import torch

from repro_torch.kernels import common

SOURCES = (pathlib.Path(__file__).parent / "csrc" / "flash_attention.cu",)
HEAD_DIMS = (32, 64, 128)
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_MAX_BN = 65535                     # the grid's y dimension


@functools.lru_cache(maxsize=None)
def load_library() -> ctypes.CDLL:
    """Build (at first use) and load the kernel library, once a process."""
    lib = common.build_library("flash_attention", SOURCES)
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    common.bind(lib, "flash_fwd_launch", *[p] * 5, *[i] * 7, f, f)
    return lib


def flash_fwd(q, k, v, *, causal: bool = True, softcap: float = 0.0,
              sq_real: int = 0):
    """q: (BN, R, H), row r the query column r % sq_real (0: R); k/v:
    (BN, Skv, H); all fp32 or all bf16, contiguous, on a Hopper card.

    Returns ``(out (BN, R, H) in q.dtype, lse (BN, R) fp32)``."""
    dev = q.device
    common.require_hopper(dev)
    BN, R, H = q.shape
    Skv = k.shape[1]
    if H not in HEAD_DIMS:
        raise ValueError(f"head_dim {H}: the kernel takes {HEAD_DIMS}")
    if q.dtype not in _DTYPES:
        raise ValueError(f"dtype {q.dtype} not in {list(_DTYPES)}")
    if BN > _MAX_BN:
        raise ValueError(f"{BN} batch x KV heads > {_MAX_BN}")
    sq = sq_real or R
    if sq <= 0 or (R and R % sq):
        raise ValueError(f"rows {R} not a multiple of sq_real={sq}")
    common.check_operand("q", q, q.dtype, dev)
    common.check_operand("k", k, q.dtype, dev, (BN, Skv, H))
    common.check_operand("v", v, q.dtype, dev, (BN, Skv, H))
    out = torch.empty((BN, R, H), dtype=q.dtype, device=dev)
    lse = torch.empty((BN, R), dtype=torch.float32, device=dev)
    if BN == 0 or R == 0:
        return out, lse
    if Skv == 0:
        raise ValueError("no keys to attend to")
    lib = load_library()
    err = lib.flash_fwd_launch(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        lse.data_ptr(), BN, R, Skv, sq, H, _DTYPES[q.dtype], int(causal),
        float(H ** -0.5), float(softcap), common.stream_of(q))
    common.check_launch(lib, "flash_fwd_launch", err)
    flash_fwd.launches += 1
    return out, lse


flash_fwd.launches = 0
