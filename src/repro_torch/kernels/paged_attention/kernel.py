"""ctypes binding of the CUDA paged flash-decode kernel (csrc/paged_attention.cu).

``paged_flash_decode`` is the counterpart of the TPU kernel's launcher
(``repro.kernels.paged_attention.kernel.paged_flash_decode``): grouped
queries and a page pool in, fp32 ``(acc, m, l)`` partials out.  It
checks device, dtype, shape and contiguity, allocates the outputs with
``torch.empty``, launches on the current stream without synchronising,
and raises if the launch returns a CUDA error.  Its ``launches``
attribute counts the kernel launches made through it.
"""
from __future__ import annotations

import ctypes
import functools
import pathlib

import torch

from repro_torch.kernels import common

SOURCES = (pathlib.Path(__file__).parent / "csrc" / "paged_attention.cu",)
HEAD_DIMS = (64, 128)
_KV_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


@functools.lru_cache(maxsize=None)
def load_library() -> ctypes.CDLL:
    """Build (at first use) and load the kernel library, once a process."""
    lib = common.build_library("paged_attention", SOURCES)
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    common.bind(lib, "paged_partials_launch", *[p] * 9, *[i] * 8, f, f)
    return lib


def paged_flash_decode(qg, k_pages, v_pages, page_idx, pos0, kv_valid, *,
                       sq: int, softcap: float = 0.0):
    """qg: (B, NKV, G*Sq, H) fp32 grouped queries (row r is query column
    r % sq); k/v_pages: (P, page, NKV, H) bf16 or fp32 pool; page_idx:
    (B, pps) int32, any page map (ids below P wherever a row's valid
    tokens lie; entries past kv_valid are never read); pos0 / kv_valid:
    (B,) int32.

    Returns fp32 ``(acc, m, l)`` shaped (B, NKV, G*Sq, H) / (B, NKV, G*Sq)
    / (B, NKV, G*Sq); normalize as ``acc / max(l, 1e-30)``."""
    dev = qg.device
    common.require_hopper(dev)
    B, NKV, R, H = qg.shape
    P, page, nkv_pool, h_pool = k_pages.shape
    if H not in HEAD_DIMS or h_pool != H or nkv_pool != NKV:
        raise ValueError(
            f"head_dim {H} (pool {h_pool}) / kv heads {NKV} (pool "
            f"{nkv_pool}): the kernel takes head_dim in {HEAD_DIMS}")
    if k_pages.dtype not in _KV_DTYPES:
        raise ValueError(f"K/V pool dtype {k_pages.dtype} not in "
                         f"{list(_KV_DTYPES)}")
    pps = page_idx.shape[1] if page_idx.dim() == 2 else -1
    common.check_operand("qg", qg, torch.float32, dev)
    # the kernel reads the pools as 16-byte vectors
    common.check_operand("k_pages", k_pages, k_pages.dtype, dev, align=16)
    common.check_operand("v_pages", v_pages, k_pages.dtype, dev,
                         k_pages.shape, align=16)
    common.check_operand("page_idx", page_idx, torch.int32, dev, (B, pps))
    common.check_operand("pos0", pos0, torch.int32, dev, (B,))
    common.check_operand("kv_valid", kv_valid, torch.int32, dev, (B,))
    if R % sq:
        raise ValueError(f"query rows {R} not a multiple of sq={sq}")
    acc = torch.empty((B, NKV, R, H), dtype=torch.float32, device=dev)
    m = torch.empty((B, NKV, R), dtype=torch.float32, device=dev)
    l = torch.empty((B, NKV, R), dtype=torch.float32, device=dev)
    if B == 0 or R == 0:
        return acc, m, l
    lib = load_library()
    err = lib.paged_partials_launch(
        qg.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(),
        page_idx.data_ptr(), pos0.data_ptr(), kv_valid.data_ptr(),
        acc.data_ptr(), m.data_ptr(), l.data_ptr(),
        B, NKV, R, sq, H, page, pps, _KV_DTYPES[k_pages.dtype],
        float(H ** -0.5), float(softcap), common.stream_of(qg))
    common.check_launch(lib, "paged_partials_launch", err)
    paged_flash_decode.launches += 1
    return acc, m, l


paged_flash_decode.launches = 0
