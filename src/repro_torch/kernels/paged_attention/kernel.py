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
    fn = lib.paged_partials_launch
    fn.argtypes = ([ctypes.c_void_p] * 9 + [ctypes.c_int] * 8
                   + [ctypes.c_float, ctypes.c_float, ctypes.c_void_p])
    fn.restype = ctypes.c_int
    lib.paged_partials_error_string.argtypes = [ctypes.c_int]
    lib.paged_partials_error_string.restype = ctypes.c_char_p
    return lib


def _check(name, t, dtype, shape=None):
    if t.dtype != dtype:
        raise ValueError(f"{name}: dtype {t.dtype}, expected {dtype}")
    if shape is not None and tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: shape {tuple(t.shape)}, expected {shape}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


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
    for name, t in (("k_pages", k_pages), ("v_pages", v_pages),
                    ("page_idx", page_idx), ("pos0", pos0),
                    ("kv_valid", kv_valid)):
        if t.device != dev:
            raise ValueError(f"{name} on {t.device}, qg on {dev}")
    _check("qg", qg, torch.float32)
    _check("k_pages", k_pages, k_pages.dtype)
    _check("v_pages", v_pages, k_pages.dtype, k_pages.shape)
    _check("page_idx", page_idx, torch.int32, (B, pps))
    _check("pos0", pos0, torch.int32, (B,))
    _check("kv_valid", kv_valid, torch.int32, (B,))
    if R % sq:
        raise ValueError(f"query rows {R} not a multiple of sq={sq}")
    if k_pages.data_ptr() % 16 or v_pages.data_ptr() % 16:
        raise ValueError("K/V pools must be 16-byte aligned (the kernel "
                         "reads them as 16-byte vectors)")
    acc = torch.empty((B, NKV, R, H), dtype=torch.float32, device=dev)
    m = torch.empty((B, NKV, R), dtype=torch.float32, device=dev)
    l = torch.empty((B, NKV, R), dtype=torch.float32, device=dev)
    if B == 0 or R == 0:
        return acc, m, l
    lib = load_library()
    stream = torch.cuda.current_stream(dev).cuda_stream
    err = lib.paged_partials_launch(
        qg.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(),
        page_idx.data_ptr(), pos0.data_ptr(), kv_valid.data_ptr(),
        acc.data_ptr(), m.data_ptr(), l.data_ptr(),
        B, NKV, R, sq, H, page, pps, _KV_DTYPES[k_pages.dtype],
        float(H ** -0.5), float(softcap), stream)
    if err:
        msg = lib.paged_partials_error_string(err).decode()
        raise RuntimeError(f"paged_partials_launch: CUDA error {err} ({msg})")
    paged_flash_decode.launches += 1
    return acc, m, l


paged_flash_decode.launches = 0
