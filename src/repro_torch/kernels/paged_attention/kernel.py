"""ctypes binding of the CUDA paged flash-decode kernel (csrc/paged_attention.cu).

``paged_flash_decode`` is the counterpart of the TPU kernel's launcher
(``repro.kernels.paged_attention.kernel.paged_flash_decode``): grouped
queries and a page pool in, fp32 ``(acc, m, l)`` partials out.  It
checks device, dtype, shape and contiguity, allocates the outputs with
``torch.empty``, launches on the current stream without synchronising,
and raises if the launch returns a CUDA error.  ``split_plan`` is the
host's copy of the grid: the block mode and the KV split, a
thread-block cluster the kernel folds in rank order.  The binding checks
and plans each call signature once, so a decode call costs little host
time.  Its ``launches`` attribute counts the kernel launches made
through it.
"""
from __future__ import annotations

import ctypes
import functools
import pathlib
from typing import NamedTuple

import torch

from repro_torch.kernels import common

SOURCES = (pathlib.Path(__file__).parent / "csrc" / "paged_attention.cu",)
HEAD_DIMS = (64, 128)
_KV_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
TILE = 32               # KV tokens a warp scores at once; a split is whole tiles
WARPS = 4
STAGES = 2              # cp.async ring depth
MAX_SPLITS = 8          # a KV split is one thread-block cluster (portable size)
MAX_SMEM_BYTES = 232448  # what one Hopper block may use
# block modes (KV warps, rows a warp), fewest rows a block first: KV warps
# share a row group and take different tiles of a stage
MODES = ((4, 2), (4, 4), (2, 4), (1, 4))


class SplitPlan(NamedTuple):
    """``splits`` blocks a row slice, each over ``tokens_per_split`` tokens
    of the table's capacity; ``grid`` = (splits, B * NKV, row slices);
    ``mode`` = (KV warps, rows a warp)."""
    splits: int
    tokens_per_split: int
    grid: tuple
    mode: tuple


def block_rows(mode) -> int:
    """Query rows one block holds in a mode."""
    kw, rw = mode
    return WARPS // kw * rw


def smem_bytes(head_dim: int, kv_bytes: int, mode) -> int:
    """The kernel's dynamic shared memory in a mode (csrc's
    ``smem_bytes``): the ring of K/V stages or, after the loop, the
    partials it then holds; the queries; P."""
    kw, rw = mode
    ring = STAGES * TILE * kw * (2 * head_dim + 16 // kv_bytes) * kv_bytes
    part = (WARPS * rw + block_rows(mode)) * (head_dim + 2) * 4
    return (max(ring, part) + block_rows(mode) * head_dim * 4
            + WARPS * rw * TILE * 4)


def block_mode(R: int, head_dim: int, kv_bytes: int) -> tuple:
    """The first mode whose block holds all R rows and fits in shared
    memory; past 8 rows, 16-row slices with every warp on the same tile."""
    for mode in MODES:
        if (R <= block_rows(mode)
                and smem_bytes(head_dim, kv_bytes, mode) <= MAX_SMEM_BYTES):
            return mode
    return MODES[-1]


def split_plan(B: int, NKV: int, R: int, max_tokens: int, sms: int, *,
               head_dim: int = 64, kv_bytes: int = 2,
               splits: int | None = None) -> SplitPlan:
    """The grid for B x NKV (b, kv_head) pairs of R query rows over a
    table of ``max_tokens`` (pps * page: its capacity, not kv_valid).  The
    KV range is split only as far as it takes to give each of ``sms`` SMs
    about one block: at most ``MAX_SPLITS`` splits, each a whole number of
    ``TILE`` tokens, none starting past ``max_tokens``.  ``splits`` forces
    a count (the engine's tuned one, and the tests; still held to those
    rules)."""
    mode = block_mode(R, head_dim, kv_bytes)
    slices = max(-(-R // block_rows(mode)), 1)
    blocks = max(B * NKV * slices, 1)
    tiles = max(-(-max_tokens // TILE), 1)
    if splits is None:
        want = min(-(-sms // blocks), MAX_SPLITS, tiles)
    elif 1 <= splits <= MAX_SPLITS:
        want = min(splits, tiles)
    else:
        raise ValueError(f"splits={splits} not in 1..{MAX_SPLITS}")
    per = -(-tiles // want)
    n = -(-tiles // per)
    return SplitPlan(n, per * TILE, (n, B * NKV, slices), mode)


@functools.lru_cache(maxsize=None)
def load_library() -> ctypes.CDLL:
    """Build (at first use) and load the kernel library, once a process."""
    lib = common.build_library("paged_attention", SOURCES)
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    common.bind(lib, "paged_partials_launch", *[p] * 9, *[i] * 12, f, f)
    lib.paged_partials_smem_bytes.argtypes = [i, i, i, i]
    lib.paged_partials_smem_bytes.restype = ctypes.c_longlong
    return lib


class _Call(NamedTuple):
    """One call signature, checked once: output shapes, the plan, and the
    launch's integer arguments after the nine pointers."""
    acc_shape: tuple
    ml_shape: tuple
    plan: SplitPlan
    ints: tuple


_calls = common.CallTable()     # call signature -> _Call


def _call(qg, k_pages, v_pages, page_idx, pos0, kv_valid, sq, splits):
    """Check one call signature (device, dtypes, shapes) and plan it."""
    dev = qg.device
    index = common.require_hopper(dev)
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
    plan = split_plan(B, NKV, R, pps * page, common.sm_count(index),
                      head_dim=H, kv_bytes=k_pages.element_size(),
                      splits=splits)
    ints = (B, NKV, R, sq, H, page, pps, _KV_DTYPES[k_pages.dtype],
            plan.splits, plan.tokens_per_split, *plan.mode)
    return _Call((B, NKV, R, H), (B, NKV, R), plan, ints)


def paged_flash_decode(qg, k_pages, v_pages, page_idx, pos0, kv_valid, *,
                       sq: int, softcap: float = 0.0,
                       splits: int | None = None):
    """qg: (B, NKV, G*Sq, H) fp32 grouped queries (row r is query column
    r % sq); k/v_pages: (P, page, NKV, H) bf16 or fp32 pool; page_idx:
    (B, pps) int32, any page map (ids below P wherever a row's valid
    tokens lie; entries past kv_valid are never read); pos0 / kv_valid:
    (B,) int32.  ``splits`` forces the KV split (the engine's tuned
    count, and the tests).

    Returns fp32 ``(acc, m, l)`` shaped (B, NKV, G*Sq, H) / (B, NKV, G*Sq)
    / (B, NKV, G*Sq); normalize as ``acc / max(l, 1e-30)``."""
    args = (qg, k_pages, v_pages, page_idx, pos0, kv_valid)
    key = (*((a.shape, a.dtype, a.device, a.data_ptr() % 16 == 0)
             for a in args), sq, splits)
    call = _calls.lookup(key, _call, *args, sq, splits)
    if not all(a.is_contiguous() for a in args):
        raise ValueError("paged_flash_decode: every operand must be "
                         "contiguous")
    dev = qg.device
    acc = torch.empty(call.acc_shape, dtype=torch.float32, device=dev)
    m = torch.empty(call.ml_shape, dtype=torch.float32, device=dev)
    l = torch.empty(call.ml_shape, dtype=torch.float32, device=dev)
    if acc.numel() == 0:
        return acc, m, l
    lib = load_library()
    err = lib.paged_partials_launch(
        *(a.data_ptr() for a in args), acc.data_ptr(), m.data_ptr(),
        l.data_ptr(), *call.ints, float(qg.shape[-1] ** -0.5),
        float(softcap), common.stream_of(qg))
    common.check_launch(lib, "paged_partials_launch", err)
    paged_flash_decode.launches += 1
    return acc, m, l


paged_flash_decode.launches = 0
