"""ctypes bindings of the CUDA flash-attention forward
(csrc/flash_attention.cu) and of the dense-cache flash-decode
(csrc/flash_decode.cu), each its own library.

``flash_fwd`` is the counterpart of the TPU kernel's launcher
(``repro.kernels.flash_attention.kernel.flash_attention_fwd``) over the
grouped layout: q (BN, R, H), k/v (BN, Skv, H) in, ``out`` (q's dtype)
and the per-row log-sum-exp ``lse`` (fp32) out.  ``flash_decode`` is the
counterpart of ``repro.kernels.flash_attention.kernel.flash_decode``:
queries (B, Sq, NQ, H) against a K/V cache (B, S_cache, NKV, H) read in
place by its strides, one valid length a query.  Each checks device,
dtype, shape and layout, allocates its outputs with ``torch.empty``,
launches on the current stream without synchronising, and raises if the
launch returns a CUDA error; ``flash_fwd.launches`` and
``flash_decode.launches`` count the kernel launches made through them.
``fwd_plan`` is the host's copy of what the forward launches: its path
(bf16 on the tensor cores, fp32 on the CUDA cores), tiles, grid and the
KV tiles each query tile visits.  ``decode_plan`` is the same for the
decode: its query slices and the KV split over a thread-block cluster,
which the kernel folds in rank order.
"""
from __future__ import annotations

import ctypes
import functools
import pathlib
from typing import NamedTuple

import torch

from repro_torch.kernels import common

SOURCES = (pathlib.Path(__file__).parent / "csrc" / "flash_attention.cu",)
DECODE_SOURCES = (pathlib.Path(__file__).parent / "csrc" / "flash_decode.cu",)
HEAD_DIMS = (32, 64, 128)
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_MAX_BN = 65535                     # the decode grid's y dimension
_MAX_BLOCKS = 2 ** 31 - 1           # the forward's 1-d grid
TC, SIMT = "tensor cores", "CUDA cores"
# the forward's path and its (query rows, KV rows) tiles, by dtype: bf16
# through mma.sync (fp32 sums, P split into two bf16 halves), fp32 through
# FMAs (TF32 would miss the fp32 tolerance)
FWD_PATHS = {torch.bfloat16: (TC, 128, 64), torch.float32: (SIMT, 64, 64)}
# the decode: 32-token tiles (one a lane), a three-stage ring a warp, at
# most 8 queries a block, at most 8 KV splits (a portable cluster)
DECODE_TILE = 32
DECODE_STAGES = 3
DECODE_MAX_ROWS = 8
DECODE_MAX_SPLITS = 8
SM_SMEM_BYTES = 233472          # an H100 SM's shared memory (228 KB)
BLOCK_RESERVED_BYTES = 1024     # what the card keeps of it for each block
SM_SCHEDULERS = 4               # warp schedulers an SM


class FwdPlan(NamedTuple):
    """The path, the tiles, the number of blocks (one a query tile and
    bn) and, for each block in the order they are issued, its bn, its first
    query row and the KV tiles it visits."""
    path: str
    block_q: int
    block_kv: int
    blocks: int
    tiles: tuple          # ((bn, first row, KV tiles visited), ...)


def kv_tiles(r0: int, block_q: int, block_kv: int, rows: int, skv: int,
             sq: int, causal: bool) -> int:
    """KV tiles the query tile of rows ``r0 .. r0 + block_q - 1`` visits:
    all, or causally up to the one holding its largest query position —
    ``sq - 1`` when the tile wraps into the next query head."""
    n = -(-skv // block_kv)
    if causal:
        r_last = min(r0 + block_q, rows) - 1
        reach = r_last % sq if r0 // sq == r_last // sq else sq - 1
        n = min(n, reach // block_kv + 1)
    return n


def block_tile(L: int, block_q: int, BN: int, rows: int, sq: int):
    """(bn, first query row) of block ``L``, heaviest first: with ``sq`` a
    multiple of the tile, tile i of every query head of every bn reaches
    as far, so the blocks go by i from the last, every (bn, head) at each;
    otherwise the tiles go from the last, every bn at each."""
    if sq % block_q == 0:
        tph, heads = sq // block_q, rows // sq
        i, rem = tph - 1 - L // (BN * heads), L % (BN * heads)
        return rem // heads, ((rem % heads) * tph + i) * block_q
    return L % BN, (-(-rows // block_q) - 1 - L // BN) * block_q


def fwd_plan(BN: int, R: int, Skv: int, sq_real: int, H: int, dtype,
             causal: bool) -> FwdPlan:
    """What csrc/flash_attention.cu launches for ``flash_fwd``."""
    if H not in HEAD_DIMS:
        raise ValueError(f"head_dim {H}: the kernel takes {HEAD_DIMS}")
    if dtype not in FWD_PATHS:
        raise ValueError(f"dtype {dtype} not in {list(FWD_PATHS)}")
    path, bq, bkv = FWD_PATHS[dtype]
    sq = sq_real or R
    blocks = -(-R // bq) * BN
    tiles = []
    for L in range(blocks):
        bn, r0 = block_tile(L, bq, BN, R, sq)
        tiles.append((bn, r0, kv_tiles(r0, bq, bkv, R, Skv, sq, causal)))
    return FwdPlan(path, bq, bkv, blocks, tuple(tiles))


class DecodePlan(NamedTuple):
    """``rows`` queries a block, ``slices`` blocks over the G * Sq queries
    of a (b, kv head); ``splits`` blocks a slice (a cluster), each over
    ``tokens_per_split`` tokens of the cache's capacity; ``grid`` = (B *
    splits, NKV, slices); ``blocks_per_sm`` what the split counts on."""
    rows: int
    slices: int
    splits: int
    tokens_per_split: int
    grid: tuple
    blocks_per_sm: int


def decode_rows(queries: int) -> int:
    """Queries a block holds: the least power of two holding the G * Sq
    queries of a (b, kv head), at most 8."""
    nr = 1
    while nr < min(queries, DECODE_MAX_ROWS):
        nr *= 2
    return nr


def decode_warps(head_dim: int, elem: int) -> int:
    """Warps a block: 2 where a K/V row is over 256 bytes, else 4."""
    return 2 if head_dim * elem > 256 else 4


def decode_smem_bytes(head_dim: int, elem: int, rows: int) -> int:
    """A block's dynamic shared memory (csrc's ``Cfg::kSmem``): the
    queries in fp32 and each warp's ring of K and V tiles, rows padded by
    16 bytes."""
    ring = DECODE_STAGES * 2 * DECODE_TILE * (head_dim * elem + 16)
    return rows * head_dim * 4 + decode_warps(head_dim, elem) * ring


def decode_blocks_per_sm(head_dim: int, elem: int, rows: int) -> int:
    """The blocks an SM holds by shared memory, but no more than give its
    four schedulers a warp each: the kernel's warps are issue-bound (a
    tile's scores, softmax and P.V), so a second block of four warps on an
    SM shares the same issue slots and adds no pull (granite's 6c decode
    on an H100: 4 splits, two blocks an SM, 0.0220 ms; 2 splits, one,
    0.0172: chip_smoke.py's sweep)."""
    by_smem = SM_SMEM_BYTES // (decode_smem_bytes(head_dim, elem, rows)
                                + BLOCK_RESERVED_BYTES)
    return max(min(by_smem, SM_SCHEDULERS // decode_warps(head_dim, elem)),
               1)


@functools.lru_cache(maxsize=4096)
def decode_plan(B: int, Sq: int, NQ: int, NKV: int, H: int, S_cache: int,
                elem: int, sms: int, splits: int | None = None) -> DecodePlan:
    """What csrc/flash_decode.cu launches for ``flash_decode``.  The KV
    range (the cache's capacity, never the lengths: no device value is
    read) is split only as far as the grid stays within one wave of
    ``decode_blocks_per_sm``: the largest count <= 8 with B * NKV * slices
    * splits <= sms * blocks_per_sm, at least 1, each split whole
    ``DECODE_TILE``-token tiles.  ``splits`` forces a count (tests only;
    still at most the tiles there are)."""
    queries = Sq * (NQ // NKV)
    rows = decode_rows(queries)
    slices = max(-(-queries // rows), 1)
    blocks = max(B * NKV * slices, 1)
    per_sm = decode_blocks_per_sm(H, elem, rows)
    tiles = max(-(-S_cache // DECODE_TILE), 1)
    if splits is None:
        want = max(min(sms * per_sm // blocks, DECODE_MAX_SPLITS, tiles), 1)
    elif 1 <= splits <= DECODE_MAX_SPLITS:
        want = min(splits, tiles)
    else:
        raise ValueError(f"splits={splits} not in 1..{DECODE_MAX_SPLITS}")
    per = -(-tiles // want)
    n = -(-tiles // per)
    return DecodePlan(rows, slices, n, per * DECODE_TILE,
                      (B * n, NKV, slices), per_sm)


@functools.lru_cache(maxsize=None)
def load_library() -> ctypes.CDLL:
    """Build (at first use) and load the kernel library, once a process."""
    lib = common.build_library("flash_attention", SOURCES)
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    common.bind(lib, "flash_fwd_launch", *[p] * 5, *[i] * 7, f, f)
    return lib


@functools.lru_cache(maxsize=None)
def load_decode_library() -> ctypes.CDLL:
    """Build (at first use) and load the flash-decode library, once a
    process."""
    lib = common.build_library("flash_decode", DECODE_SOURCES)
    p, i, ll, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, \
        ctypes.c_float
    common.bind(lib, "flash_decode_launch", *[p] * 5, *[i] * 7, *[ll] * 4,
                i, i, f, f)
    lib.flash_decode_smem_bytes.argtypes = [i, i, i]
    lib.flash_decode_smem_bytes.restype = i
    return lib


def flash_fwd(q, k, v, *, causal: bool = True, softcap: float = 0.0,
              sq_real: int = 0):
    """q: (BN, R, H), row r the query column r % sq_real (0: R); k/v:
    (BN, Skv, H); all fp32 or all bf16, contiguous (bf16: each starting
    on a 16-byte boundary), on a Hopper card.

    Returns ``(out (BN, R, H) in q.dtype, lse (BN, R) fp32)``."""
    dev = q.device
    common.require_hopper(dev)
    BN, R, H = q.shape
    Skv = k.shape[1]
    if H not in HEAD_DIMS:
        raise ValueError(f"head_dim {H}: the kernel takes {HEAD_DIMS}")
    if q.dtype not in _DTYPES:
        raise ValueError(f"dtype {q.dtype} not in {list(_DTYPES)}")
    sq = sq_real or R
    if sq <= 0 or (R and R % sq):
        raise ValueError(f"rows {R} not a multiple of sq_real={sq}")
    if -(-R // FWD_PATHS[q.dtype][1]) * BN > _MAX_BLOCKS:
        raise ValueError(f"{BN} x {R} rows: more blocks than the grid takes")
    align = 16 if FWD_PATHS[q.dtype][0] == TC else 0
    common.check_operand("q", q, q.dtype, dev, align=align)
    common.check_operand("k", k, q.dtype, dev, (BN, Skv, H), align)
    common.check_operand("v", v, q.dtype, dev, (BN, Skv, H), align)
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


def _cache_strides(name, t, B, NKV, H, like):
    """(batch, token) strides in elements of a (B, S_cache, NKV, H) cache
    view whose last two dimensions are contiguous; the kernel reads it as
    16-byte vectors."""
    if t.device != like.device or t.dtype != like.dtype:
        raise ValueError(f"{name}: {t.dtype} on {t.device}, expected "
                         f"{like.dtype} on {like.device}")
    if t.dim() != 4 or t.shape[0] != B or tuple(t.shape[2:]) != (NKV, H):
        raise ValueError(f"{name}: shape {tuple(t.shape)}, expected "
                         f"({B}, S, {NKV}, {H})")
    sb, st, sn, sh = t.stride()
    vec = 16 // t.element_size()
    if (sh, sn) != (1, H) or sb % vec or st % vec or t.data_ptr() % 16:
        raise ValueError(f"{name}: strides {t.stride()} (heads and head "
                         f"dims must be contiguous; batch and token strides "
                         f"multiples of 16 bytes, the base 16-byte aligned)")
    return sb, st


def flash_decode(q, k, v, lens, *, softcap: float = 0.0,
                 splits: int | None = None):
    """q: (B, Sq, NQ, H) contiguous; k/v: (B, S_cache, NKV, H) caches, any
    batch and token strides (a layer's view of a stacked cache, a row of
    a slotted one); lens: (B, Sq) int32, query c of row b attending to
    the keys ``t < lens[b, c]`` (clamped to [0, S_cache]); q, k, v fp32 or
    all bf16, on a Hopper card.  ``splits`` forces the KV split (tests
    only).

    Returns (B, Sq, NQ, H) in q.dtype; a query with no valid key is 0."""
    dev = q.device
    index = common.require_hopper(dev)
    if q.dim() != 4:
        raise ValueError(f"q must be (B, Sq, NQ, H), got {tuple(q.shape)}")
    B, Sq, NQ, H = q.shape
    S, NKV = k.shape[1], k.shape[2]
    if H not in HEAD_DIMS:
        raise ValueError(f"head_dim {H}: the kernel takes {HEAD_DIMS}")
    if q.dtype not in _DTYPES:
        raise ValueError(f"dtype {q.dtype} not in {list(_DTYPES)}")
    if NKV == 0 or NQ % NKV or NKV > _MAX_BN or \
            -(-Sq * (NQ // NKV) // 8) > _MAX_BN:
        raise ValueError(f"{NQ} query heads over {NKV} KV heads, Sq {Sq}: "
                         f"not a grid the kernel takes")
    common.check_operand("q", q, q.dtype, dev)
    k_sb, k_st = _cache_strides("k", k, B, NKV, H, q)
    v_sb, v_st = _cache_strides("v", v, B, NKV, H, q)
    if v.shape[1] != S:
        raise ValueError(f"v holds {v.shape[1]} tokens, k {S}")
    common.check_operand("lens", lens, torch.int32, dev, (B, Sq))
    out = torch.empty((B, Sq, NQ, H), dtype=q.dtype, device=dev)
    if B == 0 or Sq == 0:
        return out
    plan = decode_plan(B, Sq, NQ, NKV, H, S, q.element_size(),
                       common.sm_count(index), splits)
    lib = load_decode_library()
    err = lib.flash_decode_launch(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), lens.data_ptr(),
        out.data_ptr(), B, Sq, NKV, NQ // NKV, H, _DTYPES[q.dtype], S,
        k_sb, k_st, v_sb, v_st, plan.splits, plan.tokens_per_split,
        float(H ** -0.5), float(softcap), common.stream_of(q))
    common.check_launch(lib, "flash_decode_launch", err)
    flash_decode.launches += 1
    return out


flash_decode.launches = 0
