"""Block-multiplier ("LMUL") selection for the CUDA kernels, and the
measured best-config cache: the counterpart of ``repro.core.autotune``.

RVV's LMUL trades elements per instruction against register pressure.
The TPU kernels' analogue scales a VMEM tile; on Hopper the same knob
(``block_multiplier``) scales a block's tile, and what it trades against
is the SM's on-chip budget (``HWSpec``): shared memory and the register
file set how many blocks an SM holds, and so how many waves the grid
takes; a tile whose accumulators pass the 255 registers a thread may
hold spills to local memory.  That is the cliff the paper sees at LMUL 8
(Fig 7); B6 meets it at m 4 in fp64 and m 8 in fp32.

``select_multiplier`` is a pure cost-model decision (no card needed):
for each multiplier the kernel's own plan (``gemm.kernel.plan`` and
``TILES``, ``stream.kernel.plan``) gives its blocks, threads, shared
memory and accumulator registers, and ``predict`` prices it: the blocks
an SM holds (by shared memory, registers and threads), the waves of
blocks over the SMs, the operations over the dtype's peak (slowed by the
last wave's idle SMs) against the bytes over the memory rate, a fixed
cost a wave, and the spill.  The bytes are the operands as the blocks
read them, with no reuse in L2, so small tiles are priced high; a spill
is priced by the share of accumulator updates that go through local
memory (``SPILL_COST`` issue slots each), which places the cliff; its
height is the card's to say.  ``measured_sweep`` is
the validation half: it times candidate callables through
``repro_torch.perf.measure`` (CUDA events, interleaved rounds, medians,
the L2 flushed before each call: a served kernel's operands come from
device memory), so Fig 7 can hold "default ~ optimal" against the card.

``cached_best_config`` memoizes a measured sweep in a schema-valid
Report (``repro_torch.perf.report``) at ``AUTOTUNE_CACHE_PATH``, in the
git-ignored ``build/`` (the reference's cache sits in
``benchmarks/results/``, which the port leaves to it), written to a
temporary file and renamed, since several engines may tune at once.
``tune_paged_attention`` sweeps B1's knob on Hopper, its KV split count
(``paged_attention.kernel.split_plan``), where the reference sweeps the
Pallas kernel's ``block_pages``.  It keeps ``split_plan``'s own count
unless another beats it in most of the sweep's paired rounds and by a
margin (``pick_splits``), so timing noise alone cannot move the count,
and with it the summation order of every served decode step.
"""
from __future__ import annotations

import dataclasses
import functools
import json
import math
import os
import pathlib
import statistics
import tempfile
from typing import Any, Callable, Dict, List, Optional, Tuple

import torch

from repro_torch.core.costmodel import H100_SXM, HWSpec
from repro_torch.kernels.common import (REPO_ROOT, VALID_MULTIPLIERS,
                                        resolve_device)
from repro_torch.kernels.flash_attention import kernel as fa_kernel
from repro_torch.kernels.gemm import kernel as gemm_kernel
from repro_torch.kernels.stream import kernel as stream_kernel
from repro_torch.perf.measure import measure_group

# On-disk best-config cache: a schema-valid perf Report (rows =
# {key, best, medians_s, reps}).  Repeated engine constructions skip the
# sweep; retune=True forces re-measurement.
AUTOTUNE_CACHE_PATH = REPO_ROOT / "build" / "autotune_cache.json"

# the impl field of the paged-attention key: the CUDA kernel it times
PAGED_IMPL = "cuda_paged_partials"
# interleaved rounds of the split sweep (a B1 call is ~30 us: 15 rounds of
# every count take ~0.1 s); the share of them a count must win against
# split_plan's (a sign test: 12 of 15, p < 0.02 under a coin) and the share
# of its median it must save to replace it (B1 is ~2% of granite's decode
# step, so 15% of B1 is ~0.3% of the step)
PAGED_REPS = 15
WIN_SHARE = 0.8
MIN_GAIN = 0.15

REG_OVERHEAD = 32          # registers a thread beyond its accumulators
WAVE_OVERHEAD_S = 0.3e-6   # a wave's fixed cost: block launch, pipeline fill
SPILL_COST = 8.0           # issue slots a spilled accumulator update costs
                           # beside its FMA (an assumed price, not fitted)


@dataclasses.dataclass(frozen=True)
class BlockPlan:
    """One multiplier's launch, as the kernel's plan gives it."""
    blocks: int
    threads: int               # a block
    smem_bytes: int            # a block
    acc_regs: int              # accumulator registers a thread
    flops: float               # the whole launch
    hbm_bytes: float           # operands as the blocks read them + output


@dataclasses.dataclass
class KernelShape:
    """A kernel's launch at each block multiplier, and the type its
    arithmetic runs in."""
    name: str
    dtype: torch.dtype
    plans: Dict[int, BlockPlan]


@dataclasses.dataclass
class TuneReport:
    multiplier: int
    working_set: float         # shared memory a block
    predicted_s: float
    bound: str                 # compute | memory | spill | smem
    fits_vmem: bool            # fits on chip (the reference's name): shared
                               # memory, and no spill
    blocks_per_sm: int = 0
    waves: int = 0
    regs_per_thread: int = 0   # accumulators + overhead, capped at the budget
    spill: bool = False


def predict(ks: KernelShape, m: int, hw: HWSpec = H100_SXM) -> TuneReport:
    p = ks.plans[m]
    spill = p.acc_regs > hw.regs_per_thread
    regs = min(p.acc_regs + REG_OVERHEAD, hw.regs_per_thread)
    fits_smem = p.smem_bytes <= hw.smem_per_block
    by_smem = (hw.smem_per_sm // (p.smem_bytes + hw.smem_reserved_per_block)
               if p.smem_bytes else hw.blocks_per_sm)
    per_sm = max(1, min(by_smem, hw.regs_per_sm // (regs * p.threads),
                        hw.threads_per_sm // p.threads, hw.blocks_per_sm))
    slots = hw.sm_count * per_sm
    waves = max(1, -(-p.blocks // slots))
    busy = p.blocks / (waves * slots)          # the last wave's idle SMs
    t_compute = p.flops / hw.peak_flops(ks.dtype) / busy
    t_mem = p.hbm_bytes / hw.hbm_bw
    # a spilled register's every update adds a local load and store
    penalty = (1.0 + SPILL_COST * (p.acc_regs + REG_OVERHEAD
                                   - hw.regs_per_thread) / p.acc_regs
               if spill else 1.0)
    t = max(t_compute, t_mem) * penalty + waves * WAVE_OVERHEAD_S
    if not fits_smem:                          # the block cannot launch
        t = math.inf
    bound = "compute" if t_compute >= t_mem else "memory"
    if spill:
        bound = "spill"
    if not fits_smem:
        bound = "smem"
    return TuneReport(m, float(p.smem_bytes), t, bound,
                      fits_smem and not spill, per_sm, waves, regs, spill)


def select_multiplier(ks: KernelShape,
                      hw: HWSpec = H100_SXM) -> Tuple[int, List[TuneReport]]:
    reports = [predict(ks, m, hw) for m in VALID_MULTIPLIERS
               if m in ks.plans]
    best = min(reports, key=lambda r: r.predicted_s)
    return best.multiplier, reports


def measured_sweep(candidates: Dict[str, Tuple[Callable, tuple]],
                   reps: int = 3) -> Dict[str, float]:
    """Measured validation sweep over block-knob candidates, on the card.

    ``candidates`` maps a label (e.g. a split count) to ``(fn, args)``;
    all candidates are timed in the same interleaved rounds and the
    returned dict carries each label's median seconds between two CUDA
    events."""
    return {name: m.median_s for name, m in measure_group(
        candidates, reps=reps, flush_l2=True).items()}


# -- persistent best-config cache -------------------------------------------
def _load_cache_rows(path: pathlib.Path) -> List[Dict[str, Any]]:
    try:
        payload = json.loads(path.read_text())
    except (OSError, json.JSONDecodeError):
        return []
    if not isinstance(payload, dict) \
            or payload.get("schema") != "repro.perf.report":
        return []
    rows = payload.get("rows")
    return rows if isinstance(rows, list) else []


def _write_cache_rows(path: pathlib.Path,
                      rows: List[Dict[str, Any]]) -> None:
    from repro_torch.perf import report as perf_report
    rep = perf_report.make_report(
        "autotune_cache", rows,
        meta={"writer": "repro_torch.core.autotune.cached_best_config",
              "statistic": "median_s (interleaved measured_sweep, CUDA "
                           "events)"})
    path.parent.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".json", dir=path.parent)
    with os.fdopen(fd, "w") as f:
        f.write(rep.to_json())
    os.replace(tmp, path)           # atomic: a reader never sees half


def _cached_row(key: str, labels: List[str], sweep: Callable[[], Dict],
                retune: bool, path: pathlib.Path) -> Dict[str, Any]:
    """The cache row of ``key`` whose candidate labels are ``labels``, or
    ``sweep()``'s new row written in its place."""
    rows = _load_cache_rows(path)
    if not retune:
        for row in rows:
            if (row.get("key") == key
                    and sorted(row.get("medians_s", {})) == labels):
                return {**row, "source": "cache"}
    row = sweep()
    _write_cache_rows(path,
                      [r for r in rows if r.get("key") != key] + [row])
    return {**row, "source": "measured"}


def cached_best_config(key: str,
                       candidates: Dict[str, Tuple[Callable, tuple]], *,
                       reps: int = 3, retune: bool = False,
                       cache_path: Optional[pathlib.Path] = None
                       ) -> Dict[str, Any]:
    """``measured_sweep`` with an on-disk memo.

    A cache row matches when its ``key`` AND candidate-label set agree
    (a changed candidate grid invalidates the row).  Returns
    ``{key, best, medians_s, reps, source}`` with ``source`` one of
    ``"cache"`` / ``"measured"``.
    """
    def sweep():
        medians = measured_sweep(candidates, reps=reps)
        return {"key": key, "best": min(medians, key=medians.get),
                "medians_s": {k: float(v) for k, v in medians.items()},
                "reps": reps}

    return _cached_row(key, sorted(candidates), sweep, retune,
                       pathlib.Path(cache_path) if cache_path
                       else AUTOTUNE_CACHE_PATH)


def _spread(samples: List[float]) -> float:
    """The interquartile range of one candidate's samples (0 for fewer
    than two)."""
    if len(samples) < 2:
        return 0.0
    q1, _, q3 = statistics.quantiles(samples, n=4)
    return float(q3 - q1)


def pick_splits(samples_s: Dict[str, List[float]],
                plan: int) -> Tuple[int, str]:
    """The split count the engine serves at, and why, from a sweep's
    samples (``samples_s[label][i]``: the label's time in interleaved
    round i, so the labels' samples pair up round by round).  ``plan``,
    the count ``split_plan`` picks from the shapes alone, is kept unless
    another count beats it twice over: faster in at least ``WIN_SHARE``
    of the rounds (a sign test, which noise that hits every count of a
    round alike cannot pass) and by at least ``MIN_GAIN`` of its median.
    Of the counts that do, the fastest.  Counts a few per cent apart
    trade places from run to run, and with them the summation order of
    every served decode step; B1 is a few per cent of a decode step, so
    such a gain moves the step less than its own noise."""
    medians = {k: statistics.median(v) for k, v in samples_s.items()}
    plan_label = f"s{plan}"
    base = samples_s[plan_label]

    def beats(label):
        wins = sum(a < b for a, b in zip(samples_s[label], base))
        return (wins >= WIN_SHARE * len(base)
                and medians[label] <= (1 - MIN_GAIN) * medians[plan_label])

    better = [k for k in samples_s if k != plan_label and beats(k)]
    fastest = min(medians, key=medians.get)
    if not better:
        gain = 1 - medians[fastest] / medians[plan_label]
        return plan, (f"kept split_plan's {plan}: the fastest, {fastest}, "
                      f"is {100 * gain:.1f}% under its median; a count "
                      f"must win {WIN_SHARE:.0%} of the rounds and "
                      f"{100 * MIN_GAIN:.0f}% of the median")
    best = min(better, key=medians.get)
    gain = 1 - medians[best] / medians[plan_label]
    return int(best[1:]), (
        f"{best} beat split_plan's {plan} in {WIN_SHARE:.0%} or more of "
        f"{len(base)} rounds, {100 * gain:.1f}% under its median")


def paged_kv_lens(n_slots: int, max_len: int) -> List[int]:
    """The rows' KV lengths of the split sweep: a continuous batch holds
    its requests at every stage, so row i is filled to (i + 1) / n_slots
    of the table (with 8 slots over 512 tokens: 64, 128, ..., 512)."""
    return [max(1, max_len * (i + 1) // n_slots) for i in range(n_slots)]


def tune_paged_attention(*, n_slots: int, max_len: int, page_size: int,
                         n_kv_heads: int, n_q_heads: int, head_dim: int,
                         dtype: str, impl: Optional[str] = None,
                         reps: int = PAGED_REPS, retune: bool = False,
                         cache_path: Optional[pathlib.Path] = None,
                         device=None) -> Dict[str, Any]:
    """Sweep the KV split count of the paged flash-decode kernel (B1) at
    the engine's pure-decode shape: every distinct count ``split_plan``
    makes of a forced 1..``MAX_SPLITS``, each a decode call of
    ``n_slots`` rows at the ragged lengths of ``paged_kv_lens``, timed as
    interleaved contenders on the card (``device``, ``cuda`` unless
    named), ``reps`` rounds.

    Keyed as the reference keys it, on (head_dim, n_kv_heads, group,
    page_size, pages_per_seq, dtype, impl).  Returns the reference's
    fields (``key``, ``best``: the fastest count's label, ``medians_s``,
    ``source``; its ``block_pages`` is 1: the CUDA kernel has no such
    knob) plus ``reps``, ``samples_s`` (each count's time a round),
    ``spread_s`` (its interquartile range), ``kv_valid``,
    ``plan_splits`` (the count ``split_plan`` picks on its own),
    ``splits`` (the count to serve at, ``pick_splits``'s) and ``why``.
    A measured sweep launches the kernel ``(reps + 1) x len(medians_s)``
    times (a warm-up each)."""
    from repro_torch.kernels.common import sm_count
    from repro_torch.kernels.paged_attention import kernel as pa_kernel
    from repro_torch.kernels.paged_attention import ops as pa_ops
    from repro_torch.models.layers import dtype_of
    if impl not in (None, PAGED_IMPL):
        raise ValueError(f"impl {impl!r}: the port's paged kernel is "
                         f"{PAGED_IMPL!r}")
    dev = resolve_device(device)
    pps = max_len // page_size
    key = (f"paged_attention/hd{head_dim}/nkv{n_kv_heads}"
           f"/g{max(n_q_heads // n_kv_heads, 1)}/page{page_size}"
           f"/pps{pps}/{dtype}/{PAGED_IMPL}")
    tdt = dtype_of(dtype)
    lens = paged_kv_lens(n_slots, max_len)
    g = torch.Generator(device=dev).manual_seed(0)
    q = torch.randn((n_slots, 1, n_q_heads, head_dim), generator=g,
                    device=dev).to(tdt)
    kp = torch.randn((n_slots * pps, page_size, n_kv_heads, head_dim),
                     generator=g, device=dev).to(tdt)
    vp = torch.randn(kp.shape, generator=g, device=dev).to(tdt)
    idx = torch.arange(n_slots * pps, dtype=torch.int32,
                       device=dev).reshape(n_slots, pps)
    valid = torch.tensor(lens, dtype=torch.int32, device=dev)
    positions = (valid - 1)[:, None]
    sms = sm_count(dev.index or 0) if dev.type == "cuda" else H100_SXM.sm_count
    R = max(n_q_heads // n_kv_heads, 1)

    def plan(splits=None):
        return pa_kernel.split_plan(n_slots, n_kv_heads, R, pps * page_size,
                                    sms, head_dim=head_dim,
                                    kv_bytes=kp.element_size(),
                                    splits=splits).splits

    counts = sorted({plan(s) for s in range(1, pa_kernel.MAX_SPLITS + 1)})
    candidates = {
        f"s{s}": (functools.partial(pa_ops.paged_attention,
                                    page_size=page_size, splits=s),
                  (q, kp, vp, idx, positions, valid))
        for s in counts}

    def sweep():
        meas = measure_group(candidates, reps=reps, flush_l2=True)
        medians = {k: float(m.median_s) for k, m in meas.items()}
        return {"key": key, "best": min(medians, key=medians.get),
                "medians_s": medians, "reps": reps,
                "samples_s": {k: [float(t) for t in m.all_s]
                              for k, m in meas.items()},
                "kv_valid": lens}

    res = _cached_row(key, sorted(candidates), sweep, retune,
                      pathlib.Path(cache_path) if cache_path
                      else AUTOTUNE_CACHE_PATH)
    splits, why = pick_splits(res["samples_s"], plan())
    return {"key": res["key"], "best": res["best"], "block_pages": 1,
            "splits": splits, "plan_splits": plan(), "why": why,
            "medians_s": res["medians_s"], "samples_s": res["samples_s"],
            "spread_s": {k: _spread(v) for k, v in res["samples_s"].items()},
            "kv_valid": res["kv_valid"], "reps": res["reps"],
            "source": res["source"]}


# -- footprint builders for the shipped kernels -----------------------------
def gemm_shape(M: int, K: int, N: int,
               dtype: torch.dtype = torch.float32) -> KernelShape:
    """B6 at each multiplier, from ``gemm.kernel.plan``: fp64 through the
    tensor cores (two registers an accumulator), fp32 on the CUDA cores;
    256 threads a block, each holding BM x BN / 256 accumulators."""
    dsize = torch.finfo(dtype).bits // 8
    plans = {}
    for m in VALID_MULTIPLIERS:
        p = gemm_kernel.plan(M, N, K, dtype, m)
        bm, bn, _ = p.tile
        blocks = p.grid[0] * p.grid[1]
        plans[m] = BlockPlan(
            blocks=blocks, threads=gemm_kernel.THREADS, smem_bytes=p.smem,
            acc_regs=bm * bn // gemm_kernel.THREADS * dsize // 4,
            flops=2.0 * M * N * K,
            hbm_bytes=float(blocks * (bm + bn) * K * dsize
                            + M * N * dsize))
    return KernelShape("gemm", dtype, plans)


def stream_shape(n_elems: int, dtype_bytes: int = 4,
                 n_arrays: int = 3) -> KernelShape:
    """B9 (triad by default: two arrays read, one written) at each
    multiplier, from ``stream.kernel.plan``: no shared memory, a thread's
    loads held in registers (4 a 16-byte vector of each array read)."""
    plans = {}
    for m in VALID_MULTIPLIERS:
        p = stream_kernel.plan(n_elems, m)
        plans[m] = BlockPlan(
            blocks=p.grid, threads=p.threads, smem_bytes=0,
            acc_regs=(n_arrays - 1) * stream_kernel.VECTOR * p.vectors,
            flops=2.0 * n_elems,
            hbm_bytes=float(n_arrays * n_elems * dtype_bytes))
    return KernelShape("stream", torch.float32, plans)


def flash_shape(S: int, H: int, heads: int = 1,
                dtype: torch.dtype = torch.bfloat16) -> KernelShape:
    """B2's causal forward with its query tile scaled by the multiplier
    (the kernel fixes m 1: ``FWD_PATHS``' tile; there is no knob on the
    card, so this is the model alone).  bf16 runs 128 threads (4 warps),
    fp32 256; a thread holds its rows' output (H) and scores (the KV
    tile) in fp32; shared memory holds the query tile and a two-stage
    K/V ring."""
    path, bq0, bkv = fa_kernel.FWD_PATHS[dtype]
    threads = 128 if path == fa_kernel.TC else 256
    esize = torch.finfo(dtype).bits // 8
    plans = {}
    for m in VALID_MULTIPLIERS:
        bq = bq0 * m
        tiles = -(-S // bq)
        # causal: query tile t reads the K/V of tiles up to its diagonal
        kv_rows = sum(min((t + 1) * bq, S) for t in range(tiles))
        plans[m] = BlockPlan(
            blocks=tiles * heads, threads=threads,
            smem_bytes=(bq * H + 2 * 2 * bkv * H) * esize,
            acc_regs=bq * (H + bkv) // threads,
            flops=4.0 * S * S * H * heads / 2,
            hbm_bytes=float(heads * (2 * S + 2 * kv_rows) * H * esize))
    return KernelShape("flash_attention", dtype, plans)


def grid_reduction(ks: KernelShape) -> Dict[int, float]:
    """Blocks at m 1 over blocks at each m: the "instruction reduction"
    of Fig 8."""
    base = ks.plans[min(ks.plans)].blocks
    return {m: base / max(p.blocks, 1) for m, p in ks.plans.items()}
