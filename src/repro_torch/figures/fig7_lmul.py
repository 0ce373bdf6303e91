"""Fig 7, the LMUL (block-multiplier) sweep: the counterpart of
``benchmarks/fig7_lmul.py``.

    python -m repro_torch.figures.fig7_lmul [--device cpu]

Two sections, as the reference's:
  (a) the cost model's sweep (``core.autotune.select_multiplier``) of the
      block multiplier {1, 2, 4, 8} over B6 (GEMM 4096^3, fp32 on the
      CUDA cores and fp64 on the tensor cores), B9 (STREAM triad, 2^26
      fp32) and B2's forward at qwen3-1.7b's train shape (S 4096, 16
      heads of 128, bf16, causal; B2 has no multiplier on the card, so
      this one is the model alone): each
      multiplier's shared memory a block, blocks an SM, waves, predicted
      time, bound, whether it fits on chip, and the model's pick;
  (b) measured on the card (``autotune.measured_sweep``: CUDA events,
      interleaved rounds, medians, L2 flushed): B6 at every multiplier
      in both dtypes, and the port's ``chunked_attention`` at the
      reference's 1 x 2048, 4/2 heads of 64, fp32, over ``kv_chunk`` 128
      to 2048 (a knob of the plain path, which the model does not
      price).  Each (b) row names the model's pick and the measured best:
      the paper's "default ~ optimal" question on an H100.  Then
      ``cuobjdump -res-usage`` of the built GEMM library gives each
      multiplier's registers and stack (a spill), held against the
      model's spill flag; a disagreement is a row, not an error.

Every timed row states the card's bound for the work beside its time.
"""
from __future__ import annotations

import argparse
import re
import subprocess
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.core import autotune
from repro_torch.core.costmodel import HWSpec, hw_of
from repro_torch.kernels.common import (VALID_MULTIPLIERS, cuda_tool,
                                        library_path, resolve_device)
from repro_torch.kernels.gemm import kernel as gemm_kernel
from repro_torch.kernels.gemm import ops as gemm_ops
from repro_torch.models.attention import chunked_attention

GEMM_N = 4096
STREAM_N = 1 << 26
FLASH_S, FLASH_H, FLASH_HEADS = 4096, 128, 16   # qwen3-1.7b's train shape
CHUNK_SHAPE = (1, 2048, 4, 2, 64)       # B, S, NQ, NKV, H: the reference's
CHUNKS = (128, 256, 512, 1024, 2048)
REPS = 5
DTYPES = {"fp32": torch.float32, "fp64": torch.float64}


def model_shapes() -> Dict[str, autotune.KernelShape]:
    return {
        "B6 gemm 4096^3 fp32": autotune.gemm_shape(GEMM_N, GEMM_N, GEMM_N,
                                                   torch.float32),
        "B6 gemm 4096^3 fp64": autotune.gemm_shape(GEMM_N, GEMM_N, GEMM_N,
                                                   torch.float64),
        "B9 triad 2^26 fp32": autotune.stream_shape(STREAM_N),
        "B2 flash S4096 16xH128 bf16": autotune.flash_shape(
            FLASH_S, FLASH_H, FLASH_HEADS),
    }


def model_rows(hw: HWSpec) -> List[Dict]:
    rows = []
    for name, ks in model_shapes().items():
        best, reports = autotune.select_multiplier(ks, hw)
        for r in reports:
            rows.append({
                "section": "a", "kernel": name, "multiplier": r.multiplier,
                "smem_kb": r.working_set / 1024,
                "regs_per_thread": r.regs_per_thread,
                "blocks_per_sm": r.blocks_per_sm, "waves": r.waves,
                "predicted_ms": r.predicted_s * 1e3, "bound": r.bound,
                "fits_vmem": r.fits_vmem, "spill": r.spill,
                "selected": r.multiplier == best, "hw": hw.name,
            })
    return rows


def _gemm_sweep(dtype: torch.dtype, dev, hw: HWSpec, pick: int
                ) -> List[Dict]:
    g = np.random.default_rng(7)
    np_dt = np.float64 if dtype == torch.float64 else np.float32
    a = torch.from_numpy(g.random((GEMM_N, GEMM_N)).astype(np_dt)).to(dev)
    b = torch.from_numpy(g.random((GEMM_N, GEMM_N)).astype(np_dt)).to(dev)
    meds = autotune.measured_sweep(
        {f"m{m}": (lambda a, b, m=m: gemm_ops.gemm(a, b, block_multiplier=m),
                   (a, b)) for m in VALID_MULTIPLIERS}, reps=REPS)
    bound_s, by = hw.bound_s(2.0 * GEMM_N ** 3,
                             3.0 * GEMM_N * GEMM_N * a.element_size(),
                             dtype)
    best = int(min(meds, key=meds.get)[1:])
    name = f"B6 gemm 4096^3 {'fp64' if dtype == torch.float64 else 'fp32'}"
    return [{"section": "b", "kernel": name, "knob": "block_multiplier",
             "value": int(k[1:]), "measured_ms": t * 1e3,
             "bound_ms": bound_s * 1e3, "bound_by": by,
             "model_pick": pick, "measured_best": best,
             "pick_over_best": meds[f"m{pick}"] / meds[f"m{best}"],
             "hw": hw.name} for k, t in meds.items()]


def _chunk_sweep(dev, hw: HWSpec) -> List[Dict]:
    B, S, NQ, NKV, H = CHUNK_SHAPE
    g = torch.Generator(device=dev).manual_seed(0)
    q = torch.randn((B, S, NQ, H), generator=g, device=dev)
    k = torch.randn((B, S, NKV, H), generator=g, device=dev)
    v = torch.randn((B, S, NKV, H), generator=g, device=dev)
    meds = autotune.measured_sweep(
        {str(c): (lambda q, k, v, c=c: chunked_attention(
            q, k, v, causal=True, kv_chunk=c), (q, k, v)) for c in CHUNKS},
        reps=REPS)
    # causal: about half of the 4 S^2 H NQ operations
    bound_s, by = hw.bound_s(2.0 * S * S * H * NQ,
                             4.0 * (2 * B * S * NQ * H + 2 * B * S * NKV * H),
                             torch.float32)
    best = int(min(meds, key=meds.get))
    return [{"section": "b", "kernel": "chunked_attention 1x2048 4/2 H64 "
                                       "fp32 causal",
             "knob": "kv_chunk", "value": int(c), "measured_ms": t * 1e3,
             "bound_ms": bound_s * 1e3, "bound_by": by, "model_pick": None,
             "measured_best": best, "pick_over_best": None, "hw": hw.name}
            for c, t in meds.items()]


_SIMT_RE = re.compile(r"gemm_simtILi(\d+)ELi(\d+)ELb([01])E")
_DMMA_RE = re.compile(r"gemm_dmmaILi(\d+)ELi(\d+)ELi(\d+)ELi(\d+)ELb([01])E")
_RES_RE = re.compile(r"Function\s+(\S+?):?\s+REG:(\d+)\s+STACK:(\d+)\s+"
                     r"SHARED:(\d+)\s+LOCAL:(\d+)")


def parse_res_usage(text: str) -> Dict[Tuple[str, int], Dict]:
    """(dtype, multiplier) -> {regs, stack, local, spill} of the GEMM
    library's kernels from ``cuobjdump -res-usage`` output: the worst of
    a multiplier's two instances (16-byte and element copies)."""
    tile_m = {tile: m for m, tile in gemm_kernel.TILES.items()}
    out: Dict[Tuple[str, int], Dict] = {}
    for fn, reg, stack, _, local in _RES_RE.findall(text):
        simt, dmma = _SIMT_RE.search(fn), _DMMA_RE.search(fn)
        if simt:
            key = ("fp32", tile_m[(16 * int(simt[1]), 16 * int(simt[2]))])
        elif dmma:
            key = ("fp64", tile_m[(int(dmma[1]), int(dmma[2]))])
        else:
            continue
        prev = out.get(key, {"regs": 0, "stack": 0, "local": 0})
        rec = {"regs": max(prev["regs"], int(reg)),
               "stack": max(prev["stack"], int(stack)),
               "local": max(prev["local"], int(local))}
        rec["spill"] = rec["stack"] > 0 or rec["local"] > 0
        out[key] = rec
    return out


def res_usage_rows(hw: HWSpec) -> List[Dict]:
    """The model's spill flag of each GEMM multiplier against
    ``cuobjdump -res-usage`` of the built library."""
    gemm_kernel.load_library()
    text = subprocess.run(
        [cuda_tool("cuobjdump"), "-res-usage",
         str(library_path("gemm", gemm_kernel.SOURCES))],
        capture_output=True, text=True, check=True).stdout
    usage = parse_res_usage(text)
    rows = []
    for dname, dtype in DTYPES.items():
        ks = autotune.gemm_shape(GEMM_N, GEMM_N, GEMM_N, dtype)
        for m in VALID_MULTIPLIERS:
            got = usage.get((dname, m))
            flag = autotune.predict(ks, m, hw).spill
            rows.append({"section": "res-usage", "kernel": f"B6 gemm {dname}",
                         "multiplier": m, "model_spill": flag,
                         **(got or {"regs": None, "stack": None,
                                    "local": None, "spill": None}),
                         "agree": got is not None and got["spill"] == flag})
    return rows


def run(device=None, *, measure: bool = True,
        hw: Optional[HWSpec] = None) -> List[Dict]:
    """(a) always; (b) and the res-usage rows with ``measure`` (the
    card)."""
    dev = resolve_device(device)
    hw = hw_of(dev, hw)
    rows = model_rows(hw)
    if not measure:
        return rows
    picks = {r["kernel"]: r["multiplier"] for r in rows if r["selected"]}
    for dname, dtype in DTYPES.items():
        rows += _gemm_sweep(dtype, dev, hw, picks[f"B6 gemm 4096^3 {dname}"])
    rows += _chunk_sweep(dev, hw)
    rows += res_usage_rows(hw)
    return rows


def print_rows(rows: List[Dict]) -> None:
    print(f"Fig 7 (a): block-multiplier sweep, cost model ({rows[0]['hw']})")
    for r in (r for r in rows if r["section"] == "a"):
        print(f"  {r['kernel']:26s} m{r['multiplier']}  smem "
              f"{r['smem_kb']:7.1f} KiB  regs {r['regs_per_thread']:3d}  "
              f"{r['blocks_per_sm']} a SM, {r['waves']} waves  "
              f"{r['predicted_ms']:9.4f} ms  {r['bound']:7s} "
              f"{'fits' if r['fits_vmem'] else 'DOES NOT FIT'}"
              f"{'  <- pick' if r['selected'] else ''}")
    for r in (r for r in rows if r["section"] == "b"):
        print(f"  (b) {r['kernel']:40s} {r['knob']} {r['value']:5d}  "
              f"{r['measured_ms']:9.4f} ms (bound {r['bound_ms']:.4f}, "
              f"{r['bound_by']})  model pick {r['model_pick']}, measured "
              f"best {r['measured_best']}")
    for r in (r for r in rows if r["section"] == "res-usage"):
        print(f"  res-usage {r['kernel']} m{r['multiplier']}: REG "
              f"{r['regs']} STACK {r['stack']} LOCAL {r['local']} spill "
              f"{r['spill']}, model {r['model_spill']}"
              f"{'' if r['agree'] else '  DISAGREE'}")


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None)
    args = ap.parse_args(argv)
    rows = run(args.device, measure=args.device in (None, "cuda"))
    print_rows(rows)
    return rows


if __name__ == "__main__":
    main()
