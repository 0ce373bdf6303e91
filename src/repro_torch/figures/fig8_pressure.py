"""Fig 8, why bigger blocks stop helping: the counterpart of
``benchmarks/fig8_pressure.py``.

    python -m repro_torch.figures.fig8_pressure [--device cpu]

The paper's YOLOv3 finding: the instruction count keeps falling with
LMUL while the speedup flattens at the pipeline's (here the memory's)
limit.  On the card: B9's triad over 2^26 fp32 (three 256 MiB arrays,
far past the L2) at block multiplier 1, 2, 4, 8, each thread moving m
16-byte vectors an array.  The grid's block count falls as 1/m (the
"instruction reduction"); ``core.autotune.predict`` prices each m (the
waves of blocks, a fixed cost a wave, the bytes over the memory rate),
and with ``measure`` (the card) each m is timed
(``autotune.measured_sweep``: CUDA events, interleaved rounds, medians,
L2 flushed), its output held against the plain version bit for bit.
Each row states the bound (12 bytes an element over the memory rate)
beside the times.
"""
from __future__ import annotations

import argparse
from typing import Dict, List, Optional

import numpy as np
import torch

from repro_torch.core import autotune
from repro_torch.core.costmodel import HWSpec, hw_of
from repro_torch.kernels.common import VALID_MULTIPLIERS, resolve_device
from repro_torch.kernels.stream import ops as stream_ops
from repro_torch.kernels.stream import ref as stream_ref

N = 1 << 26
REPS = 5


def run(device=None, n: int = N, *, measure: bool = True,
        hw: Optional[HWSpec] = None) -> List[Dict]:
    dev = resolve_device(device)
    hw = hw_of(dev, hw)
    ks = autotune.stream_shape(n)
    reduction = autotune.grid_reduction(ks)
    bound_s, by = hw.bound_s(2.0 * n, 12.0 * n, torch.float32)
    meds: Dict[str, float] = {}
    if measure:
        x = torch.from_numpy(np.random.default_rng(0).random(
            n, dtype=np.float32)).to(dev)
        y = torch.from_numpy(np.random.default_rng(1).random(
            n, dtype=np.float32)).to(dev)
        want = stream_ref.stream("triad", x, y, 2.0)
        fns = {f"m{m}": (lambda x, y, m=m: stream_ops.stream(
            "triad", x, y, block_multiplier=m), (x, y))
            for m in VALID_MULTIPLIERS}
        for name, (fn, args) in fns.items():
            if not torch.equal(fn(*args), want):
                raise AssertionError(f"fig8 triad {name}: output differs "
                                     f"from the plain version")
        meds = autotune.measured_sweep(fns, reps=REPS)
    rows = []
    for m in VALID_MULTIPLIERS:
        rep = autotune.predict(ks, m, hw)
        t = meds.get(f"m{m}")
        rows.append({
            "n": n, "multiplier": m, "grid_blocks": ks.plans[m].blocks,
            "block_reduction": reduction[m],
            "predicted_ms": rep.predicted_s * 1e3, "bound": rep.bound,
            "waves": rep.waves, "measured_ms": t * 1e3 if t else None,
            "bound_ms": bound_s * 1e3, "bound_by": by, "hw": hw.name,
        })
    for r in rows:
        r["predicted_speedup"] = rows[0]["predicted_ms"] / r["predicted_ms"]
        r["measured_speedup"] = (rows[0]["measured_ms"] / r["measured_ms"]
                                 if r["measured_ms"] else None)
    return rows


def print_rows(rows: List[Dict]) -> None:
    print(f"Fig 8: triad over {rows[0]['n']} fp32, block reduction against "
          f"speedup (bound {rows[0]['bound_ms']:.4f} ms, "
          f"{rows[0]['bound_by']}, {rows[0]['hw']})")
    for r in rows:
        got = ("not measured" if r["measured_ms"] is None else
               f"{r['measured_ms']:.4f} ms, x{r['measured_speedup']:.3f}")
        print(f"  m{r['multiplier']}: {r['grid_blocks']} blocks (x"
              f"{r['block_reduction']:.0f} fewer), {r['waves']} waves, "
              f"model {r['predicted_ms']:.4f} ms x"
              f"{r['predicted_speedup']:.3f}; measured {got}")


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None)
    ap.add_argument("--n", type=int, default=N)
    args = ap.parse_args(argv)
    rows = run(args.device, args.n, measure=args.device in (None, "cuda"))
    print_rows(rows)
    return rows


if __name__ == "__main__":
    main()
