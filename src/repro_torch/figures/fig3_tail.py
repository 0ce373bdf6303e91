"""Fig 3, tail handling, measured on the card: the counterpart of
``benchmarks/fig3_tail.py``.

    python -m repro_torch.figures.fig3_tail [--rows 4096]

Task: y = silu(x) * 2 over the first ``active_frac`` of a (rows, 128)
fp32 array, at active fractions 0.5, 0.75, 0.9 and 0.99, two ways:
  exact   (vsetvl)      the port's ``exact_tail`` over the valid rows:
                        whole 8-row tiles in one launch, the remainder in
                        a second launch sized to it
  masked  (predication) the port's ``masked_full`` over all the rows,
                        every tile computed and masked to ``n_valid``

The JAX figure's TPU model (``MASK_SELECT_COST``, ``model_*_gops``) is
gone: the columns are the measured Gelem/s of valid elements and the
card's bound for each idiom, 8 bytes per element it moves (the valid
ones for exact, all the padded ones for masked) or ~6 operations per
element at the fp32 rate, whichever is longer.  ``penalty`` is 1 -
exact time / masked time; the bytes predict it at 1 - active fraction.
Times are CUDA-event medians by ``repro_torch.perf.measure``
(interleaved rounds, L2 flushed).  Each output is held against the plain
version within rtol 1e-6.
"""
from __future__ import annotations

import argparse
from typing import Dict, List, Optional

import numpy as np
import torch

from repro_torch.core.costmodel import HWSpec, hw_of
from repro_torch.kernels.common import resolve_device
from repro_torch.kernels.tailmask import ops as tail_ops
from repro_torch.kernels.tailmask import ref as tail_ref
from repro_torch.perf.measure import measure_group

LANE = 128
BLOCK_ROWS = 8
ROWS = 4096                      # the JAX figure's total_rows
CARD_ROWS = 1 << 21              # 1 GiB of input, past the 50 MB L2
FRACS = (0.5, 0.75, 0.9, 0.99)
FLOPS_PER_ELEM = 6.0             # silu * 2: exp, add, divide, multiply
REPS = 5
RTOL = 1e-6


def _check(what: str, got: torch.Tensor, want: torch.Tensor) -> None:
    if not torch.allclose(got, want, rtol=RTOL, atol=0.0):
        err = float((got - want).abs().max())
        raise AssertionError(f"fig3 {what}: max abs err {err:.3e} past "
                             f"rtol {RTOL}")


def run(device=None, rows: int = ROWS, *, measure: bool = True,
        hw: Optional[HWSpec] = None) -> List[Dict]:
    dev = resolve_device(device)
    hw = hw_of(dev, hw)
    x = torch.from_numpy(np.random.default_rng(1).random(
        (rows, LANE), dtype=np.float32)).to(dev)
    padded = rows * LANE
    out = []
    for frac in FRACS:
        n_valid_rows = int(rows * frac)
        n_valid = n_valid_rows * LANE
        hx = x[:n_valid_rows]
        fns = {"exact": (lambda a: tail_ops.tail_compute(
                   a, "exact_tail", block_rows=BLOCK_ROWS), (hx,)),
               "masked": (lambda a, nv=n_valid: tail_ops.tail_compute(
                   a, "masked_full", n_valid=nv, block_rows=BLOCK_ROWS),
                   (x,))}
        if measure:
            meas = measure_group(fns, reps=REPS, flush_l2=True, cover_ms=2.0)
            res = {k: m.result for k, m in meas.items()}
        else:
            meas = {}
            res = {k: f(*a) for k, (f, a) in fns.items()}
        want = tail_ref.compute(x)
        _check(f"exact frac {frac}", res["exact"], want[:n_valid_rows])
        want[n_valid_rows:] = 0.0
        _check(f"masked frac {frac}", res["masked"], want)
        del want
        b_exact, by = hw.bound_s(FLOPS_PER_ELEM * n_valid, 8.0 * n_valid,
                                 torch.float32)
        b_masked, _ = hw.bound_s(FLOPS_PER_ELEM * padded, 8.0 * padded,
                                 torch.float32)
        t = {k: m.median_s for k, m in meas.items()}
        out.append({
            "rows": rows, "active_frac": frac, "n_valid": n_valid,
            "exact_seconds": t.get("exact"), "masked_seconds": t.get("masked"),
            "exact_gelem_per_s": n_valid / t["exact"] / 1e9 if t else None,
            "masked_gelem_per_s": n_valid / t["masked"] / 1e9 if t else None,
            "penalty": 1 - t["exact"] / t["masked"] if t else None,
            "bytes_penalty": 1 - b_exact / b_masked,
            "bound_exact_gelem_per_s": n_valid / b_exact / 1e9,
            "bound_masked_gelem_per_s": n_valid / b_masked / 1e9,
            "bound_by": by, "hw": hw.name,
        })
    return out


def print_rows(rows: List[Dict]) -> None:
    print(f"Fig 3: tail handling, ({rows[0]['rows']}, {LANE}) fp32, "
          f"Gelem/s of valid elements against the bound ({rows[0]['hw']})")
    for r in rows:
        if r["penalty"] is None:
            got = "not measured"
        else:
            got = (f"exact {r['exact_gelem_per_s']:.2f} masked "
                   f"{r['masked_gelem_per_s']:.2f} penalty "
                   f"{100 * r['penalty']:.1f}%")
        print(f"  frac {r['active_frac']:.2f}  {got}  (bound exact "
              f"{r['bound_exact_gelem_per_s']:.2f} masked "
              f"{r['bound_masked_gelem_per_s']:.2f}, bytes penalty "
              f"{100 * r['bytes_penalty']:.1f}%)")


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--rows", type=int, default=ROWS)
    print_rows(run(rows=ap.parse_args(argv).rows))


if __name__ == "__main__":
    main()
