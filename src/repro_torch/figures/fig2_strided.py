"""Fig 2, strided-load idioms, measured on the card: the counterpart of
``benchmarks/fig2_strided.py``.

    python -m repro_torch.figures.fig2_strided [--rows 8192]

Task: gather every ``stride``-th row of a (rows, 128) fp32 array, for
strides 2, 4 and 8, three ways:
  strided_rowwise   (vlse)        the port's kernel reading only the rows
                                  needed
  overfetch_select  (masked vle)  the port's kernel streaming every row of
                                  each group and keeping the first
  scalar                          an eager loop, one row copy per
                                  iteration: host-paced; not run when it
                                  would take more than ``SCALAR_MAX_ROWS``
                                  iterations, and the row says why

The JAX figure's TPU model (``DMA_OVERHEAD_S``, ``model_gops``) is gone:
the columns are the measured output Gelem/s and the card's bound for the
function, each output element read once and written once (8 bytes) over
the memory rate of the port's ``HWSpec``.  Times are CUDA-event medians
by ``repro_torch.perf.measure`` (interleaved rounds, L2 flushed).  Each
idiom's output is held against the plain version, exactly.
"""
from __future__ import annotations

import argparse
from typing import Dict, List, Optional

import numpy as np
import torch

from repro_torch.core.costmodel import HWSpec, hw_of
from repro_torch.kernels.common import resolve_device
from repro_torch.kernels.strided import ops as strided_ops
from repro_torch.kernels.strided import ref as strided_ref
from repro_torch.perf.measure import measure_group

ROWS, LANE = 1 << 13, 128        # the JAX figure's size
CARD_ROWS = 1 << 21              # 1 GiB of input, past the 50 MB L2
STRIDES = (2, 4, 8)
SCALAR_MAX_ROWS = 4096           # veceval's SCALAR_MAX_ITERS
REPS = 5


def _scalar(x: torch.Tensor, s: int) -> torch.Tensor:
    n = -(-x.shape[0] // s)
    out = torch.empty((n, x.shape[1]), dtype=x.dtype, device=x.device)
    for i in range(n):
        out[i] = x[i * s]
    return out


def _idioms(stride: int):
    return {
        "strided_rowwise": lambda x: strided_ops.strided_gather(
            x, stride, "strided_rowwise"),
        "overfetch_select": lambda x: strided_ops.strided_gather(
            x, stride, "overfetch_select"),
        "scalar": lambda x: _scalar(x, stride),
    }


def run(device=None, rows: int = ROWS, *, measure: bool = True,
        hw: Optional[HWSpec] = None) -> List[Dict]:
    dev = resolve_device(device)
    hw = hw_of(dev, hw)
    x = torch.from_numpy(np.random.default_rng(0).random(
        (rows, LANE), dtype=np.float32)).to(dev)
    out = []
    for stride in STRIDES:
        fns = _idioms(stride)
        out_rows = {"overfetch_select": rows // stride}
        n_scalar = -(-rows // stride)
        omitted = (f"host loop of {n_scalar} iterations > {SCALAR_MAX_ROWS}"
                   if n_scalar > SCALAR_MAX_ROWS else None)
        run_fns = {k: (f, (x,)) for k, f in fns.items()
                   if not (k == "scalar" and omitted)}
        if measure:
            meas = measure_group(run_fns, reps=REPS, flush_l2=True,
                                 cover_ms=2.0)
            results = {k: m.result for k, m in meas.items()}
        else:
            meas = {}
            results = {k: f(*a) for k, (f, a) in run_fns.items()}
        for idiom in fns:
            n_out = out_rows.get(idiom, n_scalar)
            if idiom in results:
                want = strided_ref.strided_gather(x, stride, n_out)
                if not torch.equal(results[idiom], want):
                    raise AssertionError(f"fig2 {idiom} stride {stride}: "
                                         f"output differs from the plain "
                                         f"gather")
            elems = n_out * LANE
            bound_s, by = hw.bound_s(0.0, 8.0 * elems, torch.float32)
            t = meas[idiom].median_s if idiom in meas else None
            out.append({
                "rows": rows, "stride": stride, "idiom": idiom,
                "out_rows": n_out, "seconds": t,
                "gelem_per_s": elems / t / 1e9 if t else None,
                "bound_seconds": bound_s, "bound_by": by,
                "bound_gelem_per_s": elems / bound_s / 1e9, "hw": hw.name,
                "omitted": omitted if idiom == "scalar" else None,
            })
    return out


def print_rows(rows: List[Dict]) -> None:
    print(f"Fig 2: strided-load idioms, ({rows[0]['rows']}, {LANE}) fp32, "
          f"output Gelem/s against the bound ({rows[0]['hw']})")
    for r in rows:
        got = ("omitted: " + r["omitted"] if r["omitted"]
               else "not measured" if r["gelem_per_s"] is None
               else f"{r['gelem_per_s']:.2f}")
        print(f"  stride {r['stride']}  {r['idiom']:17s} {got}  (bound "
              f"{r['bound_gelem_per_s']:.2f})")


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--rows", type=int, default=ROWS)
    print_rows(run(rows=ap.parse_args(argv).rows))


if __name__ == "__main__":
    main()
