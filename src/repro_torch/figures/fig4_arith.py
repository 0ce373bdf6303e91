"""Fig 4, arithmetic and memory-pattern throughput: the counterpart of
``benchmarks/fig4_arith.py``.

    python -m repro_torch.figures.fig4_arith [--device cpu]

``core.microbench``'s two suites as Fig 4's tables: add/mul/fma/div over
f32, bf16, i32 and i8 (Gops/s), and the unit-stride, triad and strided
memory patterns (Gelem/s; the strided rows through the port's strided
kernels, B10).  Each row states the card's ceiling (``bound_gops``, from
the port's ``HWSpec``, ``hw`` naming it) beside the rate measured on the
card (``host_gops``: CUDA-event time through ``repro_torch.perf.measure``;
``None`` without ``measure``).  The JAX figure's TPU column is gone.
"""
from __future__ import annotations

import argparse
from typing import Dict, List, Optional

from repro_torch.core import microbench
from repro_torch.core.costmodel import HWSpec


def run(device=None, *, measure: bool = True,
        hw: Optional[HWSpec] = None) -> List[Dict]:
    arith = [{**r.row(), "suite": "arith"} for r in
             microbench.arithmetic_suite(measure=measure, device=device,
                                         hw=hw)]
    mem = [{**r.row(), "suite": "memory"} for r in
           microbench.memory_suite(measure=measure, device=device, hw=hw)]
    return arith + mem


def print_rows(rows: List[Dict]) -> None:
    print(f"Fig 4: arithmetic (Gops/s) and memory patterns (Gelem/s), "
          f"measured against the ceiling ({rows[0]['hw']})")
    for r in rows:
        got = ("not measured" if r["host_gops"] is None
               else f"{r['host_gops']:.1f}")
        print(f"  {r['suite']:6s} {r['name']:22s} {r['dtype']:8s} {got} "
              f"(ceiling {r['bound_gops']:.1f})")


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None)
    args = ap.parse_args(argv)
    on_card = args.device in (None, "cuda")
    rows = run(args.device, measure=on_card)
    print_rows(rows)
    return rows


if __name__ == "__main__":
    main()
