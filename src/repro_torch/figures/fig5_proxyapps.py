"""Fig 5, the six proxy apps x {scalar, autovec, kernel}: the counterpart
of ``benchmarks/fig5_proxyapps.py``.

    python -m repro_torch.figures.fig5_proxyapps [--device cpu]

Fig 5a: each version's time normalized to the scalar version (the paper
normalizes to GCC's non-vectorized build), beside the card's bound for
the app.  Fig 5b: the op-reduction ratio against the speedup, the
instruction-reduction predictor.  Both come from ``core.veceval``: times
are CUDA-event medians on the card (``None`` without ``measure``), the
op counts the executed aten ops of the counter channels (the
dispatcher's; on a CUDA device it cannot see the compiled and kernel
versions, whose counts and reductions are then ``None``), and flops are
read through the calibration-gated channels (``flops_source``: the flop
counter where it calibrated reliable for the program's structure, else
the analytic model).
"""
from __future__ import annotations

import argparse
from typing import Dict, List, Optional

from repro_torch.core import veceval
from repro_torch.core.costmodel import HWSpec


def run(device=None, *, measure: bool = True, apps=None,
        sizes: Optional[Dict[str, Dict]] = None,
        scalar_max_iters: Optional[int] = None,
        hw: Optional[HWSpec] = None) -> List[Dict]:
    rows = veceval.run_all(measure=measure, apps=apps, device=device,
                           sizes=sizes, scalar_max_iters=scalar_max_iters,
                           hw=hw)
    by_app: Dict[str, Dict[str, Dict]] = {}
    for r in rows:
        by_app.setdefault(r["app"], {})[r["version"]] = r
    view = []
    for app, versions in by_app.items():
        base = versions["scalar"]["host_seconds"]
        for vname, r in versions.items():
            t = r["host_seconds"]
            view.append({
                "app": app, "version": vname, "host_seconds": t,
                "speedup_vs_scalar": base / t if base and t else None,
                "op_reduction": r["op_reduction_vs_scalar"],
                "hlo_ops": r["hlo_ops"], "ops_source": r["ops_source"],
                "ops_note": r["ops_note"],
                "bound_seconds": r["bound_seconds"],
                "bound_by": r["bound_by"], "hw": r["hw"],
                "flops": r["flops"], "flops_source": r["flops_source"],
                "omitted": r["omitted"],
            })
    return view


def _f(x, fmt):
    return "—" if x is None else format(x, fmt)


def print_rows(rows: List[Dict]) -> None:
    print(f"Fig 5: proxy apps, speedup over scalar and op reduction "
          f"(bound: {rows[0]['hw']})")
    for r in rows:
        print(f"  {r['app']:8s} {r['version']:8s} "
              f"{_f(r['host_seconds'] and r['host_seconds'] * 1e3, '.4f')} "
              f"ms (bound {r['bound_seconds'] * 1e3:.4f} ms, "
              f"{r['bound_by']})  speedup {_f(r['speedup_vs_scalar'], '.1f')}"
              f"  ops {_f(r['hlo_ops'], 'd')} ({r['ops_source']}) reduction "
              f"{_f(r['op_reduction'], '.1f')}  flops {r['flops_source']}")


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None)
    args = ap.parse_args(argv)
    rows = run(args.device, measure=args.device in (None, "cuda"))
    print_rows(rows)
    print("  verdicts read under: "
          f"{veceval.channel_verdicts(args.device)}")
    return rows


if __name__ == "__main__":
    main()
