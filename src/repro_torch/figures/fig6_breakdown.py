"""Fig 6, the retired-op mix per app and version: the counterpart of
``benchmarks/fig6_breakdown.py``.

    python -m repro_torch.figures.fig6_breakdown [--device cpu]

The paper splits retired instructions into vector and scalar load/store
and arithmetic classes; the reference buckets its compiled HLO op
histogram into matmul / elementwise / memory-movement / collective /
control classes.  Here the histogram counts executed aten ops
(``core.ophist``, the dispatcher's), so a loop's body counts once an
iteration.  On a CUDA device the dispatcher cannot see Inductor's code
or the hand kernels: those rows have no counts and say why.  Each row
carries the counter verdicts it was read under.  Nothing is timed, so
there is no bound to state.
"""
from __future__ import annotations

import argparse
from typing import Dict, List, Optional

from repro_torch.core import veceval
from repro_torch.core.ophist import CLASSES


def run(device=None, *, apps=None,
        sizes: Optional[Dict[str, Dict]] = None) -> List[Dict]:
    rows = veceval.run_all(measure=False, apps=apps, device=device,
                           sizes=sizes)
    return view(rows, veceval.channel_verdicts(device or "cuda"))


def view(rows: List[Dict], verdicts: Dict[str, bool]) -> List[Dict]:
    """Fig 6's rows from veceval's (timed or not: the counts come from
    its untimed counted run either way)."""
    out = []
    for r in rows:
        cls = r["instruction_classes"] or dict.fromkeys(CLASSES)
        out.append({
            "app": r["app"], "version": r["version"],
            "total_ops": r["hlo_ops"], **cls,
            "ops_source": r["ops_source"], "ops_note": r["ops_note"],
            "verdicts": verdicts,
        })
    return out


def print_rows(rows: List[Dict]) -> None:
    print("Fig 6: executed-op mix (" + ", ".join(CLASSES) + ")")
    for r in rows:
        counted = (" ".join(f"{c} {r[c]}" for c in CLASSES)
                   if r["total_ops"] is not None else r["ops_note"])
        print(f"  {r['app']:8s} {r['version']:8s} {r['total_ops']} ops "
              f"({r['ops_source']}): {counted}")
    print("  verdicts read under: " + ", ".join(
        f"{ch} {'reliable' if ok else 'UNRELIABLE'}"
        for ch, ok in rows[0]["verdicts"].items()))


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None)
    args = ap.parse_args(argv)
    rows = run(args.device)
    print_rows(rows)
    return rows


if __name__ == "__main__":
    main()
