"""Table 1, counter calibration: the counterpart of
``benchmarks/table1_counters.py``.

    python -m repro_torch.figures.table1_counters [--device cpu] [--json]

Programs whose flops and op counts are known by construction run under
torch's counters (``core.counters``: ``FlopCounterMode``, the dispatch
histogram and, on the card, the profiler's kernel records), and each
channel is judged reliable or not at the paper's 5% tolerance, at the
moment of the run: the card's kernel records were whole early in a
process and not after a long one (``core.ophist.KernelRecorder``).
This is the calibration pass behind ``repro_torch.perf.channels``:
every counter read of ``core.veceval`` (Figs 5 and 6) is gated on these
verdicts.  ``spawn`` runs the table in a fresh process (``--json``: its
rows as one JSON line), where the card's kernel records are whole;
``collect`` reads them.  A channel torch has no counter for (bytes,
transcendentals) reads as absent and is judged unreliable.  Nothing is
timed, so there is no bound to state.
"""
from __future__ import annotations

import argparse
import json
import os
import pathlib
import subprocess
import sys
from typing import Dict, List

from repro_torch.kernels.common import resolve_device
from repro_torch.perf import channels

N, STEPS = 1 << 16, 8            # the JAX table's sizes


def run(device=None, *, n: int = N, steps: int = STEPS) -> List[Dict]:
    """One row a calibration record, with the verdict of its channel
    (every record of the channel within the tolerance) beside its own."""
    cal = channels.calibrate(n=n, steps=steps,
                             device=resolve_device(device))
    return [{**r, "device": str(resolve_device(device)),
             "channel_reliable": cal.verdicts[r["channel"]]}
            for r in cal.rows()]


def spawn(device=None, *, n: int = N, steps: int = STEPS
          ) -> subprocess.Popen:
    """Start ``run`` in a fresh Python process; ``collect`` its rows."""
    src = str(pathlib.Path(__file__).resolve().parents[2])
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        p for p in (src, os.environ.get("PYTHONPATH")) if p))
    cmd = [sys.executable, "-m", "repro_torch.figures.table1_counters",
           "--json", "--n", str(n), "--steps", str(steps)]
    if device is not None:
        cmd += ["--device", str(device)]
    return subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True, env=env)


def collect(proc: subprocess.Popen, timeout: float = 300.0) -> List[Dict]:
    """The rows of a ``spawn``ed run (it is killed past ``timeout``
    seconds); raises if it failed."""
    try:
        out, err = proc.communicate(timeout=timeout)
    except subprocess.TimeoutExpired:
        proc.kill()
        proc.communicate()
        raise
    if proc.returncode:
        raise RuntimeError(f"table1_counters exited {proc.returncode}: "
                           f"{err[-2000:]}")
    return json.loads(out.strip().splitlines()[-1])


def verdicts(rows: List[Dict]) -> Dict[str, bool]:
    return {r["channel"]: r["channel_reliable"] for r in rows}


def print_rows(rows: List[Dict]) -> None:
    print(f"Table 1: counter calibration on {rows[0]['device']} (5% "
          f"tolerance)")
    for r in rows:
        got = ("absent" if r["measured"] is None
               else f"{r['measured']:.6g} (error {r['error']:.3g})")
        print(f"  {r['channel']:20s} {r['program']:28s} reference "
              f"{r['reference']:.6g}  measured {got}  "
              f"{'reliable' if r['reliable'] else 'UNRELIABLE'}")
    print("  verdicts: " + ", ".join(
        f"{ch} {'reliable' if ok else 'UNRELIABLE'}"
        for ch, ok in verdicts(rows).items()))


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None)
    ap.add_argument("--n", type=int, default=N)
    ap.add_argument("--steps", type=int, default=STEPS)
    ap.add_argument("--json", action="store_true",
                    help="print the rows as one JSON line")
    args = ap.parse_args(argv)
    rows = run(args.device, n=args.n, steps=args.steps)
    if args.json:
        print(json.dumps(rows))
    else:
        print_rows(rows)
    return rows


if __name__ == "__main__":
    main()
