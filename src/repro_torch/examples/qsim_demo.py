"""Qsim demo: one random circuit through the state-vector versions and
layouts.  The counterpart of ``examples/qsim_demo.py``.

    python -m repro_torch.examples.qsim_demo --qubits 14 --depth 6
    python -m repro_torch.examples.qsim_demo --device cpu

Versions: the interleaved and planar layouts as plain torch expressions
(the reference jits them; Fig 9, ``repro_torch.figures.fig9_qsim``, runs
them under ``torch.compile``), and the planar kernel version (B12's gate
kernel for the single-qubit gates on the card; its plain version on the
CPU).  Each is held against the complex-vector version by fidelity.  On
the card each is timed once between CUDA events (``perf.measure``); on
the CPU nothing is timed.  ``--distributed`` (the state vector sharded
over devices) raises ``NotImplementedError``: the device mesh is ROADMAP
A10.
"""
import argparse

import torch

from repro_torch.figures.fig9_qsim import fidelity
from repro_torch.kernels.common import resolve_device
from repro_torch.perf.measure import measure
from repro_torch.quantum import gates, qsim

FIDELITY_TOL = 1e-5


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--qubits", type=int, default=14)
    ap.add_argument("--depth", type=int, default=6)
    ap.add_argument("--device", default=None)
    ap.add_argument("--distributed", action="store_true",
                    help="shard the state vector over devices (not "
                         "ported: ROADMAP A10)")
    args = ap.parse_args(argv)
    if args.distributed:
        raise NotImplementedError(
            "the distributed state vector is not ported yet (ROADMAP A10: "
            "the device mesh)")
    dev = resolve_device(args.device)
    circuit = gates.random_circuit(args.qubits, args.depth, seed=7)
    print(f"{args.qubits} qubits, {len(circuit)} gates, on {dev}")

    want = qsim.run_autovec_complex(qsim.init_state(args.qubits, dev),
                                    circuit)
    want_planes = (want.real.contiguous(), want.imag.contiguous())
    re, im = qsim.init_planar(args.qubits, dev)
    ri = qsim.init_interleaved(args.qubits, dev)
    versions = {
        "autovec/interleaved": (
            lambda ri: qsim.run_autovec_interleaved(ri, circuit), (ri,)),
        "autovec/planar": (
            lambda re, im: qsim.run_autovec_planar(re, im, circuit),
            (re, im)),
        "kernel/planar": (
            lambda re, im: qsim.run_kernel_planar(re, im, circuit),
            (re, im)),
    }
    out = {}
    for name, (fn, fargs) in versions.items():
        if dev.type == "cuda":
            m = measure(fn, *fargs, reps=1, cover_ms=0.0)
            res, timed = m.result, f"{m.median_s * 1e3:9.3f} ms"
        else:
            res, timed = fn(*fargs), "not timed"
        planes = (res if isinstance(res, tuple)
                  else (res[..., 0].contiguous(), res[..., 1].contiguous()))
        fid = fidelity(planes, want_planes)
        if not fid >= 1 - FIDELITY_TOL:
            raise AssertionError(f"{name}: fidelity {fid:.8f} against the "
                                 f"complex-vector version")
        amp0 = float(torch.hypot(planes[0][0], planes[1][0]))
        out[name] = {"fidelity": fid, "amp0": amp0}
        print(f"{name:22s} {timed}  |amp0|={amp0:.4f}  fidelity "
              f"{fid:.9f}")
    return out


if __name__ == "__main__":
    main()
