"""Fig 9, the Qsim product-level study, on the card: the counterpart of
``benchmarks/fig9_qsim.py`` and ``examples/qsim_demo.py``.

    python -m repro_torch.figures.fig9_qsim [--qubits 16] [--depth 6]

Versions (one row each), on one random circuit (``random_circuit(n,
depth, seed=42)``, the JAX figure's):
  nonvec/planar        the pair loop of ``qsim.run_nonvec_planar``, run on
                       the first ``NONVEC_MAX_PAIRS`` pairs only (veceval's
                       cap on host loops) and scaled to the whole circuit.
                       Every scalar op is a launch: host-paced.
  autovec/interleaved  ``qsim.interleaved_step`` under ``torch.compile``
  autovec/planar       ``planar_step`` under ``torch.compile``
                       (eager on the CPU, where only the tests run them)
  kernel/planar        ``qsim.run_kernel_planar``: the CUDA gate kernel for
                       the single-qubit gates, the plain planar function
                       for the CZ ladder

With ``measure`` (needs the card) the versions are timed in the same
interleaved rounds by ``repro_torch.perf.measure`` (CUDA events; the
JAX key ``host_seconds`` holds that device time, as in
``core.veceval``).  Each row has the time, ``bound_seconds`` (16 bytes
per amplitude per gate, read and written once, over the memory rate of
the port's ``HWSpec``, ``hw`` naming it), the speedup over nonvec, the
first (compiling) call's seconds and how many times the version ran.
Every run holds the versions against each other: fidelity
|<kernel|autovec>|^2 >= 1 - 1e-5 and a norm within 1e-4 of 1 (an
absolute tolerance means nothing at 28 qubits, where amplitudes are
~6e-5); the nonvec prefix against the plain gate on the pairs it did.
"""
from __future__ import annotations

import argparse
from typing import Dict, List, Optional

import torch

from repro_torch.core.costmodel import HWSpec, hw_of
from repro_torch.kernels.common import resolve_device
from repro_torch.kernels.qsim_gate.ref import planar_step
from repro_torch.perf.measure import measure_group
from repro_torch.quantum import gates, qsim

REPS = 5                      # timed rounds
SEED = 42                     # the JAX figure's circuit
NONVEC_MAX_PAIRS = 4096       # veceval's SCALAR_MAX_ITERS
FIDELITY_TOL = 1e-5
NORM_TOL = 1e-4
RECOMPILE_LIMIT = 64          # graphs a compiled step may keep (a few used)
VERSIONS = ("nonvec/planar", "autovec/interleaved", "autovec/planar",
            "kernel/planar")


def _dot64(a: torch.Tensor, b: torch.Tensor, chunk: int = 1 << 24) -> float:
    """sum(a * b) in float64, a chunk at a time (2^28 terms at 28 qubits)."""
    return float(sum((a[i:i + chunk].double() * b[i:i + chunk].double())
                     .sum() for i in range(0, a.shape[0], chunk)))


def fidelity(x, y) -> float:
    """|<x|y>|^2 of two planar states (re, im)."""
    real = _dot64(x[0], y[0]) + _dot64(x[1], y[1])
    imag = _dot64(x[0], y[1]) - _dot64(x[1], y[0])
    return real * real + imag * imag


def norm(x) -> float:
    return (_dot64(x[0], x[0]) + _dot64(x[1], x[1])) ** 0.5


def _planes(out) -> tuple:
    return out if isinstance(out, tuple) else (out[:, 0], out[:, 1])


def _recompile_limit(limit: int):
    import torch._dynamo.config as cfg
    name = ("recompile_limit" if hasattr(cfg, "recompile_limit")
            else "cache_size_limit")
    return cfg.patch(**{name: limit})


def check_nonvec_prefix(got, re0, im0, circuit, pairs: int) -> float:
    """The nonvec run stopped after ``pairs`` pairs of the first gate
    (``pairs`` <= 2^(n-1)): those pairs hold the plain gate's values, the
    rest of the state is the input.  Returns the max abs error."""
    g = circuit[0]
    want = qsim.apply_gate_planar_torch(re0, im0, g.matrix, g.qubit,
                                        g.control)
    k = torch.arange(pairs, device=re0.device)
    s = 1 << g.qubit
    i0 = (k // s) * 2 * s + k % s
    idx = torch.cat([i0, i0 + s])
    err = 0.0
    for plane, w, x0 in zip(got, want, (re0, im0)):
        exp = x0.clone()
        exp[idx] = w[idx]
        err = max(err, float((plane - exp).abs().max()))
    return err


def run(device=None, n_qubits: int = 16, depth: int = 6, *,
        measure: bool = True, hw: Optional[HWSpec] = None) -> List[Dict]:
    dev = resolve_device(device)
    hw = hw_of(dev, hw)
    circuit = gates.random_circuit(n_qubits, depth, seed=SEED)
    n = 2 ** n_qubits
    re0, im0 = qsim.init_planar(n_qubits, dev)
    ri0 = qsim.init_interleaved(n_qubits, dev)
    coeffs = qsim.circuit_coeffs(circuit, dev)
    on_card = dev.type == "cuda"
    step_p = qsim.compiled_planar_step() if on_card else planar_step
    step_i = (qsim.compiled_interleaved_step() if on_card
              else qsim.interleaved_step)
    total_pairs = n // 2 * len(circuit)
    pairs = min(NONVEC_MAX_PAIRS, n // 2)      # a prefix of the first gate
    fns = {
        "nonvec/planar": (lambda: qsim.run_nonvec_planar(
            re0, im0, circuit, max_pairs=pairs)),
        "autovec/interleaved": (lambda: qsim.run_stepped(
            step_i, ri0, circuit, coeffs)),
        "autovec/planar": (lambda: qsim.run_stepped(
            step_p, (re0, im0), circuit, coeffs)),
        "kernel/planar": (lambda: qsim.run_kernel_planar(re0, im0, circuit)),
    }
    with _recompile_limit(RECOMPILE_LIMIT):
        if measure:
            meas = measure_group(fns, reps=REPS, flush_l2=True, cover_ms=2.0)
            outs = {v: m.result for v, m in meas.items()}
            calls = REPS + 1
        else:
            meas, calls = {}, 1
            outs = {v: fn() for v, fn in fns.items()}
    # the versions against each other
    kern = outs["kernel/planar"]
    fid = {v: fidelity(kern, _planes(outs[v]))
           for v in ("autovec/interleaved", "autovec/planar")}
    norms = {v: norm(_planes(outs[v])) for v in VERSIONS[1:]}
    nonvec_err = check_nonvec_prefix(outs["nonvec/planar"], re0, im0,
                                     circuit, pairs)
    bad = [f"{v}: fidelity vs kernel {f:.8f}" for v, f in fid.items()
           if not f >= 1 - FIDELITY_TOL]
    bad += [f"{v}: norm {x:.8f}" for v, x in norms.items()
            if not abs(x - 1) <= NORM_TOL]
    if not nonvec_err <= 1e-6:
        bad.append(f"nonvec prefix: max abs err {nonvec_err:.3e}")
    if bad:
        raise AssertionError(f"Qsim {n_qubits}q depth {depth}: "
                             + "; ".join(bad))
    bound_s, bound_by = hw.bound_s(14.0 * n * len(circuit),
                                   16.0 * n * len(circuit), torch.float32)
    secs = {v: m.median_s for v, m in meas.items()}
    if secs:                          # nonvec timed on a prefix, scaled
        secs["nonvec/planar"] *= total_pairs / pairs
    device_name = torch.cuda.get_device_name(dev) if on_card else "cpu"
    rows = []
    for v in VERSIONS:
        t = secs.get(v)
        rows.append({
            "version": v, "n_qubits": n_qubits, "depth": depth,
            "gates": len(circuit),
            "uncontrolled_gates": sum(g.control is None for g in circuit),
            "host_seconds": t,
            "first_call_seconds": meas[v].first_s if meas else None,
            "bound_seconds": bound_s, "bound_by": bound_by, "hw": hw.name,
            "device": device_name, "calls": calls,
            "speedup_vs_nonvec": (secs["nonvec/planar"] / t if t else None),
            "fidelity_vs_kernel": fid.get(v, 1.0 if v == "kernel/planar"
                                          else None),
            "norm": norms.get(v),
            "note": (f"host-paced: {pairs} of {total_pairs} pairs timed, "
                     f"scaled" if v == "nonvec/planar" else ""),
        })
    return rows


def print_rows(rows: List[Dict]) -> None:
    r0 = rows[0]
    print(f"Fig 9: Qsim {r0['n_qubits']} qubits, depth {r0['depth']} "
          f"({r0['gates']} gates) on {r0['device']}; bound "
          f"{r0['bound_seconds'] * 1e3:.4f} ms ({r0['bound_by']}, "
          f"{r0['hw']})")
    for r in rows:
        t = r["host_seconds"]
        ms = "not measured" if t is None else f"{t * 1e3:.4f} ms"
        sp = ("" if r["speedup_vs_nonvec"] is None
              else f"  x{r['speedup_vs_nonvec']:.1f} over nonvec")
        print(f"  {r['version']:22s} {ms}{sp}  {r['note']}")


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--qubits", type=int, default=16)
    ap.add_argument("--depth", type=int, default=6)
    args = ap.parse_args(argv)
    print_rows(run(n_qubits=args.qubits, depth=args.depth))


if __name__ == "__main__":
    main()
