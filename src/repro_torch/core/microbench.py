"""C1, the microbenchmark suite: performance ceilings per op class, on the
card.  The counterpart of ``repro.core.microbench``.

The paper issues controlled RVV instruction sequences and measures Gops/s.
Each row here has two columns:

  * ``bound_gops`` — the card's ceiling for that op stream, from the
    port's ``HWSpec`` (``hw`` names the spec): the lesser of the memory
    rate over the bytes per element and the arithmetic rate.  It takes the
    place of the JAX row's ``model_tpu_gops``; no TPU number stands here.
  * ``host_gops`` — the rate measured on the card (the JAX name is kept;
    as in ``core.veceval`` the time is CUDA-event time, through
    ``repro_torch.perf.measure``).

Arithmetic rows: add/mul/fma/div x {f32, bf16, i32, i8}, each an eager
torch expression.  Memory rows: unit-stride copy and triad, and, for
strides 2, 4 and 8, the Fig 2 idioms through the port's strided kernels
(``vlse`` = ``strided_rowwise``, ``vle+mask`` = ``overfetch_select``).
The JAX rows' ``flops_per_elem`` and ``bytes_per_elem`` are kept as they
are, so the rows of the two packages compare like with like.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional

import numpy as np
import torch

from repro_torch.core.costmodel import HWSpec, hw_of
from repro_torch.kernels.common import resolve_device
from repro_torch.kernels.strided import ops as strided_ops
from repro_torch.perf.measure import measure as _measure


@dataclasses.dataclass
class BenchRecord:
    name: str
    dtype: str
    flops_per_elem: float
    bytes_per_elem: float
    bound_gops: float
    hw: str
    host_gops: Optional[float] = None
    note: str = ""

    def row(self) -> Dict:
        return dataclasses.asdict(self)


def _ceiling(flops_per_elem: float, bytes_per_elem: float,
             hw: HWSpec) -> float:
    """Operations (elements, for a row with no arithmetic) per second the
    card can sustain, in billions: the lesser of its elementwise peak and
    the memory rate times the operations per byte.  Every dtype takes the
    CUDA-core fp32 rate, the only elementwise rate NVIDIA publishes; these
    streams are bound by memory with a wide margin either way."""
    ops = max(flops_per_elem, 1.0)
    return min(hw.peak_flops_fp32, hw.hbm_bw / bytes_per_elem * ops) / 1e9


_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16,
           "int32": torch.int32, "int8": torch.int8}

_ARITH = {
    "add": (lambda x, y: x + y, 1),
    "mul": (lambda x, y: x * y, 1),
    "fma": (lambda x, y: x * y + x, 2),
    "div": (lambda x, y: x / torch.clamp_min(y, 1), 10),  # divider proxy
}


def arithmetic_suite(n: int = 1 << 20, measure: bool = True, *, device=None,
                     hw: Optional[HWSpec] = None) -> List[BenchRecord]:
    dev = resolve_device(device)
    hw = hw_of(dev, hw)
    recs = []
    for dname, dt in _DTYPES.items():
        if dt == torch.int8:
            x = torch.ones((n,), dtype=dt, device=dev)
            y = torch.ones((n,), dtype=dt, device=dev)
        else:
            x = torch.from_numpy(np.random.default_rng(0).random(n)).to(
                dev, dt)
            y = torch.from_numpy(np.random.default_rng(1).random(n) + 1).to(
                dev, dt)
        for opname, (fn, flops) in _ARITH.items():
            if dt in (torch.int8, torch.int32) and opname == "div":
                continue
            bytes_pe = 3 * x.element_size()
            rec = BenchRecord(
                name=f"v{opname}", dtype=dname, flops_per_elem=flops,
                bytes_per_elem=bytes_pe,
                bound_gops=_ceiling(flops, bytes_pe, hw), hw=hw.name)
            if measure:
                rec.host_gops = _measure(fn, x, y, reps=5).gops(n * flops)
            recs.append(rec)
    return recs


def memory_suite(rows: int = 1 << 13, measure: bool = True, *, device=None,
                 hw: Optional[HWSpec] = None) -> List[BenchRecord]:
    """Unit-stride / strided / masked access patterns (Fig 2/3 inputs)."""
    dev = resolve_device(device)
    hw = hw_of(dev, hw)
    recs = []
    lane = 128
    x = torch.from_numpy(np.random.default_rng(2).random((rows, lane)).astype(
        np.float32)).to(dev)
    y = torch.from_numpy(np.random.default_rng(3).random((rows, lane)).astype(
        np.float32)).to(dev)
    n = rows * lane

    def add_rec(name, fn, args, out_elems, bytes_pe, note=""):
        rec = BenchRecord(name=name, dtype="float32", flops_per_elem=0,
                          bytes_per_elem=bytes_pe,
                          bound_gops=_ceiling(0, bytes_pe, hw), hw=hw.name,
                          note=note)
        if measure:
            rec.host_gops = _measure(fn, *args, reps=5).gops(out_elems)
        recs.append(rec)

    add_rec("vle (unit-stride copy)", lambda x: x + 0, (x,), n, 8)
    add_rec("triad", lambda x, y: x + 2.0 * y, (x, y), n, 12)
    for s in (2, 4, 8):
        add_rec(f"vlse stride={s}",
                lambda x, s=s: strided_ops.strided_gather(
                    x, s, "strided_rowwise"),
                (x,), n // s, 8 * s,
                note="strided rows (strided_rowwise kernel); the ceiling "
                     "counts s-x the useful bytes, as the JAX row does")
        add_rec(f"vle+mask stride={s}",
                lambda x, s=s: strided_ops.strided_gather(
                    x, s, "overfetch_select"),
                (x,), n // s, 8 * s,
                note="overfetch-and-select idiom (overfetch_select kernel)")
    return recs


def run_suite(measure: bool = True, *, device=None,
              hw: Optional[HWSpec] = None) -> List[Dict]:
    return [r.row() for r in
            arithmetic_suite(measure=measure, device=device, hw=hw)
            + memory_suite(measure=measure, device=device, hw=hw)]
