"""Counter channels with calibration-gated reads: the counterpart of
``repro.perf.channels``.

``channels_for(fn, *args)`` runs the function once under torch's
counters (``FlopCounterMode`` for flops, the dispatch histogram of
``core.ophist`` for ops) and stamps each scalar channel with the
verdict of a Table 1 calibration pass (``core.counters`` runs the
known-count programs; this module owns the verdicts and the gating).
The gate acts at read time, as the reference's: where a channel's
verdict is unreliable and the caller gave an analytic value
(``model_flops=`` / ``model_bytes=``), the returned
:class:`ChannelValue` carries that value with ``source="model"``.  ``ChannelValue``, ``Calibration`` and ``_gate`` are
the reference's, verbatim.

Which verdict applies to a flops read depends on the program, chosen by
what torch's counter is blind to (the calibration shows it: exact on
every matmul, loops included, and zero on elementwise work): a program
whose ops include a matmul-class op (``ophist.op_class``) is judged by
``flops_matmul``, an elementwise-only one by ``flops_straightline``.
Bytes and transcendentals have no torch counter; their reads are the
model's.  A function the dispatcher cannot see (``opaque=``: code
compiled by ``torch.compile``, which refuses to run under a dispatch
mode, or a hand kernel launched through ``ctypes``) has no counter read
at all: its flops are the model's and its op histogram is ``None``, with
the reason in ``histogram_note``.  The card's kernel records
(``core.ophist.KernelRecorder``) would see it, but calibrate whole only
over short blocks early in a process, so no count is taken from them.
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Any, Dict, List, Optional

import torch
from torch.utils.flop_counter import FlopCounterMode

from repro_torch.core import counters, ophist
from repro_torch.kernels.common import resolve_device


@dataclasses.dataclass(frozen=True)
class ChannelValue:
    """One gated channel read.

    ``source`` records where ``value`` came from: ``"counter"`` (the
    channel, trusted), ``"model"`` (analytic substitute for an unreliable
    counter), or ``"none"`` (no counter and no model — value is 0).
    ``reliable`` is the calibration verdict of the *counter* channel,
    regardless of the substitution.
    """

    name: str
    value: float
    source: str
    reliable: bool
    counter_value: Optional[float] = None   # the raw counter when gated out

    def row(self) -> Dict[str, Any]:
        return {self.name: self.value,
                f"{self.name}_source": self.source,
                f"{self.name}_reliable": self.reliable}


@dataclasses.dataclass
class Calibration:
    """Records + per-channel verdicts of one Table-1 calibration pass."""

    records: List[counters.CounterRecord]
    verdicts: Dict[str, bool]

    def rows(self) -> List[Dict]:
        return [r.row() for r in self.records]


def calibrate(n: int = 1 << 16, steps: int = 8, *,
              device=None) -> Calibration:
    """Run the known-count calibration programs on ``device`` (``cuda``
    unless named) and classify channels."""
    recs = counters.calibrate(n=n, steps=steps, device=device)
    return Calibration(records=recs, verdicts=counters.summarize(recs))


@functools.lru_cache(maxsize=None)
def _default_calibration(device: str) -> Calibration:
    return calibrate(n=1 << 12, steps=4, device=device)


def default_calibration(device=None) -> Calibration:
    """Process-wide cached calibration on reduced shapes, one a device
    (``cuda`` unless named: the card adds the ``kernel_launches``
    channel).

    The verdicts are shape-independent (they classify counter *mechanisms*,
    not magnitudes), so the small programs give the same reliable/
    unreliable split as the full Table-1 run at a fraction of the time.
    """
    return _default_calibration(str(resolve_device(device)))


def _gate(name: str, counter_value: Optional[float], reliable: bool,
          model_value: Optional[float]) -> ChannelValue:
    if reliable and counter_value is not None:
        return ChannelValue(name, float(counter_value), "counter", True)
    if model_value is not None:
        return ChannelValue(name, float(model_value), "model", reliable,
                            counter_value=counter_value)
    if counter_value is not None:
        # unreliable counter with no analytic substitute: hand it out, but
        # flagged — callers must not feed it to the roofline
        return ChannelValue(name, float(counter_value), "counter", False)
    return ChannelValue(name, 0.0, "none", False)


@dataclasses.dataclass
class Channels:
    """Every counter channel of one run of a function, verdict-stamped.

    ``op_histogram`` is ``None`` where no counter could see the function
    (``histogram_note`` says why); ``matmul_bearing`` is the structure
    the flops verdict was chosen by (``None``: not seen)."""

    flops: ChannelValue
    bytes_accessed: ChannelValue
    transcendentals: ChannelValue
    op_histogram: Optional[Dict[str, int]]
    instruction_classes: Optional[Dict[str, int]]
    histogram_source: Optional[str]        # "dispatch", or None: not seen
    histogram_note: Optional[str]
    matmul_bearing: Optional[bool]
    verdicts: Dict[str, bool]

    @property
    def total_ops(self) -> Optional[int]:
        if self.op_histogram is None:
            return None
        return sum(self.op_histogram.values())

    def row(self) -> Dict[str, Any]:
        out: Dict[str, Any] = {}
        for ch in (self.flops, self.bytes_accessed, self.transcendentals):
            out.update(ch.row())
        out["hlo_ops"] = self.total_ops
        out["instruction_classes"] = self.instruction_classes
        out["ops_source"] = self.histogram_source
        out["ops_note"] = self.histogram_note
        return out


def _on_card(args) -> bool:
    return any(isinstance(a, torch.Tensor) and a.device.type == "cuda"
               for a in args)


def channels_for(fn, *args,
                 model_flops: Optional[float] = None,
                 model_bytes: Optional[float] = None,
                 model_transcendentals: Optional[float] = None,
                 calibration: Optional[Calibration] = None,
                 opaque: Optional[str] = None) -> Channels:
    """Run ``fn(*args)`` once under the counters and read the
    verdict-gated channel bundle.

    ``opaque`` (the reason) marks a function the dispatcher cannot see:
    it is not run, and no counter is read.  The model values are the
    analytic substitutes used where the matching counter channel
    calibrated unreliable or could not run."""
    card = _on_card(args)
    cal = (calibration if calibration is not None
           else default_calibration("cuda" if card else "cpu"))
    counter = ophist.OpCounter()
    flop_counter = FlopCounterMode(display=False)
    if opaque is None:
        with flop_counter, counter:
            fn(*args)
    ops = None if opaque is not None else dict(counter.counts)
    flops_counter = (None if ops is None
                     else float(flop_counter.get_total_flops()))
    matmul_bearing = (None if ops is None else any(
        ophist.op_class(op) == "matmul" for op in ops))
    flops_verdict = cal.verdicts.get(
        "flops_matmul" if matmul_bearing else "flops_straightline", False)
    bytes_verdict = (cal.verdicts.get("bytes_copy", False)
                     and cal.verdicts.get("bytes_fused_chain", False))
    trans_verdict = cal.verdicts.get("transcendental", False)
    return Channels(
        flops=_gate("flops", flops_counter, flops_verdict, model_flops),
        bytes_accessed=_gate("bytes_accessed", None, bytes_verdict,
                             model_bytes),
        transcendentals=_gate("transcendentals", None, trans_verdict,
                              model_transcendentals),
        op_histogram=ops,
        instruction_classes=(None if ops is None
                             else ophist.instruction_classes(ops)),
        histogram_source=None if ops is None else "dispatch",
        histogram_note=opaque, matmul_bearing=matmul_bearing,
        verdicts=dict(cal.verdicts))
