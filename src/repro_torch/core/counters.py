"""Counter calibration programs: the paper's Table 1 method applied to
torch's counters.  The counterpart of ``repro.core.counters``.

Programs with counts known by construction run under each counter, and
each channel is judged reliable or not at the paper's 5% tolerance.  As
in the reference, consumers read counters through
``repro_torch.perf.channels`` (``calibrate()`` / ``channels_for()``),
which caches a calibration and hands out the analytic value
(``source="model"``) where a channel calibrated unreliable.

Torch's counters, and the channels they feed:

  flops_straightline   ``torch.utils.flop_counter.FlopCounterMode`` on
                       elementwise programs (the reference's unrolled
                       add/mul chain and its fma)
  flops_scan           the same counter on the reference's loop-carried
                       add/mul; eager torch has no scan, so the loop is a
                       Python loop, dispatched op by op
  flops_matmul         the same counter on matmul programs: the
                       reference's 256^3 dot (a ``flops_straightline``
                       record there) and a loop of smaller dots
  bytes_copy           no torch counter: absent
  bytes_fused_chain    no torch counter: absent
  op_histogram         the dispatch histogram (``core.ophist``) against
                       the known op count
  transcendental       no torch counter: absent
  kernel_launches      on the card only: the kernel records of
                       ``torch.profiler``'s CUDA activity against the
                       kernels an eager program launches (one an op)

A channel with no counter reads as absent (``measured`` ``None``): it is
judged unreliable and stays in the table.

The verdicts differ from the reference's, and that is the finding: XLA's
flops counter is blind to trip counts (a ``while`` body counts once),
torch's is blind to elementwise work (``FlopCounterMode`` has formulas
for matmuls, convolutions and attention only) and sees every iteration
of a loop.  ``perf.channels`` picks the verdict a flops read is judged
by from that structure: matmul-bearing or elementwise-only.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional

import torch
from torch.utils.flop_counter import FlopCounterMode

from repro_torch.core import ophist
from repro_torch.kernels.common import resolve_device

TOLERANCE = 0.05                  # the paper's


@dataclasses.dataclass
class CounterRecord:
    channel: str
    program: str
    reference: float
    measured: Optional[float]     # None: the channel has no counter here

    @property
    def error(self) -> Optional[float]:
        if self.measured is None:
            return None
        if self.reference == 0:
            return abs(self.measured)
        return abs(self.measured - self.reference) / self.reference

    @property
    def reliable(self) -> bool:
        return self.error is not None and self.error <= TOLERANCE

    def row(self) -> Dict:
        return {
            "channel": self.channel, "program": self.program,
            "reference": self.reference, "measured": self.measured,
            "error": self.error, "reliable": self.reliable,
        }


@dataclasses.dataclass
class Reading:
    """What torch's counters read over one run of a program."""
    flops: float
    ops: Dict[str, int]
    kernels: Optional[Dict[str, int]] = None     # on the card only


def read(fn, *args, kernels: bool = False) -> Reading:
    """Run ``fn(*args)`` once under ``FlopCounterMode`` and the dispatch
    histogram, and (``kernels``, on the card) once more under the
    profiler alone."""
    counter = ophist.OpCounter()
    with FlopCounterMode(display=False) as flops, counter:
        fn(*args)
    hist = None
    if kernels:
        with ophist.KernelRecorder() as rec:
            fn(*args)
        hist = rec.hist
    return Reading(flops.get_total_flops(), dict(counter.counts), hist)


def calibrate(n: int = 1 << 16, steps: int = 8, *,
              device=None) -> List[CounterRecord]:
    """The calibration records on ``device`` (``cuda`` unless named); on
    a CUDA device they include the ``kernel_launches`` channel."""
    dev = resolve_device(device)
    on_card = dev.type == "cuda"
    x = torch.ones((n,), dtype=torch.float32, device=dev)
    y = torch.ones((n,), dtype=torch.float32, device=dev)
    recs: List[CounterRecord] = []

    # -- flops, straight-line: unrolled fold-proof add/mul pairs ----------
    def unrolled_add(x, y):
        for _ in range(steps):
            x = x + y
            y = y * 1.0001
        return x, y

    chain = read(unrolled_add, x, y, kernels=on_card)
    recs.append(CounterRecord("flops_straightline",
                              f"{steps}x (add+mul), fold-proof",
                              2 * steps * n, chain.flops))

    # -- flops, loop-carried: the same math; eager torch has no scan, so
    # the loop runs in Python and every iteration is dispatched ----------
    def looped_add(x, y):
        carry = (x, y)
        for _ in range(steps):
            xc, yc = carry
            carry = (xc + yc, yc * 1.0001)
        return carry

    c = read(looped_add, x, y)
    recs.append(CounterRecord("flops_scan", f"loop({steps})x (add+mul)",
                              2 * steps * n, c.flops))

    # -- flops: fma chain (2 flops/elem) ----------------------------------
    c = read(lambda x, y: x * y + x, x, y)
    recs.append(CounterRecord("flops_straightline", "fma", 2 * n, c.flops))

    # -- flops: dot (2MNK), and a loop of dots ----------------------------
    a = torch.ones((256, 256), dtype=torch.float32, device=dev)
    c = read(lambda a: a @ a, a)
    recs.append(CounterRecord("flops_matmul", "dot 256^3", 2 * 256 ** 3,
                              c.flops))
    b = torch.ones((64, 64), dtype=torch.float32, device=dev)

    def looped_dot(b):
        for _ in range(steps):
            b = b @ b * (1.0 / 64)
        return b

    c = read(looped_dot, b)
    recs.append(CounterRecord("flops_matmul", f"loop({steps})x dot 64^3",
                              steps * 2 * 64 ** 3, c.flops))

    # -- bytes: torch has no counter --------------------------------------
    recs.append(CounterRecord("bytes_copy", "copy", 2 * 4 * n, None))
    recs.append(CounterRecord("bytes_fused_chain",
                              f"{steps}x mul-add chain", 2 * 4 * n, None))

    # -- op histogram vs known op count ------------------------------------
    recs.append(CounterRecord("op_histogram", f"{steps}x add", steps,
                              chain.ops.get("add", 0)))

    # -- transcendentals: torch has no counter -----------------------------
    recs.append(CounterRecord("transcendental", "exp", n, None))

    # -- the card's kernel records: one kernel an eager op ----------------
    if on_card:
        recs.append(CounterRecord("kernel_launches",
                                  f"{steps}x (add+mul), eager", 2 * steps,
                                  sum(chain.kernels.values())))
    return recs


def summarize(recs: List[CounterRecord]) -> Dict[str, bool]:
    """channel -> reliable (all programs within tolerance)."""
    out: Dict[str, bool] = {}
    for r in recs:
        out[r.channel] = out.get(r.channel, True) and r.reliable
    return out
