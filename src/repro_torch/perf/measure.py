"""Timing on the card: the counterpart of ``repro.perf.measure``.

``measure(fn, *args)`` warms up, then times ``fn`` and any rivals in
interleaved rounds (A, B, C, A, B, C, ...) so that a burst of noise hits
every contender alike, and keeps the median.  Each timed call sits
between two CUDA events on the current stream, and the reported time is
``start.elapsed_time(end)``: device time, never the host's clock (there
is no host timing in this package).  Two options shape what the events
see:

- ``flush_l2`` zeroes a 256 MiB buffer (five times the H100's 50 MB L2)
  before every timed call, for callers whose data would arrive cold.
- ``cover_ms`` spins the card for that long before the start event
  (``torch.cuda._sleep``), so the host has enqueued the whole call by the
  time the card reaches it and the events see device time, not launch
  overhead.  A call whose enqueue outlasts the cover (an eager loop of
  thousands of launches) is timed as the card receives it: host-paced.

Without a card, or given a tensor that is not on a CUDA device, it
raises: there is nothing to fall back to.

``wall_clock(fn, *args)`` is the open-loop front end's step clock
(``serve.frontend``, ``clock="wall"``): it drains the card, records a
start event, runs ``fn``, records an end event and waits for it, and
returns ``fn``'s result with the seconds between the two events.  With
the stream drained when the start event is recorded, the event's
timestamp is the host's instant, so the span holds everything the call
does: the host's planning before its first launch, the launches, the
device work and the host's commit after the last one.
"""
from __future__ import annotations

import dataclasses
import statistics
from typing import Any, Callable, Dict, List, Mapping, Optional, Tuple, Union

import torch

FLUSH_BYTES = 256 * 2 ** 20
CYCLES_PER_MS = 2e6          # spin-kernel cycles per ms at ~2 GHz SM clock


@dataclasses.dataclass
class Measurement:
    """Device times of one contender; the median is the trusted statistic."""

    median_s: float
    all_s: List[float]
    reps: int
    first_s: float = 0.0             # the first warm-up call (build, compile)
    result: Any = None               # the last repeat's output
    interleaved: Dict[str, "Measurement"] = dataclasses.field(
        default_factory=dict)

    def gops(self, n_ops: float) -> float:
        """Rate of ``n_ops`` operations, in billions per second."""
        return n_ops / self.median_s / 1e9 if self.median_s > 0 else 0.0


# a contender: (fn, args)
_Candidate = Tuple[Callable, tuple]
Cover = Union[float, Mapping[str, float]]


def _normalize(spec) -> _Candidate:
    if callable(spec):
        return spec, ()
    return spec[0], tuple(spec[1])


def _tensors(obj):
    if isinstance(obj, torch.Tensor):
        yield obj
    elif isinstance(obj, (tuple, list)):
        for o in obj:
            yield from _tensors(o)
    elif isinstance(obj, dict):
        for o in obj.values():
            yield from _tensors(o)


def _require_card(contenders: Dict[str, _Candidate]) -> None:
    if not torch.cuda.is_available():
        raise RuntimeError("measure times on a CUDA card with CUDA events; "
                           "no CUDA device is present")
    for name, (_, args) in contenders.items():
        for t in _tensors(args):
            if t.device.type != "cuda":
                raise ValueError(f"measure: contender {name!r} was given a "
                                 f"tensor on {t.device}; it times the card")


def _timed(fn, args, flush, cover_ms) -> Tuple[float, Any]:
    if flush is not None:
        flush.zero_()
    if cover_ms > 0:
        torch.cuda._sleep(int(cover_ms * CYCLES_PER_MS))
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    out = fn(*args)
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / 1e3, out


def _run(contenders: Dict[str, _Candidate], reps: int, flush_l2: bool,
         cover_ms: Cover) -> Dict[str, Measurement]:
    _require_card(contenders)

    def cover(name):
        if isinstance(cover_ms, Mapping):
            return float(cover_ms[name])
        return float(cover_ms)

    # one untimed warm-up call each (build, compile, first touch)
    first = {name: _timed(fn, args, None, 0.0)[0]
             for name, (fn, args) in contenders.items()}
    flush = (torch.empty(FLUSH_BYTES, dtype=torch.uint8, device="cuda")
             if flush_l2 else None)
    times: Dict[str, List[float]] = {name: [] for name in contenders}
    results: Dict[str, Any] = {}
    for _ in range(max(1, reps)):
        for name, (fn, args) in contenders.items():
            s, results[name] = _timed(fn, args, flush, cover(name))
            times[name].append(s)
    return {name: Measurement(median_s=float(statistics.median(w)),
                              all_s=w, reps=len(w), first_s=first[name],
                              result=results[name])
            for name, w in times.items()}


def wall_clock(fn: Callable, *args) -> Tuple[Any, float]:
    """``(fn(*args), seconds)``: the whole call between two CUDA events,
    the first recorded on a drained card (see the module docstring).
    Raises without a card."""
    if not torch.cuda.is_available():
        raise RuntimeError("wall_clock times on a CUDA card with CUDA "
                           "events; no CUDA device is present")
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    out = fn(*args)
    end.record()
    end.synchronize()
    return out, start.elapsed_time(end) / 1e3


def measure(fn: Callable, *args, reps: int = 5,
            interleave_with: Optional[Dict[str, Any]] = None,
            flush_l2: bool = False, cover_ms: Cover = 1.0) -> Measurement:
    """Time ``fn(*args)`` on the card, and optionally rivals, interleaved.

    Args:
      fn, *args: the primary contender (``args`` on a CUDA device).  One
        untimed warm-up call first (build, compile, first touch); its
        event time is kept as ``first_s``.
      reps: timed repeats; the reported statistic is the median.
      interleave_with: ``{name: (fn, args)}`` or ``{name: thunk}`` rivals
        timed in the same rounds; their measurements land in
        ``Measurement.interleaved[name]``.
      flush_l2, cover_ms: see the module docstring.  ``cover_ms`` may map
        each contender's name (the primary is ``"__self__"``) to its own.
    """
    contenders: Dict[str, _Candidate] = {"__self__": (fn, tuple(args))}
    for name, spec in (interleave_with or {}).items():
        contenders[name] = _normalize(spec)
    out = _run(contenders, reps, flush_l2, cover_ms)
    m = out.pop("__self__")
    m.interleaved = out
    return m


def measure_group(candidates: Dict[str, Any], *, reps: int = 5,
                  flush_l2: bool = False, cover_ms: Cover = 1.0
                  ) -> Dict[str, Measurement]:
    """Time every candidate in the same interleaved rounds:
    ``{name: (fn, args)}`` (or ``{name: thunk}``) in, ``{name:
    Measurement}`` out.  ``cover_ms`` may map each name to its own."""
    if not candidates:
        return {}
    return _run({n: _normalize(s) for n, s in candidates.items()}, reps,
                flush_l2, cover_ms)
