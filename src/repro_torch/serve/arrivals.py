"""Seeded arrival processes for the open-loop serving front end.

Closed-loop benchmarks (submit everything, drain) measure *throughput*;
they cannot say anything about latency under load because every request
is already waiting at t=0.  The generators here put requests on a clock:
each one emits a list of :class:`ArrivalRequest` records — effectively
``(arrival_time, prompt, max_new_tokens, extra)`` tuples — that
``serve.frontend.OpenLoopFrontend`` enqueues at their arrival times
while the engine steps between arrivals.

Four processes, all deterministic under a seed:

  * :func:`poisson_arrivals` — exponential inter-arrival gaps at a mean
    ``rate`` requests/s (the memoryless baseline of every serving
    paper's load sweep);
  * :func:`gamma_arrivals` — gamma-distributed gaps with a coefficient
    of variation knob: ``cv > 1`` is *burstier* than Poisson (clumped
    arrivals that stress admission + queueing), ``cv < 1`` is smoother;
  * :func:`trace_arrivals` — fixed-trace replay from a JSON workload
    (explicit ``arrival_s`` per request; prompts either literal token
    lists or seeded ``prompt_len`` synthesis), for reproducing a
    recorded or hand-built workload exactly;
  * :func:`closed_loop_arrivals` — every request at t=0: the
    compatibility generator under which the frontend's step loop is
    equivalent to ``submit()``\\*N + ``engine.run()`` (temp-0 token
    parity is pinned by tests/test_serve_frontend.py).

No timing calls live here: arrival times are *virtual-clock* values the
frontend interprets; wall-clock stays confined to ``perf/measure.py``.
"""
from __future__ import annotations

import dataclasses
import json
import pathlib
from typing import Any, Dict, List, Optional, Sequence, Tuple, Union

import numpy as np

TRACE_SCHEMA = "repro.serve.trace"

#: a (prompt_tokens, max_new_tokens) workload item, the shape shared
#: with benchmarks/serve_bench's mixes
WorkloadItem = Tuple[np.ndarray, int]


@dataclasses.dataclass
class ArrivalRequest:
    """One timed request: arrives at ``arrival_s`` on the frontend's
    virtual clock (seconds from the start of the run)."""
    arrival_s: float
    prompt: np.ndarray
    max_new_tokens: int
    temperature: float = 0.0
    extra: Optional[Dict[str, Any]] = None

    def astuple(self) -> Tuple[float, np.ndarray, int,
                               Optional[Dict[str, Any]]]:
        return (self.arrival_s, self.prompt, self.max_new_tokens,
                self.extra)


def synthetic_requests(n: int, prompt_band: Tuple[int, int],
                       gen_band: Tuple[int, int], vocab_size: int, *,
                       seed: int = 0,
                       shared_prefix: int = 0) -> List[WorkloadItem]:
    """Seeded ``(prompt, max_new_tokens)`` workload items with prompt /
    generation lengths drawn uniformly from half-open bands (the same
    convention as serve_bench's mixes).  ``shared_prefix > 0`` prepends
    one common seeded prefix of that many tokens to every prompt — the
    enqueue-time prefix-matching workload."""
    rng = np.random.default_rng(seed)
    prefix = (rng.integers(1, vocab_size, size=shared_prefix)
              if shared_prefix else None)
    items: List[WorkloadItem] = []
    for _ in range(n):
        plen = int(rng.integers(*prompt_band))
        glen = int(rng.integers(*gen_band))
        tail = rng.integers(1, vocab_size, size=plen)
        prompt = tail if prefix is None else np.concatenate([prefix, tail])
        items.append((prompt.astype(np.int32), glen))
    return items


def _timed(reqs: Sequence[WorkloadItem], gaps: np.ndarray, *,
           start_s: float, temperature: float,
           extra: Optional[Dict[str, Any]]) -> List[ArrivalRequest]:
    times = start_s + np.cumsum(gaps)
    return [ArrivalRequest(arrival_s=float(t), prompt=np.asarray(p),
                           max_new_tokens=int(g), temperature=temperature,
                           extra=extra)
            for t, (p, g) in zip(times, reqs)]


def poisson_arrivals(reqs: Sequence[WorkloadItem], rate: float, *,
                     seed: int = 0, start_s: float = 0.0,
                     temperature: float = 0.0,
                     extra: Optional[Dict[str, Any]] = None
                     ) -> List[ArrivalRequest]:
    """Poisson process at ``rate`` requests/s: i.i.d. exponential
    inter-arrival gaps (the first request arrives one gap after
    ``start_s``, so rate accuracy holds from the very first sample)."""
    if rate <= 0:
        raise ValueError(f"rate must be positive, got {rate}")
    rng = np.random.default_rng(seed)
    gaps = rng.exponential(1.0 / rate, size=len(reqs))
    return _timed(reqs, gaps, start_s=start_s, temperature=temperature,
                  extra=extra)


def gamma_arrivals(reqs: Sequence[WorkloadItem], rate: float, *,
                   cv: float = 2.0, seed: int = 0, start_s: float = 0.0,
                   temperature: float = 0.0,
                   extra: Optional[Dict[str, Any]] = None
                   ) -> List[ArrivalRequest]:
    """Gamma-renewal process at mean ``rate`` requests/s with
    inter-arrival coefficient of variation ``cv``: shape ``1/cv**2``,
    scale ``cv**2/rate``.  ``cv=1`` degenerates to Poisson; ``cv>1``
    produces the bursty clumps that separate a latency-robust scheduler
    from one tuned on smooth load."""
    if rate <= 0:
        raise ValueError(f"rate must be positive, got {rate}")
    if cv <= 0:
        raise ValueError(f"cv must be positive, got {cv}")
    rng = np.random.default_rng(seed)
    shape = 1.0 / (cv * cv)
    gaps = rng.gamma(shape, (cv * cv) / rate, size=len(reqs))
    return _timed(reqs, gaps, start_s=start_s, temperature=temperature,
                  extra=extra)


def closed_loop_arrivals(reqs: Sequence[WorkloadItem], *,
                         temperature: float = 0.0,
                         extra: Optional[Dict[str, Any]] = None
                         ) -> List[ArrivalRequest]:
    """Every request at t=0 — the closed-loop compatibility generator.
    Through the frontend this submits the whole workload before the
    first step, which is exactly ``engine.submit()``\\*N + ``run()``."""
    return [ArrivalRequest(arrival_s=0.0, prompt=np.asarray(p),
                           max_new_tokens=int(g), temperature=temperature,
                           extra=extra)
            for p, g in reqs]


# ---------------------------------------------------------------------------
# fixed-trace replay
# ---------------------------------------------------------------------------
def trace_arrivals(trace: Union[str, pathlib.Path, Dict[str, Any]], *,
                   vocab_size: Optional[int] = None, seed: int = 0,
                   extra: Optional[Dict[str, Any]] = None
                   ) -> List[ArrivalRequest]:
    """Replay a JSON workload trace (a path or an already-loaded
    mapping)::

        {"schema": "repro.serve.trace",
         "requests": [
            {"arrival_s": 0.00, "prompt": [3, 5, 7], "max_new_tokens": 8},
            {"arrival_s": 0.12, "prompt_len": 16,   "max_new_tokens": 4,
             "temperature": 0.7}]}

    Entries carry either a literal ``prompt`` token list or a
    ``prompt_len`` whose tokens are synthesized from ``seed`` (requires
    ``vocab_size``); both forms are deterministic, so replaying the same
    trace always produces the same workload."""
    if isinstance(trace, (str, pathlib.Path)):
        payload = json.loads(pathlib.Path(trace).read_text())
    else:
        payload = trace
    if not isinstance(payload, dict) or "requests" not in payload:
        raise ValueError(
            "trace must be a mapping with a 'requests' list "
            f"(schema {TRACE_SCHEMA!r})")
    schema = payload.get("schema", TRACE_SCHEMA)
    if schema != TRACE_SCHEMA:
        raise ValueError(
            f"trace schema is {schema!r}, expected {TRACE_SCHEMA!r}")
    rng = np.random.default_rng(seed)
    out: List[ArrivalRequest] = []
    for i, entry in enumerate(payload["requests"]):
        if "prompt" in entry:
            prompt = np.asarray(entry["prompt"], np.int32)
        elif "prompt_len" in entry:
            if vocab_size is None:
                raise ValueError(
                    f"trace entry {i} uses prompt_len synthesis; pass "
                    "vocab_size to trace_arrivals")
            prompt = rng.integers(1, vocab_size, size=int(entry["prompt_len"])
                                  ).astype(np.int32)
        else:
            raise ValueError(
                f"trace entry {i} needs 'prompt' or 'prompt_len'")
        out.append(ArrivalRequest(
            arrival_s=float(entry.get("arrival_s", 0.0)),
            prompt=prompt,
            max_new_tokens=int(entry["max_new_tokens"]),
            temperature=float(entry.get("temperature", 0.0)),
            extra=extra))
    out.sort(key=lambda a: a.arrival_s)
    return out


def trace_payload(arrivals: Sequence[ArrivalRequest]) -> Dict[str, Any]:
    """Serialize arrivals to the trace mapping (round-trips through
    :func:`trace_arrivals`; per-request ``extra`` context is not
    serialized — replay passes it explicitly)."""
    return {
        "schema": TRACE_SCHEMA,
        "requests": [
            {"arrival_s": a.arrival_s,
             "prompt": np.asarray(a.prompt).tolist(),
             "max_new_tokens": a.max_new_tokens,
             **({"temperature": a.temperature} if a.temperature else {})}
            for a in arrivals],
    }


def save_trace(path: Union[str, pathlib.Path],
               arrivals: Sequence[ArrivalRequest]) -> None:
    """Write arrivals as a replayable JSON trace file."""
    pathlib.Path(path).write_text(
        json.dumps(trace_payload(arrivals), indent=2))
