"""SLO telemetry over open-loop serving event records.

``serve.frontend.OpenLoopFrontend`` produces one :class:`RequestEvents`
record per request (virtual-clock timestamps for arrival, enqueue,
first scheduling, every kept token, and finish); this module turns a
set of them into the latency surface the ROADMAP's open item asked
for:

  * **TTFT** — first kept token time minus *arrival* (queue wait
    included: an open-loop TTFT charges the scheduler for every second
    the request sat unadmitted);
  * **TBT** — gaps between consecutive kept tokens of one request (the
    stall metric chunked prefill exists to bound);
  * **E2E** — finish minus arrival;
  * **queue wait** — first-scheduled minus arrival;
  * **queue depth over time** — time-weighted mean / max of the
    frontend's per-iteration queue samples;
  * **goodput under an SLO** — completed tokens/s counting only
    requests that met both the TTFT and the max-TBT bound, the
    "fast for users" number a raw tok/s aggregate hides.

Tokens discarded by recompute-style preemption never appear in a
record's ``token_times_s`` (the frontend truncates on re-generation),
so TBT/TTFT describe what a client would actually have streamed.

All summaries are pure functions of the records — no clocks here; the
``latency_summary`` dict is exactly the schema-validated ``latency``
row block of ``repro.perf.report`` (serve_bench's open-loop rows).
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np


@dataclasses.dataclass
class SLO:
    """A latency service-level objective: first token within
    ``ttft_s``, and no between-token gap above ``tbt_s``."""
    ttft_s: float
    tbt_s: float

    def met_by(self, ev: "RequestEvents") -> bool:
        if not ev.completed or ev.ttft_s is None:
            return False
        if ev.ttft_s > self.ttft_s:
            return False
        worst = ev.max_tbt_s
        return worst is None or worst <= self.tbt_s


@dataclasses.dataclass
class RequestEvents:
    """Virtual-clock event record of one open-loop request (seconds
    from the start of the frontend run).

    Multi-token (speculative) steps append one entry per committed
    token to ``token_times_s``, all stamped with the same step
    completion instant: a step that verifies and commits ``c`` tokens
    contributes ``c - 1`` zero-width TBT gaps plus one real gap back to
    the row's previous step.  ``max_tbt_s`` / percentile TBT therefore
    measure what a streaming client would see — tokens arriving in
    bursts with the inter-burst gap as the worst case — and throughput
    metrics count committed tokens, never steps."""
    rid: int
    arrival_s: float                    # generator's arrival time
    enqueue_s: float                    # when the frontend submitted it
    prompt_len: int
    max_new_tokens: int
    first_sched_s: Optional[float] = None   # first slot admission
    token_times_s: List[float] = dataclasses.field(default_factory=list)
    finish_s: Optional[float] = None
    finish_reason: Optional[str] = None
    n_generated: int = 0
    n_preemptions: int = 0
    prefix_len: int = 0                 # enqueue-time prefix match depth

    @property
    def completed(self) -> bool:
        return self.finish_s is not None

    @property
    def ttft_s(self) -> Optional[float]:
        if not self.token_times_s:
            return None
        return self.token_times_s[0] - self.arrival_s

    @property
    def queue_wait_s(self) -> Optional[float]:
        if self.first_sched_s is None:
            return None
        return self.first_sched_s - self.arrival_s

    @property
    def e2e_s(self) -> Optional[float]:
        if self.finish_s is None:
            return None
        return self.finish_s - self.arrival_s

    @property
    def tbt_s(self) -> List[float]:
        t = self.token_times_s
        return [b - a for a, b in zip(t, t[1:])]

    @property
    def max_tbt_s(self) -> Optional[float]:
        gaps = self.tbt_s
        return max(gaps) if gaps else None


def percentile(values: Sequence[float], p: float) -> float:
    """Empirical percentile (0..100); 0.0 on an empty sample so a
    zero-request tail never divides or NaNs."""
    if not len(values):
        return 0.0
    return float(np.percentile(np.asarray(values, np.float64), p))


def _dist(values: Sequence[float]) -> Dict[str, float]:
    vals = list(values)
    return {"p50": percentile(vals, 50), "p90": percentile(vals, 90),
            "p99": percentile(vals, 99),
            "mean": float(np.mean(vals)) if vals else 0.0,
            "max": max(vals) if vals else 0.0,
            "n": len(vals)}


def queue_depth_stats(samples: Sequence[Tuple[float, int]]
                      ) -> Dict[str, float]:
    """Time-weighted queue-depth statistics over ``(t, depth)`` samples
    (each depth holds until the next sample's time)."""
    if not samples:
        return {"mean": 0.0, "max": 0, "samples": 0}
    depth_max = max(d for _, d in samples)
    if len(samples) < 2:
        return {"mean": float(samples[0][1]), "max": depth_max,
                "samples": len(samples)}
    ts = np.asarray([t for t, _ in samples], np.float64)
    ds = np.asarray([d for _, d in samples], np.float64)
    spans = np.diff(ts)
    total = float(spans.sum())
    mean = (float((ds[:-1] * spans).sum() / total) if total > 0
            else float(ds.mean()))
    return {"mean": mean, "max": int(depth_max), "samples": len(samples)}


def latency_summary(events: Sequence[RequestEvents], *,
                    slo: Optional[SLO] = None,
                    makespan_s: Optional[float] = None,
                    queue_depth: Optional[Sequence[Tuple[float, int]]] = None
                    ) -> Dict[str, object]:
    """The telemetry block for one open-loop run — the Report row's
    ``latency`` field.  Always returns the full key set with 0.0s when
    nothing completed (plus a ``note``), never raises or NaNs."""
    events = list(events)
    done = [e for e in events if e.completed]
    ttft = [e.ttft_s for e in done if e.ttft_s is not None]
    tbt = [g for e in done for g in e.tbt_s]
    e2e = [e.e2e_s for e in done]
    qwait = [e.queue_wait_s for e in events
             if e.queue_wait_s is not None]
    if makespan_s is None:
        makespan_s = max((e.finish_s for e in done), default=0.0)
    out: Dict[str, object] = {
        "requests": len(events),
        "completed": len(done),
        "preemptions": sum(e.n_preemptions for e in events),
        "prefix_hit_requests": sum(1 for e in events if e.prefix_len > 0),
        "ttft_s": _dist(ttft),
        "tbt_s": _dist(tbt),
        "e2e_s": _dist(e2e),
        "queue_wait_s": _dist(qwait),
        "queue_depth": queue_depth_stats(queue_depth or []),
        "makespan_s": float(makespan_s),
        "completed_tokens": sum(e.n_generated for e in done),
        "goodput_tok_s": 0.0,
    }
    if not done:
        out["note"] = "zero completed requests"
    if slo is not None:
        ok = [e for e in done if slo.met_by(e)]
        good_tokens = sum(e.n_generated for e in ok)
        out["slo"] = {
            "ttft_s": slo.ttft_s, "tbt_s": slo.tbt_s,
            "attainment": (len(ok) / len(done)) if done else 0.0,
            "good_requests": len(ok),
        }
        out["goodput_tok_s"] = (good_tokens / makespan_s
                                if makespan_s > 0 else 0.0)
    else:
        total = sum(e.n_generated for e in done)
        out["goodput_tok_s"] = (total / makespan_s
                                if makespan_s > 0 else 0.0)
    return out
