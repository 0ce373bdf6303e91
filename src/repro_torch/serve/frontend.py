"""Open-loop serving front end: a virtual-clock intake loop over
``ContinuousBatchingEngine``; the counterpart of
``repro.serve.frontend``.

Closed-loop serving (``engine.run()``) answers "how fast can the engine
drain a queue"; it cannot answer "how long does a user wait when
requests arrive faster or slower than the engine drains them": TTFT,
time between tokens and goodput under load are properties of a system
with a clock.  :class:`OpenLoopFrontend` supplies that clock:

  * it takes a list of :class:`~repro_torch.serve.arrivals.ArrivalRequest`
    records (any generator in ``serve/arrivals.py``),
  * submits each one the moment the virtual clock passes its
    ``arrival_s`` (the scheduler hashes the prompt's prefix keys at
    ``submit()``, so a queued request admits at its matched offset the
    instant a slot frees),
  * calls ``engine.step()`` between arrivals, and
  * records per-request event timestamps (arrival, enqueue, first
    scheduled, every kept token, finish) as
    :class:`~repro_torch.serve.slo.RequestEvents` for
    ``slo.latency_summary``.

Two clocks, one loop (the reference's):

``clock="wall"``
    The virtual clock advances by each step's measured time,
    ``perf.measure.wall_clock``: the card drained, then the whole step
    (planning, launches, device work, commit) between two CUDA events.
    This is the measurement clock.  Nothing is timed off the card, so
    on an engine that is not on a CUDA device it raises.

``clock="model"``
    The clock advances by ``engine.modeled_step_time()``: the cost
    model's roofline bound time for each step's composition against the
    engine's ``hw``.  No time is ever measured, so the run is
    deterministic and runs anywhere (the CPU tests).  The front end
    also feeds the modeled times into the scheduler's stall-free chunk
    estimator (``note_step_wall``) in place of the engine's own
    feedback (``step_feedback`` is set to ``"external"`` for the run
    and restored after).

Idle jumps: when the engine has no work and arrivals remain, the clock
jumps straight to the next arrival, so an open-loop run never spins.  A
planless iteration with work queued means the scheduler cannot place
anything (a page budget below one request's first chunk); after the
same patience window as ``engine.run()`` that raises instead of
hanging.

Closed-loop compatibility: under ``arrivals.closed_loop_arrivals``
every request is submitted before the first step, so the step sequence,
and at temperature 0 the tokens, are exactly ``engine.submit()`` x N +
``engine.run()``'s.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.perf.measure import wall_clock
from repro_torch.serve.arrivals import ArrivalRequest
from repro_torch.serve.slo import SLO, RequestEvents, latency_summary

CLOCKS = ("wall", "model")


@dataclasses.dataclass
class OpenLoopResult:
    """One open-loop run: per-request event records, the generated
    tokens, and the raw queue-depth samples (``(t, depth)``)."""
    events: List[RequestEvents]
    results: Dict[int, np.ndarray]
    makespan_s: float
    queue_depth: List[Tuple[float, int]]
    engine_summary: Dict[str, Any]
    clock: str
    # the ArrivalRequest records of every request that finished during
    # the run, in rid order: ``arrivals.save_trace`` serializes them under
    # the repro.serve.trace schema, so any open-loop run can be replayed
    # (launch/serve.py --record-trace)
    completed_arrivals: List[ArrivalRequest] = dataclasses.field(
        default_factory=list)

    def summary(self, slo: Optional[SLO] = None) -> Dict[str, Any]:
        """The schema-valid ``latency`` block (slo.latency_summary)."""
        return latency_summary(self.events, slo=slo,
                               makespan_s=self.makespan_s,
                               queue_depth=self.queue_depth)


class OpenLoopFrontend:
    """Virtual-clock intake loop over a ``ContinuousBatchingEngine``.

    Usage::

        eng = ContinuousBatchingEngine(model, params, n_slots=4,
                                       max_len=128)
        reqs = arrivals.synthetic_requests(32, (8, 16), (4, 8), V)
        front = OpenLoopFrontend(eng)                 # on the card
        res = front.run(arrivals.poisson_arrivals(reqs, rate=2.0))
        res.summary(slo=SLO(ttft_s=0.5, tbt_s=0.1))

    The front end owns no engine state: it submits, steps, and reads the
    engine's per-step records (``last_plan`` / ``last_sampled_rids`` /
    ``last_admitted_rids``); ``engine.reset()`` between runs keeps the
    built model and the kernels' call tables.
    """

    def __init__(self, engine, *, clock: str = "wall"):
        if clock not in CLOCKS:
            raise ValueError(f"clock {clock!r} not in {CLOCKS}")
        if clock == "wall" and engine.device.type != "cuda":
            raise ValueError(
                f"clock='wall' times each step with CUDA events, and the "
                f"engine is on {engine.device}: off the card use "
                f"clock=\"model\" (the cost model's step times)")
        self.engine = engine
        self.clock = clock

    # -- event recording -------------------------------------------------
    def _record_step(self, t: float, events: Dict[int, RequestEvents],
                     live: Dict[int, Any]) -> None:
        """Fold one executed step's engine records into the event map.
        Ordering matters: preemption truncation first (discarded tokens
        leave ``token_times_s``), then first-schedule marks, then this
        step's kept tokens, then finishes."""
        eng = self.engine
        # recompute-style preemption throws away a victim's sampled
        # tokens; the event record must not keep their timestamps (TBT /
        # TTFT describe what a client would actually have streamed)
        for rid, req in live.items():
            ev = events[rid]
            if req.n_preemptions > ev.n_preemptions:
                ev.n_preemptions = req.n_preemptions
                del ev.token_times_s[req.n_generated:]
        for rid in eng.last_admitted_rids:
            ev = events.get(rid)
            if ev is None:        # pre-queued outside this frontend run
                continue
            if ev.first_sched_s is None:
                ev.first_sched_s = t
            req = live.get(rid)
            if req is not None:
                ev.prefix_len = max(ev.prefix_len, req.prefix_len)
        counts = eng.sched.last_commit_counts
        for slot, rid in eng.last_sampled_rids:
            ev = events.get(rid)
            req = live.get(rid)
            if ev is None or req is None:
                continue
            # a speculative step commits c >= 1 tokens at once; all c
            # share this step's completion instant, producing c - 1 zero
            # TBT gaps (the multi-token event contract, see serve/slo).
            # Without speculation c == 1 and this is the classic append.
            c = int(counts.get(slot, 1))
            # this step committed tokens n_generated-c+1 .. n_generated
            # (commit already ran), so exactly n_generated-c earlier
            # times stay
            del ev.token_times_s[max(0, req.n_generated - c):]
            ev.token_times_s.extend([t] * c)
            ev.n_generated = req.n_generated
        for rid in [r for r, req in live.items() if req.finish_reason]:
            req = live.pop(rid)
            ev = events[rid]
            ev.finish_s = t
            ev.finish_reason = req.finish_reason
            ev.n_generated = req.n_generated

    # -- the loop --------------------------------------------------------
    def _step(self) -> float:
        """Run one engine step; its time on this front end's clock (0.0
        for a planless iteration)."""
        eng = self.engine
        if self.clock == "wall":
            _, dt = wall_clock(eng.step)
            return dt
        eng.step()
        plan = eng.last_plan
        if plan is None:
            return 0.0
        dt = eng.modeled_step_time(plan.n_decode, plan.n_prefill_tokens)
        eng.sched.note_step_wall(dt, plan.n_decode + plan.n_prefill_tokens)
        return dt

    def run(self, arrivals: Sequence[ArrivalRequest], *,
            max_steps: Optional[int] = None,
            start_s: float = 0.0) -> OpenLoopResult:
        """Drive the workload to completion; returns the event records
        and every request's generated tokens."""
        eng = self.engine
        arr = sorted(arrivals, key=lambda a: a.arrival_s)
        events: Dict[int, RequestEvents] = {}
        arecs: Dict[int, ArrivalRequest] = {}  # rid -> submitted arrival
        live: Dict[int, Any] = {}          # rid -> scheduler Request
        depth: List[Tuple[float, int]] = []
        t = start_s
        i = 0
        n_steps = 0
        stalled = 0
        prev_feedback = eng.step_feedback
        if self.clock == "model":
            # the front end feeds deterministic modeled step times into
            # the stall-free chunk estimator; measured feedback would leak
            # host noise into an otherwise reproducible run
            eng.step_feedback = "external"
        try:
            while i < len(arr) or eng.sched.has_work():
                while i < len(arr) and arr[i].arrival_s <= t:
                    a = arr[i]
                    rid = eng.submit(a.prompt, a.max_new_tokens,
                                     temperature=a.temperature,
                                     extra=a.extra)
                    req = eng.sched.queue[-1]
                    if req.rid != rid:
                        raise RuntimeError(
                            f"submitted rid {rid} is not the queue's last "
                            f"({req.rid})")
                    arecs[rid] = a
                    live[rid] = req
                    events[rid] = RequestEvents(
                        rid=rid, arrival_s=a.arrival_s, enqueue_s=t,
                        prompt_len=req.prompt_len,
                        max_new_tokens=req.max_new_tokens)
                    i += 1
                depth.append((t, len(eng.sched.queue)))
                if not eng.sched.has_work():
                    # idle engine: the clock jumps to the next arrival
                    t = max(t, arr[i].arrival_s)
                    continue
                dt = self._step()
                if eng.last_plan is None:
                    # work queued but nothing placeable; submitting more
                    # requests cannot free pages, so this is the same
                    # dead state engine.run() guards against
                    stalled += 1
                    if stalled > eng.n_slots + 2:
                        raise RuntimeError(
                            "open-loop frontend stalled: work queued but "
                            "no step can run (page budget too small for "
                            "an in-flight request?)")
                    continue
                stalled = 0
                t += dt
                n_steps += 1
                self._record_step(t, events, live)
                if max_steps is not None and n_steps >= max_steps:
                    break
        finally:
            eng.step_feedback = prev_feedback
        depth.append((t, len(eng.sched.queue)))
        return OpenLoopResult(
            events=[events[r] for r in sorted(events)],
            results=eng.results(),
            makespan_s=t - start_s,
            queue_depth=depth,
            engine_summary=eng.stats.summary(),
            clock=self.clock,
            completed_arrivals=[
                arecs[r] for r in sorted(arecs)
                if events[r].finish_reason is not None])
