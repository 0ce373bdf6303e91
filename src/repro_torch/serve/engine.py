"""Serving engines over the port's LM: continuous batching, plus the
fixed-batch baseline.

``ContinuousBatchingEngine`` is the counterpart of
``repro.serve.engine.ContinuousBatchingEngine``, with the same host
loop: the scheduler (a copy of the reference's) composes sarathi-style
mixed steps, and each step runs one batched (n_slots, 1) decode forward
plus one batch-1 (1, prefill_chunk) forward per prefilling slot, both in
decode mode.  It never branches on a family: the model's DecodeState
adapter says what the state is.  For a family that attends through the
paged cache (dense, moe, hybrid), the decode step walks the cache's pool
view with the engine's identity page map
(``PagedKVCache.page_index_array``, uploaded once) and a prefill row
uses the row-local identity map (``page_idx=None``); with ``paged_kernel=False`` (the reference's
bitwise-parity baseline) there is no page map, and both attend over the
dense cache (the flash-decode kernel on the card).  A family without
attention (ssm) gets no page map.  A recurrent prompt prefill (the ssm's
layers, the hybrid's mamba layers) runs token by token through the
masked recurrence.  A request of a cross-attention family (vlm, audio)
brings its context in ``submit(extra=…)``; at every (re-)admission the
engine installs it into the slot's cache row
(``LM.install_slot_context``: the cross K/V, for audio after the
encoder), and every forward after that reads it.

``StaticBatchEngine`` is the reference's run-to-completion baseline: one
``mode="prefill"`` forward over the whole batch of prompts (attention
layers: causal attention filling the K/V cache; mamba layers: the SSD
kernel; cross layers: attention to the batched context, whose K/V they
write into the cache), then a decode loop, which enters no paged
context: attention layers, cross layers too, decode through the
dense-cache attention.  ``make_prefill_step`` / ``make_serve_step`` are
its two steps, as in the reference.

Sampled tokens stay on the device between steps: ``prev_sampled``
(n_slots,) feeds the next step's decode rows and ``out_buf``
(3*n_slots, max_len) collects every committed token.  Both are allocated
once and updated in place — what donation does in the reference.  The
host reads ``out_buf`` only at a flush point, so without EOS detection a
run has no per-step device sync.

Step time on the card comes from CUDA events recorded around each step
and read when the stats are summarized; on the CPU no step time is
recorded.

Not ported yet (each raises ``NotImplementedError`` if asked for): the
device mesh, speculative decoding, the prefix cache, the stall-free
chunk policy, build-time trace analysis, the paged-kernel autotune, and
``StepCostModel`` (so ``EngineStats`` carries no modeled flops or
bytes).  For a family whose state cannot be cut to a token prefix (ssm,
hybrid) ``prefix_cache=True`` warns and serves with the pool off, as
the reference does.
"""
from __future__ import annotations

import dataclasses
import warnings
from typing import Callable, Dict, List, Optional, Sequence

import numpy as np
import torch

from repro_torch.models import decode_state
from repro_torch.models.attention import PagedDecodeState
from repro_torch.models.model import LM
from repro_torch.serve import sampling
from repro_torch.serve.cache import PagedKVCache
from repro_torch.serve.scheduler import Request, Scheduler, StepPlan

# reference engine options this port does not have yet, with the value
# that means "off"; anything else raises NotImplementedError
_NOT_PORTED = {
    "mesh": None, "rules": None, "sp_kv": False, "spec_decode": False,
    "prefix_cache": False, "analyze": False, "retune": False,
    "check": None, "chunk_policy": "fixed", "tbt_target_s": None,
}


def make_prefill_step(model: LM) -> Callable:
    """``(params, cache, tokens, positions, extra) -> (next_tok (B,) int32,
    cache)``: one ``mode="prefill"`` forward, greedy on the last column;
    ``extra``: the batched (B, T, d) context of a cross-attention family,
    else ``None``."""
    def prefill_step(params, cache, tokens, positions, extra=None):
        logits, cache = model.forward(params, tokens, positions,
                                      mode="prefill", cache=cache,
                                      extra=extra)
        return torch.argmax(logits[:, -1], dim=-1).to(torch.int32), cache

    return prefill_step


def make_serve_step(model: LM, *, sample_temperature: float = 0.0,
                    generator: Optional[torch.Generator] = None
                    ) -> Callable:
    """One decode step: ``(params, cache, tokens (B, 1), positions,
    extra=None) -> (next_tok (B,) int32, cache)``; decode mode reads no
    ``extra`` (the cross K/V are in the cache).  Temperature > 0 draws
    from ``generator`` (the reference keys its draw on the position)."""
    def serve_step(params, cache, tokens, positions, extra=None):
        logits, cache = model.forward(params, tokens, positions,
                                      mode="decode", cache=cache)
        last = logits[:, -1]
        temps = torch.full((last.shape[0],), sample_temperature,
                           dtype=torch.float32, device=last.device)
        return sampling.sample_tokens(last, temps, generator,
                                      any_temp=sample_temperature > 0), cache

    return serve_step


def _events(device: torch.device):
    """A started (start, end) pair of CUDA events on the card; None on
    the CPU, where no step time is recorded."""
    if device.type != "cuda":
        return None
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    return start, end


def _record(stats, events, **counts) -> None:
    rec = StepRecord(**counts)
    if events is not None:
        events[1].record()
        rec.start, rec.end = events
    stats.steps.append(rec)


# ---------------------------------------------------------------------------
# metrics
# ---------------------------------------------------------------------------
@dataclasses.dataclass
class StepRecord:
    n_decode: int
    n_prefill_tokens: int
    # CUDA events bracketing the step on the card (None on the CPU)
    start: Optional[torch.cuda.Event] = None
    end: Optional[torch.cuda.Event] = None

    def device_ms(self) -> Optional[float]:
        """Milliseconds between the step's events (waits for the end
        event); ``None`` on the CPU, where nothing is recorded."""
        if self.start is None:
            return None
        self.end.synchronize()
        return self.start.elapsed_time(self.end)


@dataclasses.dataclass
class EngineStats:
    steps: List[StepRecord] = dataclasses.field(default_factory=list)
    generated_tokens: int = 0
    # model forward passes run (batched decode steps + prefill rows)
    forwards: int = 0

    def summary(self) -> Dict[str, Optional[float]]:
        """Counts, plus step times on the card (``None`` on the CPU)."""
        out: Dict[str, Optional[float]] = {
            "steps": len(self.steps),
            "generated_tokens": self.generated_tokens,
            "forwards": self.forwards,
            "step_ms_p50": None, "step_ms_p95": None,
        }
        ms = sorted(s.device_ms() for s in self.steps
                    if s.start is not None)
        if ms:
            out.update(step_ms_p50=ms[len(ms) // 2],
                       step_ms_p95=ms[min(len(ms) - 1, int(0.95 * len(ms)))])
        return out


# ---------------------------------------------------------------------------
# continuous batching
# ---------------------------------------------------------------------------
class ContinuousBatchingEngine:
    """Paged continuous-batching engine (every family the port serves).

    Usage::

        eng = ContinuousBatchingEngine(model, params, n_slots=4, max_len=64)
        rid = eng.submit(prompt_tokens, max_new_tokens=16)        # queued
        results = eng.run()          # drain; {rid: np.ndarray of tokens}

    The engine runs on the model's device.
    """

    def __init__(self, model: LM, params, *, n_slots: int, max_len: int,
                 page_size: int = 16, prefill_chunk: int = 8,
                 page_budget: Optional[int] = None,
                 eos_id: Optional[int] = None, seed: int = 0,
                 paged_kernel: Optional[bool] = None, **kwargs):
        if kwargs.get("prefix_cache") and \
                not model.decode_state.prefix_cachable:
            warnings.warn(
                f"prefix_cache=True ignored: family {model.cfg.family!r} "
                "has non-token-addressable (recurrent) decode state that "
                "cannot be truncated to a prompt prefix; serving with the "
                "prefix cache off", UserWarning, stacklevel=2)
            kwargs["prefix_cache"] = False
        for name, value in kwargs.items():
            if name not in _NOT_PORTED:
                raise TypeError(f"unexpected keyword argument {name!r}")
            if value != _NOT_PORTED[name]:
                raise NotImplementedError(
                    f"{name}={value!r} is not ported yet")
        self.model = model
        self.params = params
        self.device = model.device
        self.n_slots = n_slots
        self.max_len = max_len
        self.kv = PagedKVCache(
            n_slots, max_len, page_size, page_budget=page_budget,
            slot_aux_tokens=model.decode_state.context_tokens(model.cfg))
        self.sched = Scheduler(self.kv, prefill_chunk=prefill_chunk,
                               eos_id=eos_id)
        # the paged flash-decode is on by default; paged_kernel=False
        # attends over the dense cache instead (the reference's
        # bitwise-parity baseline).  The identity page map of the decode
        # step's pool view exists for families that attend through the
        # paged cache, with the paged kernel on.
        self.paged_kernel = (bool(paged_kernel) if paged_kernel is not None
                             else True)
        self._paged = model.decode_state.paged and self.paged_kernel
        self._page_idx = (torch.as_tensor(self.kv.page_index_array(),
                                          device=self.device)
                          if self._paged else None)
        self._n_out_rows = 3 * n_slots
        self.cache = self.model.init_cache(self.n_slots, self.max_len)
        self._out_buf = torch.zeros((self._n_out_rows, self.max_len),
                                    dtype=torch.int32, device=self.device)
        self._prev_sampled = torch.zeros((self.n_slots,), dtype=torch.int32,
                                         device=self.device)
        self._gen = torch.Generator(device=self.device)
        self._gen.manual_seed(seed)
        self._free_rows = list(range(self._n_out_rows))
        self._slot_row = np.full((self.n_slots,), -1, np.int32)
        self._pending: List[Request] = []        # finished, tokens unread
        self._pending_rows: Dict[int, int] = {}  # rid -> out row
        self._step_idx = 0
        self._seen_discarded = 0
        self.stats = EngineStats()
        self._results: Dict[int, np.ndarray] = {}

    def _dev(self, a, dtype=None) -> torch.Tensor:
        return torch.as_tensor(np.asarray(a), dtype=dtype,
                               device=self.device)

    def _paged_state(self, page_idx) -> Optional[PagedDecodeState]:
        return (PagedDecodeState(page_idx, self.kv.page_size)
                if self._paged else None)

    # -- steps ----------------------------------------------------------
    def _commit_samples(self, nxt: torch.Tensor, slots: Sequence[int],
                        src: Sequence[int], out_idx: Sequence[int]) -> None:
        """Write the samples ``nxt[src]`` of sample rows into their slots'
        output rows at ``out_idx`` and carry them forward in
        ``prev_sampled``.  Only rows that sample are passed, so nothing
        needs dropping on the device (the reference's ``mode="drop"``)."""
        if not slots:
            return
        rows = self._dev(self._slot_row[list(slots)], torch.long)
        cols = self._dev(list(out_idx), torch.long)
        vals = nxt[self._dev(list(src), torch.long)]
        self._out_buf.index_put_((rows, cols), vals)
        self._prev_sampled.index_put_((self._dev(list(slots), torch.long),),
                                      vals)

    def _decode_step(self, plan: StepPlan) -> None:
        tokens = self._dev(plan.tokens, torch.long)
        token_src = self._dev(plan.token_src, torch.bool)
        # decode rows take their input token from the previous step's
        # on-device samples
        tokens[:, 0] = torch.where(token_src, self._prev_sampled.long(),
                                   tokens[:, 0])
        logits, self.cache = self.model.forward(
            self.params, tokens, self._dev(plan.positions, torch.long),
            mode="decode", cache=self.cache,
            n_valid=self._dev(plan.n_valid, torch.int32),
            paged=self._paged_state(self._page_idx))
        temps = self._dev(plan.temperatures, torch.float32)
        nxt = sampling.sample_tokens(
            logits[:, 0], temps, self._gen,
            any_temp=bool((plan.temperatures > 0).any()))
        sample = [s for s in range(self.n_slots)
                  if plan.out_idx[s] < self.max_len]
        self._commit_samples(nxt, sample, sample,
                             [int(plan.out_idx[s]) for s in sample])
        self.stats.forwards += 1

    def _prefill_row(self, pf) -> None:
        row = self.model.cache_row(self.cache, pf.slot)
        logits, row = self.model.forward(
            self.params, self._dev(pf.tokens, torch.long),
            self._dev(pf.positions, torch.long), mode="decode", cache=row,
            n_valid=self._dev(pf.n_valid, torch.int32),
            paged=self._paged_state(None))
        self.model.set_cache_row(self.cache, pf.slot, row)
        # the sample comes from the last valid column (it only commits
        # when the chunk completes the prompt)
        last_col = max(int(pf.n_valid[0]) - 1, 0)
        nxt = sampling.sample_tokens(
            logits[:, last_col],
            torch.full((1,), pf.temperature, dtype=torch.float32,
                       device=self.device),
            self._gen, any_temp=pf.temperature > 0)
        if pf.out_idx < self.max_len:
            self._commit_samples(nxt, [pf.slot], [0], [int(pf.out_idx)])
        self.stats.forwards += 1

    def step(self) -> bool:
        """Run one engine iteration; False when no work remains."""
        plan = self.sched.next_plan(self._step_idx)
        if plan is None:
            return self.sched.has_work()
        events = _events(self.device)
        for slot in np.nonzero(plan.reset_mask)[0]:
            # a request enters this slot: give it a fresh output row (a
            # still-mapped old row can only be a preemption orphan)
            old = int(self._slot_row[slot])
            if old >= 0:
                self._free_rows.append(old)
            if not self._free_rows:
                self._flush_results()
            self._slot_row[slot] = self._free_rows.pop()
        if plan.reset_mask.any():
            self.model.reset_cache_slots(
                self.cache, self._dev(plan.reset_mask, torch.bool))
            for slot in np.nonzero(plan.reset_mask)[0]:
                # install the request's read-only context into its row
                # (the cross K/V; audio runs its encoder here, once an
                # admission), a re-admission after preemption included
                req = self.sched.active.get(int(slot))
                if req is not None and req.extra:
                    self.model.install_slot_context(
                        self.params, self.cache, int(slot), req.extra)
        if plan.n_decode:
            self._decode_step(plan)
        for pf in plan.prefills:
            self._prefill_row(pf)
        # EOS detection is the only per-step host sync
        sampled = (self._prev_sampled.cpu().numpy()
                   if self.sched.eos_id is not None else None)
        done = self.sched.commit(plan, sampled, self._step_idx)
        for req in done:
            # tokens stay on device until the next flush point; the row
            # moves from the slot to the pending map
            self._pending.append(req)
            self._pending_rows[req.rid] = int(self._slot_row[req.finish_slot])
            self._slot_row[req.finish_slot] = -1
        _record(self.stats, events, n_decode=plan.n_decode,
                n_prefill_tokens=plan.n_prefill_tokens)
        # count only useful tokens: samples a preemption throws away
        # come back off the total
        discarded = self.sched.discarded_tokens - self._seen_discarded
        self._seen_discarded = self.sched.discarded_tokens
        self.stats.generated_tokens += len(plan.sample_slots) - discarded
        self._step_idx += 1
        return self.sched.has_work()

    # -- API ------------------------------------------------------------
    def submit(self, prompt: Sequence[int], max_new_tokens: int, *,
               temperature: float = 0.0,
               extra: Optional[Dict[str, np.ndarray]] = None) -> int:
        """Queue a request; returns its rid.  ``extra`` carries the
        request's read-only context — (T, d) or (1, T, d) arrays:
        ``image_embeds`` (vlm), ``audio_frames`` (audio) — which the
        cross-attention families require and the others refuse."""
        need = self.model.decode_state.requires_extra
        missing = [k for k in need if extra is None or k not in extra]
        if missing:
            raise ValueError(
                f"family {self.model.cfg.family!r} requires extra "
                f"context {missing} at submit()")
        unknown = [k for k in (extra or {}) if k not in need]
        if unknown:
            raise ValueError(
                f"family {self.model.cfg.family!r} takes no extra "
                f"context {unknown}; it requires exactly {list(need)}")
        if extra is not None:
            # batch-1 host arrays, the shape rule the install shares
            extra = {k: decode_state.ensure_request_context(np.asarray(v))
                     for k, v in extra.items()}
        req = self.sched.submit(np.asarray(prompt), max_new_tokens,
                                temperature=temperature, extra=extra,
                                step=self._step_idx)
        return req.rid

    def _flush_results(self) -> None:
        """Materialize finished requests' tokens (one buffer transfer)
        and recycle their output rows."""
        if not self._pending:
            return
        buf = self._out_buf.cpu().numpy()
        for req in self._pending:
            row = self._pending_rows.pop(req.rid)
            toks = buf[row, :req.n_generated].copy()
            req.generated = toks.tolist()
            self._results[req.rid] = toks
            self._free_rows.append(row)
        self._pending = []

    def run(self, max_steps: Optional[int] = None) -> Dict[int, np.ndarray]:
        """Drain the queue; returns {rid: generated tokens}."""
        n, stalled = 0, 0
        while True:
            before = self._step_idx
            if not self.step():
                break
            n += 1
            if max_steps is not None and n >= max_steps:
                break
            # a planless iteration with work remaining means nothing can
            # proceed (e.g. a page budget too small for one request)
            stalled = stalled + 1 if self._step_idx == before else 0
            if stalled > self.n_slots + 2:
                raise RuntimeError(
                    "scheduler stalled: work queued but no step can run "
                    "(page budget too small for an in-flight request?)")
        self._flush_results()
        return dict(self._results)

    def requests(self) -> List[Request]:
        return list(self.sched.finished)


# ---------------------------------------------------------------------------
# fixed-batch baseline
# ---------------------------------------------------------------------------
class StaticBatchEngine:
    """Run-to-completion fixed-batch engine: one prefill + a decode loop.

    The reference's baseline, kept for correctness (temperature-0 parity
    with the continuous engine) and throughput comparison.  The prefill
    is ``LM.forward(mode="prefill")`` over every prompt at once: in an
    attention layer causal attention that fills the layer's K/V cache, in
    a mamba layer the SSD kernel, one launch a layer.  The decode steps
    run in no paged context: attention layers attend over the cache
    through the flash-decode kernel, one launch a layer.  ``stats.steps``
    holds the prefill as its first record and then one record a decode
    step, timed by CUDA events on the card.
    """

    def __init__(self, model: LM, params, max_len: int, batch: int, *,
                 sample_temperature: float = 0.0):
        self.model = model
        self.params = params
        self.max_len = max_len
        self.batch = batch
        self.device = model.device
        gen = torch.Generator(device=self.device)
        gen.manual_seed(0)
        self.prefill_fn = make_prefill_step(model)
        self.decode_fn = make_serve_step(
            model, sample_temperature=sample_temperature, generator=gen)
        self.stats = EngineStats()

    def generate(self, prompt_tokens, n_steps: int,
                 extra: Optional[Dict[str, object]] = None) -> torch.Tensor:
        """prompt_tokens (B, S) -> (B, n_steps) int32 tokens, on the
        model's device.  ``extra``: a cross-attention family's batched
        (B, T, d) context (arrays or tensors)."""
        toks = torch.as_tensor(np.asarray(prompt_tokens), dtype=torch.long,
                               device=self.device)
        B, S = toks.shape
        if B != self.batch:
            raise ValueError(f"batch {B} != the engine's {self.batch}")
        if extra is not None:
            extra = {k: torch.as_tensor(v, device=self.device)
                     for k, v in extra.items()}
        cache = self.model.init_cache(B, self.max_len)
        positions = torch.arange(S, device=self.device)[None].expand(B, S)
        events = _events(self.device)
        nxt, cache = self.prefill_fn(self.params, cache, toks, positions,
                                     extra)
        _record(self.stats, events, n_decode=0, n_prefill_tokens=B * S)
        out = [nxt]
        for t in range(n_steps - 1):
            events = _events(self.device)
            pos = torch.full((B, 1), S + t, dtype=torch.long,
                             device=self.device)
            nxt, cache = self.decode_fn(self.params, cache,
                                        nxt[:, None].long(), pos)
            _record(self.stats, events, n_decode=B, n_prefill_tokens=0)
            out.append(nxt)
        self.stats.forwards += n_steps
        self.stats.generated_tokens += B * n_steps
        return torch.stack(out, dim=1)
