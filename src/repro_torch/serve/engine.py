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
plain step has no device sync; a verify step has one (the drafter needs
the accepted tokens), and a fast-path step leaves the drafter's
histories stale until the request next proposes.

The prefix cache (``prefix_cache=True``, families whose state is a
token prefix: dense, moe, vlm, audio) keeps released requests'
page-aligned prompt prefixes pooled; a matching admission copies the
donor slot's K/V in place (``LM.install_cache_prefix``) instead of
prefilling them.  Speculative decoding (``spec_decode=True``) drafts up
to ``spec_k`` tokens a greedy row with the n-gram drafter
(``serve/draft.py``), scores them in one (n_slots, spec_k + 1) verify
forward and keeps the longest prefix the argmax chain agrees with, plus
one token: the token-addressable families rewind their position
counters (``LM.adjust_cache_counters``); the recurrent ones (ssm,
hybrid) restore a snapshot of their state taken before the verify
forward and run it again with ``n_valid`` the accepted counts.
``check=True`` attaches the shadow-state checker
(``repro_torch.analysis.schedcheck``) to the cache and the scheduler.

Step time on the card comes from CUDA events recorded around each step
and read when the stats are summarized; on the CPU no step time is
recorded.  ``StepCostModel`` (the reference's, over the copied analytic
``core.costmodel``) adds each step's modeled flops and bytes to
``EngineStats``; ``modeled_step_time`` prices a step's composition
against the card's ``HWSpec`` (``self.hw``), the clock of the open-loop
front end's ``clock="model"`` (``serve/frontend.py``).

The stall-free chunk policy (``chunk_policy="stall_free"``,
``tbt_target_s``) is the copied scheduler's: it sizes each step's
prefill chunks from an estimate of seconds a token that each executed
step feeds (``Scheduler.note_step_wall``).  Under ``step_feedback =
"wall"`` (the default) the engine feeds its own step's CUDA-event time,
one sync a step, and only with that policy on; the CPU cannot time a
step, so there a stall-free step raises and the policy runs under the
front end's ``clock="model"``, which sets ``step_feedback =
"external"`` and feeds modeled times itself.

The paged kernel's KV split count is tuned at construction, as the
reference tunes its ``block_pages`` (``_tune_paged_kernel``): on the
card ``core.autotune.tune_paged_attention`` times every split count at
the engine's pure-decode shape, its rows at ragged lengths, or reads the
sweep from the on-disk cache (``retune=True`` measures again).  It keeps
``split_plan``'s count unless another beats it in most of the sweep's
paired rounds (a sign test) and by 15% of its median; ``paged_meta``
holds the sweep, the count chosen and why, and the pure-decode forward
launches B1 at that count.  The chunk rows (``page_idx=None``) and the
verify forward keep ``split_plan``'s count: the sweep did not time their
shapes.  On the CPU no sweep can be timed:
``paged_meta`` says so and ``retune=True`` raises.  An ssm has nothing to
tune, and ``paged_kernel=False`` tunes nothing (``paged_meta`` is
``None``).

Not ported yet (each raises ``NotImplementedError`` if asked for): the
device mesh (``mesh``, ``rules``, ``sp_kv``) and build-time trace
analysis (``analyze``).  For a family
whose state cannot be cut to a token prefix (ssm, hybrid)
``prefix_cache=True`` warns and serves with the pool off, as the
reference does.
"""
from __future__ import annotations

import dataclasses
import warnings
from typing import Callable, Dict, List, Optional, Sequence

import numpy as np
import torch

from repro_torch.analysis.findings import Finding
from repro_torch.analysis.schedcheck import SchedChecker
from repro_torch.configs.shapes import ShapeSpec
from repro_torch.core import costmodel
from repro_torch.models import decode_state
from repro_torch.models.attention import PagedDecodeState
from repro_torch.models.layers import dtype_of
from repro_torch.models.model import LM
from repro_torch.serve import sampling
from repro_torch.serve.cache import PagedKVCache
from repro_torch.serve.draft import NGramDrafter
from repro_torch.serve.scheduler import (Request, RequestState, Scheduler,
                                         StepPlan)

# reference engine options this port does not have yet, with the value
# that means "off"; anything else raises NotImplementedError
_NOT_PORTED = {
    "mesh": None, "rules": None, "sp_kv": False, "analyze": False,
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
class StepCostModel:
    """Analytic per-step FLOPs/bytes (core/costmodel) for engine stats: a
    copy of the reference's.

    Decode rows are costed at a representative mid-stream cache length
    (``max_len // 2``); prefill tokens at the per-token average of a full
    ``max_len`` prefill.  These are *model* numbers (the analytic
    implementation cost, not a counter): the modeled bound time of a step
    over its measured time is the served step's share of its roofline.
    """

    def __init__(self, cfg, max_len: int):
        kv = max(1, max_len // 2)
        # per-token decode cost excludes the enc-dec audio encoder: the
        # engines run it once per request at admission (install_context),
        # so it is amortized into the prefill per-token average instead
        self.decode_flops_tok = costmodel.forward_flops(
            cfg, 1, 1, kv_len=kv, decode=True,
            include_encoder=False)["total"]
        dec = costmodel.step_hbm_bytes(
            cfg, ShapeSpec("serve_decode", kv, 1, "decode"))
        self.decode_param_bytes = dec.get("params", 0.0)
        self.decode_cache_bytes_row = dec.get("cache", 0.0)
        S = max(1, max_len)
        self.prefill_flops_tok = costmodel.forward_flops(cfg, 1, S)["total"] / S
        self.prefill_bytes_tok = costmodel.step_hbm_bytes(
            cfg, ShapeSpec("serve_prefill", S, 1, "prefill"))["total"] / S

    def step_cost(self, n_decode: int, n_prefill_tokens: int
                  ) -> tuple[float, float]:
        flops = (n_decode * self.decode_flops_tok
                 + n_prefill_tokens * self.prefill_flops_tok)
        # params stream through HBM once per batched decode step, not once
        # per row; per-row traffic is the row's own cache read
        bytes_ = ((self.decode_param_bytes if n_decode else 0.0)
                  + n_decode * self.decode_cache_bytes_row
                  + n_prefill_tokens * self.prefill_bytes_tok)
        return flops, bytes_


@dataclasses.dataclass
class StepRecord:
    n_decode: int
    n_prefill_tokens: int
    # the paged cache's slot occupancy and page utilization after the
    # step (0.0 for the static engine, which has no paged cache)
    occupancy: float = 0.0
    page_utilization: float = 0.0
    # the step ran the speculative verify forward (not the plain step)
    verify: bool = False
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
    # model forward passes run (batched decode steps, verify passes and
    # prefill rows)
    forwards: int = 0
    # prompt tokens whose prefill the prefix cache skipped (mirrors
    # Scheduler.prefix_hit_tokens)
    prefix_hit_tokens: int = 0
    # speculative decoding: draft tokens fed to verify steps, and how
    # many of them greedy acceptance kept (the token after them is a
    # normal sample, counted in generated_tokens only)
    drafted_tokens: int = 0
    accepted_draft_tokens: int = 0
    # the analytic (StepCostModel) work of the steps run
    model_flops: float = 0.0
    model_bytes: float = 0.0

    def summary(self) -> Dict[str, Optional[float]]:
        """The reference's keys plus ``forwards``.  Times (``tok_per_s``
        and ``model_tflops_per_s``: tokens and modeled flops over the
        summed step events; ``step_ms_p50``, ``step_ms_p95``) are
        CUDA-event times on the card and ``None`` on the CPU.  With no
        step, every rate is 0.0 and ``note`` says why."""
        accept_rate = (self.accepted_draft_tokens / self.drafted_tokens
                       if self.drafted_tokens else 0.0)
        counts = {"prefix_hit_tokens": self.prefix_hit_tokens,
                  "drafted_tokens": self.drafted_tokens,
                  "accepted_draft_tokens": self.accepted_draft_tokens,
                  "accept_rate": accept_rate,
                  "model_flops": self.model_flops,
                  "model_bytes": self.model_bytes}
        if not self.steps:
            return {"steps": 0, "generated_tokens": 0, "forwards": 0,
                    "tok_per_s": 0.0, "step_ms_p50": 0.0,
                    "step_ms_p95": 0.0, "mean_occupancy": 0.0,
                    "mean_page_utilization": 0.0, "prefix_hit_rate": 0.0,
                    "model_tflops_per_s": 0.0,
                    **counts, "note": "zero steps executed"}
        prefill_tokens = sum(s.n_prefill_tokens for s in self.steps)
        prompt_total = prefill_tokens + self.prefix_hit_tokens
        out: Dict[str, Optional[float]] = {
            "steps": len(self.steps),
            "generated_tokens": self.generated_tokens,
            "forwards": self.forwards,
            "tok_per_s": None, "step_ms_p50": None, "step_ms_p95": None,
            "model_tflops_per_s": None,
            "mean_occupancy": float(np.mean(
                [s.occupancy for s in self.steps])),
            "mean_page_utilization": float(np.mean(
                [s.page_utilization for s in self.steps])),
            # the share of all prompt tokens the prefix cache served
            "prefix_hit_rate": (self.prefix_hit_tokens / prompt_total
                                if prompt_total else 0.0),
            **counts,
        }
        ms = sorted(s.device_ms() for s in self.steps
                    if s.start is not None)
        if ms:
            total = sum(ms)
            out.update(
                tok_per_s=(self.generated_tokens / (total / 1e3)
                           if total else 0.0),
                model_tflops_per_s=(self.model_flops / (total / 1e3) / 1e12
                                    if total else 0.0),
                step_ms_p50=ms[len(ms) // 2],
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

    The engine runs on the model's device.  ``chunk_policy`` /
    ``tbt_target_s``, ``prefix_cache`` / ``prefix_pool``, ``spec_decode``
    / ``spec_k`` and ``check`` are the reference's options (see the
    module docstring); ``check=None`` takes the class attribute
    ``_DEFAULT_CHECK``, which a test module may set to shadow-check every
    engine it builds.  ``hw`` (the card's ``HWSpec``; the SXM part's on
    the CPU) prices ``modeled_step_time``, and ``step_feedback`` says
    what feeds the stall-free policy: both are plain attributes.
    """

    #: class-level default for ``check``
    _DEFAULT_CHECK = False

    def __init__(self, model: LM, params, *, n_slots: int, max_len: int,
                 page_size: int = 16, prefill_chunk: int = 8,
                 chunk_policy: str = "fixed",
                 tbt_target_s: Optional[float] = None,
                 page_budget: Optional[int] = None,
                 eos_id: Optional[int] = None, seed: int = 0,
                 prefix_cache: bool = False, prefix_pool: int = 8,
                 paged_kernel: Optional[bool] = None, retune: bool = False,
                 spec_decode: bool = False, spec_k: int = 4,
                 check: Optional[bool] = None, **kwargs):
        for name, value in kwargs.items():
            if name not in _NOT_PORTED:
                raise TypeError(f"unexpected keyword argument {name!r}")
            if value != _NOT_PORTED[name]:
                raise NotImplementedError(
                    f"{name}={value!r} is not ported yet")
        if spec_decode and spec_k < 1:
            raise ValueError(
                f"spec_decode=True needs spec_k >= 1, got {spec_k}")
        self.spec_decode = bool(spec_decode)
        self.spec_k = int(spec_k) if self.spec_decode else 0
        if prefix_cache and not model.decode_state.prefix_cachable:
            warnings.warn(
                f"prefix_cache=True ignored: family {model.cfg.family!r} "
                "has non-token-addressable (recurrent) decode state that "
                "cannot be truncated to a prompt prefix; serving with the "
                "prefix cache off", UserWarning, stacklevel=2)
        self.prefix_cache = bool(prefix_cache
                                 and model.decode_state.prefix_cachable)
        self.model = model
        self.params = params
        self.device = model.device
        self.n_slots = n_slots
        self.max_len = max_len
        self.kv = PagedKVCache(
            n_slots, max_len, page_size, page_budget=page_budget,
            slot_aux_tokens=model.decode_state.context_tokens(model.cfg),
            prefix_pool=prefix_pool if self.prefix_cache else 0)
        self.sched = Scheduler(self.kv, prefill_chunk=prefill_chunk,
                               eos_id=eos_id, chunk_policy=chunk_policy,
                               tbt_target_s=tbt_target_s,
                               spec_k=self.spec_k)
        # what feeds the stall-free chunk policy's per-token estimate:
        # "wall" (default) notes each step's CUDA-event time; the open-loop
        # front end switches this to "external" under its model clock and
        # feeds modeled step times itself
        self.step_feedback = "wall"
        self.hw = costmodel.hw_of(self.device)
        self._cost = StepCostModel(model.cfg, max_len)
        self.drafter: Optional[NGramDrafter] = None
        # rids whose drafter history misses tokens committed by no-draft
        # fast-path steps (which read nothing back); resynced from
        # out_buf right before the rid next proposes
        self._draft_stale: set = set()
        if self.spec_decode:
            self.drafter = NGramDrafter(self.spec_k,
                                        **self._drafter_throttle())
        self.check = bool(self._DEFAULT_CHECK if check is None else check)
        self.checker: Optional[SchedChecker] = None
        if self.check:
            self.checker = SchedChecker.attach(self.kv, self.sched)
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
        # the pure-decode forward's KV split count (None: split_plan's)
        self._paged_splits: Optional[int] = None
        self.paged_meta: Optional[Dict] = None
        if self.paged_kernel:
            self.paged_meta = self._tune_paged_kernel(retune)
        self._n_out_rows = 3 * n_slots
        self.cache = self.model.init_cache(self.n_slots, self.max_len)
        # a recurrent family's verify runs twice: its state (every leaf
        # that is not a K/V entry: conv windows, SSD h, position counters)
        # is copied here before the first pass and back before the second
        # (buffers allocated once)
        self._snapshot: List[tuple] = []
        if self.spec_decode and not model.decode_state.token_addressable:
            self._snapshot = [
                (leaf, torch.empty_like(leaf))
                for leaf, spec in decode_state.state_leaves(
                    self.cache, model.cache_specs())
                if "kv_seq" not in spec]
        self._out_buf = torch.zeros((self._n_out_rows, self.max_len),
                                    dtype=torch.int32, device=self.device)
        self._prev_sampled = torch.zeros((self.n_slots,), dtype=torch.int32,
                                         device=self.device)
        self._seed = seed
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
        # the last executed step's composition (set before its commit;
        # None when the last iteration had no plan), its sampled
        # [(slot, rid)] and the rids admitted into a reset slot
        self.last_plan: Optional[StepPlan] = None
        self.last_sampled_rids: List[tuple] = []
        self.last_admitted_rids: List[int] = []

    @property
    def snapshot_bytes(self) -> int:
        """Bytes of the recurrent state the two-pass verify snapshots (0
        for a token-addressable family or with ``spec_decode`` off)."""
        return sum(b.numel() * b.element_size() for _, b in self._snapshot)

    def _dev(self, a, dtype=None) -> torch.Tensor:
        return torch.as_tensor(np.asarray(a), dtype=dtype,
                               device=self.device)

    def _tune_paged_kernel(self, retune: bool) -> Dict:
        """Pick the paged kernel's KV split count for the pure-decode
        forward via the persistent ``core.autotune`` sweep cache
        (interleaved CUDA-event medians and quartiles; ``retune=True``
        forces re-measurement): ``paged_meta["splits"]``, with
        ``paged_meta["why"]``."""
        cfg = self.model.cfg
        if not self.model.decode_state.paged:
            # no attention KV on the decode path: nothing to tune
            return {"skipped": f"family {cfg.family!r} has no attention "
                               f"KV cache"}
        if self.device.type != "cuda":
            if retune:
                raise RuntimeError(
                    f"retune=True times the paged kernel's split sweep "
                    f"with CUDA events on a CUDA card; this engine is on "
                    f"{self.device}")
            return {"skipped": "no sweep on the CPU: the split sweep "
                               "times the CUDA kernel with CUDA events on "
                               "the card"}
        from repro_torch.core import autotune
        info = autotune.tune_paged_attention(
            n_slots=self.n_slots, max_len=self.max_len,
            page_size=self.kv.page_size, n_kv_heads=cfg.n_kv_heads,
            n_q_heads=cfg.n_heads, head_dim=cfg.resolved_head_dim,
            dtype=cfg.compute_dtype, retune=retune, device=self.device)
        self._paged_splits = int(info["splits"])
        return info

    def _paged_state(self, page_idx, splits: Optional[int] = None
                     ) -> Optional[PagedDecodeState]:
        return (PagedDecodeState(page_idx, self.kv.page_size, splits)
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

    def _decode_inputs(self, plan: StepPlan, width: int):
        """The decode rows' (tokens, positions), the first ``width``
        columns of the plan's: each row's input token is the previous
        step's on-device sample (``token_src``), drafts ride behind it."""
        tokens = self._dev(plan.tokens[:, :width], torch.long)
        token_src = self._dev(plan.token_src, torch.bool)
        tokens[:, 0] = torch.where(token_src, self._prev_sampled.long(),
                                   tokens[:, 0])
        return tokens, self._dev(plan.positions[:, :width], torch.long)

    def _forward_decode(self, tokens, positions, n_valid,
                        splits: Optional[int] = None) -> torch.Tensor:
        logits, self.cache = self.model.forward(
            self.params, tokens, positions, mode="decode", cache=self.cache,
            n_valid=n_valid, paged=self._paged_state(self._page_idx, splits))
        self.stats.forwards += 1
        return logits

    def _decode_step(self, plan: StepPlan) -> None:
        """The plain single-column step (with ``spec_decode`` on, a step
        where no row carries a draft: the no-draft fast path)."""
        tokens, positions = self._decode_inputs(plan, 1)
        logits = self._forward_decode(tokens, positions,
                                      self._dev(plan.n_valid, torch.int32),
                                      splits=self._paged_splits)
        temps = self._dev(plan.temperatures, torch.float32)
        nxt = sampling.sample_tokens(
            logits[:, 0], temps, self._gen,
            any_temp=bool((plan.temperatures > 0).any()))
        sample = [s for s in range(self.n_slots)
                  if plan.out_idx[s] < self.max_len]
        self._commit_samples(nxt, sample, sample,
                             [int(plan.out_idx[s]) for s in sample])

    def _verify_step(self, plan: StepPlan):
        """The draft-verify step: one forward over (n_slots, spec_k + 1)
        columns; column i's argmax is the model's token after the fed
        tokens 0..i (column 0 through the sampler, as the plain step;
        rows at temperature > 0 never carry drafts).  Greedy acceptance
        keeps the longest draft prefix equal to that chain, plus the
        token at its end.  A token-addressable family rewinds its
        position counters to the accepted frontier; a recurrent one
        restores the state snapshot taken before the pass and runs the
        forward again with ``n_valid`` the accepted counts (the masked
        recurrence then commits exactly the accepted prefix).  The
        accepted tokens of the sampled rows are written into their
        output rows and the last of them carried forward, all on the
        device.  Returns the device tensors (n_accept (n_slots,), acc
        (n_slots, spec_k + 1))."""
        S = self.spec_k + 1
        tokens, positions = self._decode_inputs(plan, S)
        n_valid = self._dev(plan.n_valid, torch.int32)
        for leaf, buf in self._snapshot:
            buf.copy_(leaf)
        logits = self._forward_decode(tokens, positions, n_valid)
        acc = torch.argmax(logits, dim=-1).to(torch.int32)       # (n, S)
        acc[:, 0] = sampling.sample_tokens(
            logits[:, 0], self._dev(plan.temperatures, torch.float32),
            self._gen, any_temp=bool((plan.temperatures > 0).any()))
        cols = torch.arange(S, device=self.device)
        # draft i + 1 is accepted iff it was fed and equals committed
        # token i
        match = ((acc[:, :-1].long() == tokens[:, 1:])
                 & (cols[None, :-1] + 1 < n_valid[:, None]))
        n_match = torch.cumprod(match.to(torch.int32), dim=1).sum(dim=1)
        n_accept = torch.where(n_valid > 0, n_match + 1,
                               torch.zeros_like(n_match)).to(torch.int32)
        if self._snapshot:
            for leaf, buf in self._snapshot:
                leaf.copy_(buf)
            self._forward_decode(tokens, positions, n_accept)
        else:
            self.model.adjust_cache_counters(self.cache, n_valid - n_accept)
        slots = [s for s in range(self.n_slots)
                 if plan.token_src[s] and plan.out_idx[s] < self.max_len]
        if slots:
            sl = self._dev(slots, torch.long)
            cols_h = plan.out_idx[slots][:, None] + np.arange(S)[None]
            rows = self._dev(self._slot_row[slots], torch.long)[:, None]
            rows = rows.expand(-1, S)
            # a dropped column's target is (out_idx + c) % max_len, distinct
            # from the row's other columns, and gets its old value back
            wcols = self._dev(cols_h % self.max_len, torch.long)
            keep = ((cols[None] < n_accept[sl][:, None])
                    & self._dev(cols_h < self.max_len, torch.bool))
            old = self._out_buf[rows, wcols]
            self._out_buf.index_put_((rows, wcols),
                                     torch.where(keep, acc[sl], old))
            last = (n_accept[sl] - 1).clamp_min(0).long()[:, None]
            self._prev_sampled.index_put_((sl,),
                                          acc[sl].gather(1, last)[:, 0])
        return n_accept, acc

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

    def _admit(self, plan: StepPlan) -> None:
        """Three-phase (re-)admission of the plan's reset slots: zero the
        cold slots, copy each prefix hit's K/V from its donor slot (a hit
        slot is not zeroed first: the copy writes or zeros every K/V
        entry itself, and the donor may be the same slot), then install
        each request's read-only context (the cross K/V; audio runs its
        encoder here), after the copy.  The scheduler never lets a plan
        claim a donor row, so zeroing before copying destroys none."""
        zero_mask = plan.reset_mask.copy()
        prefix_installs = []
        for slot in np.nonzero(plan.reset_mask)[0]:
            req = self.sched.active.get(int(slot))
            if req is not None and req.prefix_len > 0:
                zero_mask[slot] = False
                prefix_installs.append((int(req.prefix_src), int(slot),
                                        int(req.prefix_len)))
        if zero_mask.any():
            self.model.reset_cache_slots(
                self.cache, self._dev(zero_mask, torch.bool))
        for src, dst, n_tok in prefix_installs:
            self.model.install_cache_prefix(self.cache, src, dst, n_tok)
        for slot in np.nonzero(plan.reset_mask)[0]:
            req = self.sched.active.get(int(slot))
            if req is not None and req.extra:
                self.model.install_slot_context(
                    self.params, self.cache, int(slot), req.extra)

    def step(self) -> bool:
        """Run one engine iteration; False when no work remains."""
        wall_feedback = (self.sched.chunk_policy == "stall_free"
                         and self.step_feedback == "wall")
        if wall_feedback and self.device.type != "cuda":
            raise RuntimeError(
                "chunk_policy='stall_free' sizes its chunks from each "
                "step's time, and nothing is timed off the card: on "
                f"{self.device} serve through OpenLoopFrontend(engine, "
                "clock=\"model\"), which feeds modeled step times")
        plan = (self.sched.next_plan(self._step_idx,
                                     drafts=self._propose_drafts())
                if self.spec_decode
                else self.sched.next_plan(self._step_idx))
        if plan is None:
            self.last_plan = None
            self.last_sampled_rids = []
            self.last_admitted_rids = []
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
            self._admit(plan)
        verify = None
        if plan.n_decode:
            if self.spec_decode and (plan.n_valid > 1).any():
                verify = self._verify_step(plan)
            else:
                self._decode_step(plan)
        for pf in plan.prefills:
            self._prefill_row(pf)
        # which requests sampled a token this step and which were first
        # scheduled, recorded before the commit while the slot -> rid map
        # is live (a slot admitted and preempted within this same plan is
        # in reset_mask but no longer active)
        self.last_plan = plan
        self.last_sampled_rids = [
            (slot, self.sched.active[slot].rid)
            for slot in plan.sample_slots if slot in self.sched.active]
        self.last_admitted_rids = [
            self.sched.active[int(s)].rid
            for s in np.nonzero(plan.reset_mask)[0]
            if int(s) in self.sched.active]
        row_reqs = {slot: self.sched.active[slot]
                    for slot in plan.sample_slots}
        if verify is not None:
            done = self._commit_verify(plan, row_reqs, *verify)
        else:
            # EOS detection is the only per-step host sync of a plain step
            sampled = (self._prev_sampled.cpu().numpy()
                       if self.sched.eos_id is not None else None)
            done = self.sched.commit(plan, sampled, self._step_idx)
            if self.spec_decode:
                self._mark_stale(row_reqs)
        for req in done:
            # tokens stay on device until the next flush point; the row
            # moves from the slot to the pending map
            self._pending.append(req)
            self._pending_rows[req.rid] = int(self._slot_row[req.finish_slot])
            self._slot_row[req.finish_slot] = -1
        fl, by = self._cost.step_cost(plan.n_decode, plan.n_prefill_tokens)
        self.stats.model_flops += fl
        self.stats.model_bytes += by
        _record(self.stats, events, n_decode=plan.n_decode,
                n_prefill_tokens=plan.n_prefill_tokens,
                occupancy=self.kv.occupancy(),
                page_utilization=self.kv.page_utilization(),
                verify=verify is not None)
        if wall_feedback:
            # the stall-free policy's per-token estimate: this step's
            # events, read now (one sync a step)
            self.sched.note_step_wall(
                self.stats.steps[-1].device_ms() / 1e3,
                plan.n_decode + plan.n_prefill_tokens)
        # count only useful tokens: samples a preemption throws away
        # come back off the total
        discarded = self.sched.discarded_tokens - self._seen_discarded
        self._seen_discarded = self.sched.discarded_tokens
        committed = (sum(self.sched.last_commit_counts.values())
                     if self.spec_decode else len(plan.sample_slots))
        self.stats.generated_tokens += committed - discarded
        self.stats.prefix_hit_tokens = self.sched.prefix_hit_tokens
        self._step_idx += 1
        if self.checker is not None:
            self.checker.check_step()
        return self.sched.has_work()

    # -- speculative decoding ------------------------------------------
    def _drafter_throttle(self) -> Dict[str, object]:
        """The drafter's throttle, by family: a recurrent family (ssm,
        hybrid) runs a verify forward twice, so a rejected draft costs it
        about twice what it costs a token-addressable one; it gets a
        higher acceptance floor and sparser probes."""
        if self.model.decode_state.token_addressable:
            return {}
        return dict(accept_floor=0.6, probe_every=32, min_trials=2)

    def _propose_drafts(self) -> Dict[int, np.ndarray]:
        """Drafts for every greedy decoding slot whose request the
        throttle lets propose; a rid left stale by fast-path steps is
        first resynced from ``out_buf`` (a host read of its row)."""
        drafts: Dict[int, np.ndarray] = {}
        for slot, req in self.sched.active.items():
            if (req.state is RequestState.DECODING
                    and req.temperature == 0):
                if self.drafter.throttled(req.rid, self._step_idx):
                    continue
                if req.rid in self._draft_stale:
                    row = int(self._slot_row[slot])
                    toks = self._out_buf[row, :req.n_generated].cpu().numpy()
                    self.drafter.commit(req.rid, req.n_generated, toks)
                    self._draft_stale.discard(req.rid)
                d = self.drafter.propose(req.rid)
                if len(d):
                    drafts[slot] = d
        return drafts

    def _mark_stale(self, row_reqs: Dict[int, Request]) -> None:
        """After a step that read nothing back (the no-draft fast path,
        a prefill-only step; one token a sampled row): drop finished
        requests from the drafter, mark the others' histories stale."""
        for req in row_reqs.values():
            if req.finish_reason:
                self.drafter.drop(req.rid)
                self._draft_stale.discard(req.rid)
            else:
                self._draft_stale.add(req.rid)

    def _commit_verify(self, plan: StepPlan, row_reqs: Dict[int, Request],
                       n_accept: torch.Tensor,
                       acc: torch.Tensor) -> List[Request]:
        """Commit a verify step: one host read of the accepted counts,
        the accepted tokens and ``prev_sampled`` (the drafter needs the
        values; a prefill-completing row's one sample is in
        ``prev_sampled``), the scheduler's variable commit, then the
        drafter's bookkeeping and the draft counters."""
        host = torch.cat([n_accept[:, None], acc,
                          self._prev_sampled[:, None]], dim=1).cpu().numpy()
        n_acc, acc_h, prev = host[:, 0], host[:, 1:-1], host[:, -1]
        accepted = {
            slot: (acc_h[slot, :max(1, int(n_acc[slot]))].copy()
                   if plan.token_src[slot] else prev[slot:slot + 1].copy())
            for slot in plan.sample_slots}
        done = self.sched.commit(
            plan, prev if self.sched.eos_id is not None else None,
            self._step_idx, accepted=accepted)
        drafted = accepted_draft = 0
        for slot in plan.sample_slots:
            req = row_reqs[slot]
            if plan.token_src[slot]:
                d = int(plan.n_valid[slot]) - 1
                a = self.sched.last_commit_counts[slot] - 1
                drafted += d
                accepted_draft += a
                # acceptance feedback drives the drafter's throttle
                self.drafter.feedback(req.rid, d, a)
            if req.finish_reason:
                self.drafter.drop(req.rid)
                self._draft_stale.discard(req.rid)
            elif req.rid not in self._draft_stale:
                # a stale history would get a gap: it stays stale and
                # resyncs in full from out_buf when it next proposes
                self.drafter.commit(req.rid, req.n_generated,
                                    accepted[slot])
        self.stats.drafted_tokens += drafted
        self.stats.accepted_draft_tokens += accepted_draft
        return done

    # -- API ------------------------------------------------------------
    def reset(self) -> None:
        """Clear every piece of serving state (queue, slots, cache,
        output rows, stats, results) but keep the built model, its
        weights and the kernels' call tables, e.g. to run a workload
        again.  The cache and the buffers are zeroed in place and the
        sampler reseeded."""
        self.kv = PagedKVCache(self.n_slots, self.max_len,
                               self.kv.page_size,
                               page_budget=self.kv.page_budget,
                               slot_aux_tokens=self.kv.slot_aux_tokens,
                               prefix_pool=self.kv.prefix_pool)
        self.sched = Scheduler(self.kv,
                               prefill_chunk=self.sched.prefill_chunk,
                               eos_id=self.sched.eos_id,
                               chunk_policy=self.sched.chunk_policy,
                               tbt_target_s=self.sched.tbt_target_s,
                               spec_k=self.spec_k)
        if self.drafter is not None:
            self.drafter = NGramDrafter(self.spec_k,
                                        **self._drafter_throttle())
            self._draft_stale = set()
        if self.check:
            self.checker = SchedChecker.attach(self.kv, self.sched)
        self.model.reset_cache_slots(
            self.cache, torch.ones((self.n_slots,), dtype=torch.bool,
                                   device=self.device))
        self._out_buf.zero_()
        self._prev_sampled.zero_()
        self._gen.manual_seed(self._seed)
        self._free_rows = list(range(self._n_out_rows))
        self._slot_row = np.full((self.n_slots,), -1, np.int32)
        self._pending = []
        self._pending_rows = {}
        self._step_idx = 0
        self._seen_discarded = 0
        self.stats = EngineStats()
        self._results = {}
        self.last_plan = None
        self.last_sampled_rids = []
        self.last_admitted_rids = []

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
        if self.drafter is not None:
            self.drafter.add_request(req.rid, req.prompt)
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
        if self.checker is not None:
            self.checker.check_drain()
        return dict(self._results)

    def results(self) -> Dict[int, np.ndarray]:
        """Flush and return every finished request's tokens so far
        ({rid: np.ndarray}) without a full drain."""
        self._flush_results()
        return dict(self._results)

    def modeled_step_time(self, n_decode: int,
                          n_prefill_tokens: int) -> float:
        """Analytic seconds for one step of this composition: the cost
        model's flops and bytes against ``self.hw``, the larger of
        flops over the peak rate of the model's compute dtype and bytes
        over the memory rate (the roofline bound time).  The open-loop
        front end's ``clock="model"`` advances by it; it is a model
        number, never a measured time."""
        flops, bytes_ = self._cost.step_cost(n_decode, n_prefill_tokens)
        peak = self.hw.peak_flops(dtype_of(self.model.cfg.compute_dtype))
        return max(flops / peak, bytes_ / self.hw.hbm_bw)

    @property
    def check_findings(self) -> List[Finding]:
        """The shadow checker's findings so far ([] when ``check`` is
        off)."""
        return [] if self.checker is None else list(self.checker.findings)

    def requests(self) -> List[Request]:
        return list(self.sched.finished)

    def generate(self, prompt_tokens, n_steps: int,
                 extra: Optional[Dict[str, object]] = None) -> torch.Tensor:
        """Submit a (B, S) batch of prompts greedily, ``n_steps`` new
        tokens each, and drain: the fixed-batch calling convention served
        by the continuous engine.  ``extra`` is the static engine's
        batched (B, T, d) context, split here into one a request.
        Returns (B, n_steps) int32 tokens on the model's device."""
        prompts = _host(prompt_tokens)
        ctx = None if extra is None else {k: _host(v)
                                          for k, v in extra.items()}
        rids = [self.submit(
            p, n_steps,
            extra=None if ctx is None else {k: v[i] for k, v in ctx.items()})
            for i, p in enumerate(prompts)]
        results = self.run()
        return torch.as_tensor(np.stack([results[r] for r in rids]),
                               device=self.device)


def _host(a) -> np.ndarray:
    """A host array of ``a`` (a tensor on any device, or array-like)."""
    if isinstance(a, torch.Tensor):
        return a.detach().cpu().numpy()
    return np.asarray(a)


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
        self._cost = StepCostModel(model.cfg, max_len)
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
        fl, by = self._cost.step_cost(0, B * S)              # prefill
        dfl, dby = self._cost.step_cost(B, 0)                # one decode step
        self.stats.model_flops += fl + (n_steps - 1) * dfl
        self.stats.model_bytes += by + (n_steps - 1) * dby
        self.stats.forwards += n_steps
        self.stats.generated_tokens += B * n_steps
        return torch.stack(out, dim=1)
