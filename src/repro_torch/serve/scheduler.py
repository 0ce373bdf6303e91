"""Request queue + sarathi-style step composition for continuous batching.

The scheduler owns all host-side serving state: the admission queue, the
per-request lifecycle (QUEUED -> PREFILLING -> DECODING -> FINISHED), and
the paged slot bookkeeping (``PagedKVCache``).  Each engine iteration asks
for one ``StepPlan`` — a fixed-shape (n_slots, step_width) token batch
composed of

  * one decode token for every DECODING slot (column 0, ``n_valid = 1``)
    — or, under speculative decoding (``spec_k > 0``), up to ``spec_k``
    drafted continuation tokens riding in columns 1.. (``n_valid`` =
    the fed width, pages reserved up front for all of it),
  * one chunk of at most ``prefill_chunk`` prompt tokens for a single
    PREFILLING slot (``n_valid = chunk``), and
  * ``n_valid = 0`` padding rows for idle slots,

which is the chunked-prefill mixed batch of sarathi-serve: prefills are
sliced into bounded chunks that ride along with the in-flight decodes, so
a long prompt never stalls token emission and the step latency stays
bounded by ``n_slots - 1 + prefill_chunk`` tokens.

Page pressure: admission requires a free slot plus pages for the first
chunk; decode growth that cannot get a page preempts the *youngest*
running request back to the queue front (recompute-style preemption — its
pages are freed and its prefill restarts when re-admitted).

Prefix caching (``PagedKVCache(prefix_pool > 0)``): admission matches
each queued request's longest cached page-aligned prompt prefix and
starts prefill at the matched offset — ``prompt_pos`` skips straight to
``prefix_len`` and the engine installs the donor slot's K/V rows into
the new slot once (``Request.prefix_src`` / ``prefix_len``) instead of
recomputing the prefix chunk-by-chunk.  Release paths (finish *and*
preemption) hand the committed prompt prefix to the pool, which turns
recompute-style preemption into copy-style for cached prefixes: the
re-admitted victim matches its own pages and resumes prefill at the
page-aligned high-water mark.

Slot shards (``PagedKVCache(n_shards > 1)``, the mesh-sharded engine):
every decision that spends pages is **shard-local**.  Admission ranks
shards by longest shard-local prefix match, then most free pages (load
balance), and claims the first that can admit; a blocked decode/prefill
growth preempts the youngest request *of the stalled slot's own shard*
(freeing another shard's pages cannot unblock it); prefix donors are
matched only within the shard, so the engine's donor-row copy never
crosses a device-block boundary.  With one shard this degenerates to
exactly the unsharded policy.
"""
from __future__ import annotations

import dataclasses
import enum
from collections import deque
from typing import Any, Deque, Dict, List, Optional, Sequence, Set

import numpy as np

from repro_torch.serve.cache import PagedKVCache, context_key


class RequestState(enum.Enum):
    QUEUED = "queued"
    PREFILLING = "prefilling"
    DECODING = "decoding"
    FINISHED = "finished"


@dataclasses.dataclass
class Request:
    rid: int
    prompt: np.ndarray                 # (S,) int32
    max_new_tokens: int
    temperature: float = 0.0
    # per-request read-only context (image embeddings / audio frames),
    # installed into the slot's cache row at every (re-)admission
    extra: Optional[Dict[str, Any]] = None
    state: RequestState = RequestState.QUEUED
    slot: Optional[int] = None
    prompt_pos: int = 0                # prompt tokens already committed
    # prefix-cache bookkeeping for the current admission: the engine
    # copies ``prefix_len`` tokens of K/V from donor slot ``prefix_src``
    # into this request's slot instead of resetting + re-prefilling them
    prefix_len: int = 0
    prefix_src: Optional[int] = None
    ctx_key: Optional[bytes] = None    # read-only-context hash (prefix key)
    # boundary hash chain of the prompt, computed once at first admission
    # attempt (a queued request is re-matched every step until it admits)
    prefix_keys: Optional[List[bytes]] = None
    n_generated: int = 0               # tokens sampled so far (count only:
    #                                    values live in the engine's device
    #                                    output buffer until finish)
    generated: List[int] = dataclasses.field(default_factory=list)
    finish_reason: Optional[str] = None
    finish_slot: Optional[int] = None  # slot held when finishing
    # step-clock timestamps (engine steps, for TTFT / latency metrics)
    submit_step: int = -1
    admit_step: int = -1
    first_token_step: int = -1
    finish_step: int = -1
    n_preemptions: int = 0

    @property
    def prompt_len(self) -> int:
        return int(self.prompt.shape[0])

    @property
    def prompt_done(self) -> bool:
        return self.prompt_pos >= self.prompt_len


@dataclasses.dataclass
class PrefillChunk:
    """One slot's bounded prompt chunk, executed as a single-row
    (1, prefill_chunk) forward against that slot's extracted cache row."""
    slot: int
    tokens: np.ndarray                 # (1, prefill_chunk) int32, 0-padded
    positions: np.ndarray              # (1, prefill_chunk) int32
    n_valid: np.ndarray                # (1,) int32 — real tokens in chunk
    temperature: float
    out_idx: int                       # sample destination, or drop
    completes_prompt: bool


@dataclasses.dataclass
class StepPlan:
    """One engine step: a batched (n_slots, 1 + spec_k) decode for every
    in-flight decode, plus bounded single-row prefill chunks.  Row r
    drives slot r in the decode part.  Without speculation the decode
    width is 1; with it, columns 1.. of a decode row hold the drafted
    continuation and ``n_valid`` is the fed width (1 + draft length)."""
    tokens: np.ndarray                 # (n_slots, 1 + spec_k) int32
    n_valid: np.ndarray                # (n_slots,) int32 (0..1 + spec_k)
    positions: np.ndarray              # (n_slots, 1 + spec_k) int32
    temperatures: np.ndarray           # (n_slots,) float32
    reset_mask: np.ndarray             # (n_slots,) bool — recycled this step
    token_src: np.ndarray              # (n_slots,) bool — the input token
    #                                    is the previous step's on-device
    #                                    sample (the host never sees it)
    out_idx: np.ndarray                # (n_slots,) int32 — output-buffer
    #                                    column for this step's sample
    #                                    (out-of-range = discard)
    sample_slots: List[int]            # slots whose sampled token commits
    prefills: List[PrefillChunk]
    n_decode: int

    @property
    def prefill_chunks(self) -> Dict[int, int]:
        return {p.slot: int(p.n_valid[0]) for p in self.prefills}

    @property
    def n_prefill_tokens(self) -> int:
        return sum(int(p.n_valid[0]) for p in self.prefills)


#: valid per-step prefill chunk policies (see ``Scheduler.chunk_policy``)
CHUNK_POLICIES = ("fixed", "stall_free")


class Scheduler:
    def __init__(self, kv: PagedKVCache, *, prefill_chunk: int = 8,
                 eos_id: Optional[int] = None,
                 chunk_policy: str = "fixed",
                 tbt_target_s: Optional[float] = None,
                 spec_k: int = 0):
        if prefill_chunk < 1:
            raise ValueError("prefill_chunk must be >= 1")
        if spec_k < 0:
            raise ValueError(f"spec_k must be >= 0, got {spec_k}")
        if chunk_policy not in CHUNK_POLICIES:
            raise ValueError(
                f"chunk_policy {chunk_policy!r} not in {CHUNK_POLICIES}")
        if chunk_policy == "stall_free" and (tbt_target_s is None
                                             or tbt_target_s <= 0):
            raise ValueError(
                "chunk_policy='stall_free' needs a positive tbt_target_s "
                "(the decode time-between-tokens bound to tune chunks to)")
        self.kv = kv
        self.prefill_chunk = prefill_chunk
        # prefill chunking policy: "fixed" always composes
        # ``prefill_chunk``-token chunks; "stall_free" makes the chunk a
        # per-step decision — sized so the predicted step wall (from the
        # per-token time estimate the engine feeds via note_step_wall)
        # stays under ``tbt_target_s``, so in-flight decodes never see a
        # between-token stall from a riding prefill (sarathi's insight
        # as a measurable knob instead of a constant)
        self.chunk_policy = chunk_policy
        self.tbt_target_s = tbt_target_s
        self._sec_per_token: Optional[float] = None
        self.last_chunk_width = prefill_chunk
        # speculative decode width: decode rows carry up to ``spec_k``
        # drafted tokens after the real input token; the plan reserves
        # pages for the FULL fed width up front (grow before execute), so
        # acceptance can never hit a failing mid-step allocation — the
        # unaccepted tail is returned via ``PagedKVCache.shrink`` at
        # commit.  spec_k == 0 composes the exact unspeculative plan.
        self.spec_k = spec_k
        # slot -> tokens committed by the most recent commit() (1 for
        # every sampled row without speculation); the engine's telemetry
        # and the open-loop frontend's multi-token TBT events read this
        self.last_commit_counts: Dict[int, int] = {}
        self.eos_id = eos_id
        self.queue: Deque[Request] = deque()
        self.active: Dict[int, Request] = {}       # slot -> request
        self.finished: List[Request] = []
        self._admission_order: List[int] = []      # slots, oldest first
        self._next_rid = 0
        # tokens sampled by victims and thrown away by recompute-style
        # preemption (lets the engine report *useful* throughput)
        self.discarded_tokens = 0
        # prompt tokens whose prefill was skipped via the prefix cache
        self.prefix_hit_tokens = 0
        # slots admitted while composing the current plan: their device
        # rows are not valid until the engine executes the plan, so a
        # same-plan preemption must not donate them to the prefix pool
        self._fresh_slots: Set[int] = set()

    # -- intake ---------------------------------------------------------
    @property
    def next_rid(self) -> int:
        """Rid the next submitted request will get (for error naming)."""
        return self._next_rid

    def submit(self, prompt: Sequence[int], max_new_tokens: int, *,
               temperature: float = 0.0, step: int = 0,
               extra: Optional[Dict[str, Any]] = None) -> Request:
        # validate AT SUBMIT, naming the request: a malformed request
        # that only explodes steps later inside plan composition is
        # undebuggable once dozens of requests are in flight
        rid = self._next_rid
        prompt = np.asarray(prompt, np.int32).reshape(-1)
        if prompt.shape[0] == 0:
            raise ValueError(f"request rid={rid}: empty prompt")
        if max_new_tokens < 1:
            raise ValueError(
                f"request rid={rid}: max_new_tokens must be >= 1, "
                f"got {max_new_tokens}")
        if prompt.shape[0] + max_new_tokens > self.kv.max_len:
            raise ValueError(
                f"request rid={rid}: prompt ({prompt.shape[0]}) + "
                f"max_new_tokens ({max_new_tokens}) exceeds max_len "
                f"{self.kv.max_len}")
        req = Request(rid=rid, prompt=prompt,
                      max_new_tokens=max_new_tokens,
                      temperature=temperature, extra=extra,
                      submit_step=step,
                      ctx_key=(context_key(extra)
                               if self.kv.prefix_pool else None))
        if self.kv.prefix_pool:
            # enqueue-time prefix keys: computed once here, so the pool
            # is consultable the moment the request is queued (the
            # open-loop frontend admits at the matched offset the
            # instant a slot frees, without a per-attempt hash pass)
            req.prefix_keys = self.kv.prefix_keys(req.prompt,
                                                  ctx_key=req.ctx_key)
        self._next_rid += 1
        self.queue.append(req)
        return req

    def has_work(self) -> bool:
        return bool(self.queue or self.active)

    # -- composition ----------------------------------------------------
    def _place(self, req: Request, donors_busy: Set[int]):
        """Choose a slot shard for ``req``: rank shards by longest
        shard-local prefix match, then most free pages (load balance),
        then lowest shard id, and return ``(shard, prefix_len, entry,
        first_chunk)`` for the first candidate that can actually admit
        (falling back to a cold admission in the same shard when only
        the donor exclusions / page layout block the prefix path), or
        None when no shard can take the request this step."""
        excl = frozenset(donors_busy)
        order = []
        for shard in range(self.kv.n_shards):
            plen, entry = self.kv.match_prefix(req.prompt,
                                               keys=req.prefix_keys,
                                               shard=shard)
            order.append((-plen, -self.kv.free_pages_in(shard), shard,
                          plen, entry))
        order.sort(key=lambda t: t[:3])
        for _, _, shard, plen, entry in order:
            first_chunk = min(self.prefill_chunk, req.prompt_len - plen)
            if self.kv.can_admit(first_chunk, prefix_len=plen,
                                 prefix_entry=entry, exclude=excl,
                                 shard=shard):
                return shard, plen, entry, first_chunk
            cold_chunk = min(self.prefill_chunk, req.prompt_len)
            if plen and self.kv.can_admit(cold_chunk, exclude=excl,
                                          shard=shard):
                return shard, 0, None, cold_chunk
        return None

    def _admit(self, step: int) -> List[int]:
        """Move queued requests into free slots while slot+page budget
        allows; returns the slots admitted this step (need a cache reset
        or, on a prefix hit, a donor-row copy).

        Prefix matching: the longest cached page-aligned prompt prefix
        skips straight to ``prompt_pos = prefix_len``; the matched pages
        are shared (refcounted) with the pool entry.  Donor slots used by
        this plan are excluded from being claimed until the engine has
        executed the copies (``donors_busy``)."""
        admitted = []
        donors_busy: Set[int] = set()
        while self.queue:
            req = self.queue[0]
            if req.prefix_keys is None and self.kv.prefix_pool:
                # belt-and-braces: submit() computes these at enqueue
                # time; only requests built by hand miss them
                req.prefix_keys = self.kv.prefix_keys(req.prompt,
                                                      ctx_key=req.ctx_key)
            placed = self._place(req, donors_busy)
            if placed is None:
                break
            shard, plen, entry, first_chunk = placed
            self.queue.popleft()
            slot = self.kv.admit(first_chunk, prefix_len=plen,
                                 prefix_entry=entry,
                                 exclude=frozenset(donors_busy),
                                 shard=shard)
            # a match never covers the whole prompt (capped one token
            # short so the completing chunk still produces the logits of
            # generated token #1) -> always at least one chunk to prefill
            req.state = RequestState.PREFILLING
            req.slot = slot
            req.prompt_pos = plen
            req.prefix_len = plen
            req.prefix_src = entry.slot if entry is not None else None
            self.prefix_hit_tokens += plen
            if entry is not None and entry.slot != slot:
                donors_busy.add(entry.slot)
            req.n_generated = 0
            req.generated = []
            req.admit_step = step
            self.active[slot] = req
            self._admission_order.append(slot)
            admitted.append(slot)
        return admitted

    def _preempt_youngest(self, younger_than: Optional[int] = None,
                          shard: Optional[int] = None) -> Optional[int]:
        """Push the most recently admitted request back to the queue front
        (pages freed, prefill restarts on re-admission).  This is
        recompute-style preemption for *every* family's decode state: the
        slot's cache row — attention KV and recurrent conv/SSD state
        alike — is zeroed on re-admission (reset + context re-install)
        and rebuilt by re-prefilling from token 0, so no state snapshot
        ever has to be copied off the device.  Only requests
        admitted *after* ``younger_than`` are candidates — a stalled
        request never evicts its elders (it waits instead), so the oldest
        in-flight request always progresses and the system cannot
        livelock on mutual eviction.  ``shard`` restricts victims to one
        slot shard: pages freed elsewhere cannot unblock a stalled slot
        whose shard owns its own page table."""
        cutoff = (self._admission_order.index(younger_than) + 1
                  if younger_than is not None else 0)
        for slot in reversed(self._admission_order[cutoff:]):
            if shard is not None and self.kv.shard_of(slot) != shard:
                continue
            self._admission_order.remove(slot)
            req = self.active.pop(slot)
            if slot not in self._fresh_slots:
                # copy-style preemption: pool the committed prompt prefix
                # (the slot's device rows stay valid until re-claimed) so
                # re-admission copies instead of recomputing it.  Slots
                # admitted while composing THIS plan have no device state
                # yet — their rows must not be donated.
                self.kv.cache_prefix(slot, req.prompt[:req.prompt_pos],
                                     ctx_key=req.ctx_key)
            else:
                # the admission is torn down before the engine ever ran
                # its donor copy — no prefill was actually skipped, and
                # re-admission will match (and count) again
                self.prefix_hit_tokens -= req.prefix_len
            self.kv.release(slot)
            req.state = RequestState.QUEUED
            req.slot = None
            req.prompt_pos = 0
            req.prefix_len = 0
            req.prefix_src = None
            self.discarded_tokens += req.n_generated
            req.n_generated = 0
            req.generated = []
            req.n_preemptions += 1
            self.queue.appendleft(req)
            return slot
        return None

    # -- stall-free chunk sizing ----------------------------------------
    def note_step_wall(self, wall_s: float, n_tokens: int) -> None:
        """Feed one executed step's wall (or modeled time) and its token
        count into the per-token time estimate the stall-free chunk
        policy sizes against (EWMA; the engine calls this after every
        step, or the open-loop frontend under its deterministic model
        clock)."""
        if n_tokens <= 0 or wall_s <= 0:
            return
        spt = wall_s / n_tokens
        self._sec_per_token = (spt if self._sec_per_token is None
                               else 0.8 * self._sec_per_token + 0.2 * spt)

    @property
    def sec_per_token(self) -> Optional[float]:
        return self._sec_per_token

    def _step_chunk(self, n_decode: int, n_prefilling: int) -> int:
        """This step's prefill chunk width.  ``fixed`` always returns
        ``prefill_chunk``; ``stall_free`` converts the TBT target into a
        per-step token budget (target / est-seconds-per-token), charges
        the in-flight decodes first, splits the rest across the
        prefilling slots, and snaps the width down by halving so the
        compiled prefill shapes stay a tiny power-of-two set.  Never
        returns 0 — prefill always progresses (stall-free, not
        prefill-starving)."""
        if (self.chunk_policy != "stall_free" or not n_prefilling
                or not self._sec_per_token):
            return self.prefill_chunk
        afford = int(self.tbt_target_s / self._sec_per_token) - n_decode
        budget = max(1, afford // n_prefilling)
        w = self.prefill_chunk
        while w > 1 and w > budget:
            w //= 2
        return w

    def next_plan(self, step: int,
                  drafts: Optional[Dict[int, np.ndarray]] = None
                  ) -> Optional[StepPlan]:
        """Compose the next mixed step, or None when nothing is runnable.

        ``drafts`` (speculative decoding, ``spec_k > 0``) maps decode
        slots to proposed continuation tokens; a slot's fed width is
        ``1 + len(draft)`` capped by ``spec_k``, by the tokens the
        request may still commit, and by the page budget.  Pages for the
        full fed width are reserved here, before execution — under page
        pressure the draft degrades to the plain one-token row *before*
        anyone is preempted, so speculation never evicts a request the
        unspeculative scheduler would have kept."""
        reset_slots = set(self._admit(step))
        self._fresh_slots = set(reset_slots)

        # decode rows: ensure each decoding slot can grow by its fed
        # width; on page exhaustion degrade the draft, then preempt the
        # youngest other request (younger slots are dropped before older
        # ones ever stall)
        decode_slots: List[int] = []
        fed: Dict[int, np.ndarray] = {}    # slot -> draft tokens fed
        empty_draft = np.zeros((0,), np.int32)
        for slot in list(self._admission_order):
            req = self.active.get(slot)
            if req is None or req.state is not RequestState.DECODING:
                continue
            draft = empty_draft
            if self.spec_k and drafts and req.temperature == 0:
                d = drafts.get(slot)
                if d is not None:
                    draft = np.asarray(d, np.int32).reshape(-1)
                    # never feed tokens the request cannot commit: the
                    # fed width is bounded by the generation budget and
                    # by the slot's remaining capacity
                    room = min(
                        req.max_new_tokens - req.n_generated,
                        self.kv.max_len
                        - (req.prompt_len + req.n_generated) + 1)
                    draft = draft[:max(0, min(self.spec_k, room - 1))]
            want = 1 + len(draft)
            ok = self.kv.grow(slot, want)
            if not ok and want > 1:
                draft = empty_draft
                want = 1
                ok = self.kv.grow(slot, 1)
            while not ok and self.kv.length(slot) < self.kv.max_len:
                if self._preempt_youngest(
                        younger_than=slot,
                        shard=self.kv.shard_of(slot)) is None:
                    break
                ok = self.kv.grow(slot, 1)
            if ok:
                decode_slots.append(slot)
                fed[slot] = draft
            # else: the request waits this step, slot stays allocated

        # prefill chunks: EVERY prefilling slot advances by up to
        # ``width`` tokens this step.  Each chunk runs as its own
        # single-row forward against the slot's extracted cache row, so a
        # prefill costs its own tokens only — decode rows never pay for a
        # riding chunk's width (the sarathi mixed step, decomposed).
        # Under chunk_policy="stall_free" the width is a per-step decision
        # sized so this step's predicted wall stays under tbt_target_s.
        n_prefilling = sum(
            1 for s in self._admission_order
            if (r := self.active.get(s)) is not None
            and r.state is RequestState.PREFILLING)
        width = self._step_chunk(len(decode_slots), n_prefilling)
        self.last_chunk_width = width
        prefills: List[PrefillChunk] = []
        for slot in list(self._admission_order):
            req = self.active.get(slot)
            if req is None or req.state is not RequestState.PREFILLING:
                continue
            want = min(width, req.prompt_len - req.prompt_pos)
            ok = self.kv.grow(slot, want)
            while not ok:
                # page pressure: preempt the youngest strictly-younger
                # request of this slot's own shard (it may be one of this
                # step's decode rows — drop it there); with none to
                # evict, wait a step
                victim = self._preempt_youngest(
                    younger_than=slot, shard=self.kv.shard_of(slot))
                if victim is None:
                    break
                if victim in decode_slots:
                    decode_slots.remove(victim)
                ok = self.kv.grow(slot, want)
            if not ok:
                continue
            start = req.prompt_pos
            ptokens = np.zeros((1, width), np.int32)
            ptokens[0, :want] = req.prompt[start:start + want]
            completes = start + want >= req.prompt_len
            prefills.append(PrefillChunk(
                slot=slot, tokens=ptokens,
                positions=start + np.arange(width, dtype=np.int32)[None],
                n_valid=np.array([want], np.int32),
                temperature=req.temperature,
                # a prompt-completing chunk's sample is generated token #1
                out_idx=(req.n_generated if completes else self.kv.max_len),
                completes_prompt=completes))

        if not decode_slots and not prefills:
            return None

        n = self.kv.n_slots
        width_s = 1 + self.spec_k
        tokens = np.zeros((n, width_s), np.int32)
        n_valid = np.zeros((n,), np.int32)
        positions = np.zeros((n, width_s), np.int32)
        temps = np.zeros((n,), np.float32)
        reset = np.zeros((n,), bool)
        token_src = np.zeros((n,), bool)
        out_idx = np.full((n,), self.kv.max_len, np.int32)   # default: drop
        sample_slots: List[int] = []

        for slot in reset_slots:
            reset[slot] = True

        for slot in decode_slots:
            req = self.active[slot]
            # the input token is the previous sample for this slot — it
            # lives on device; the engine splices it in (token_src).
            # Draft tokens (if any) ride in columns 1..n_fed-1.
            token_src[slot] = True
            draft = fed[slot]
            n_fed = 1 + len(draft)
            p0 = req.prompt_len + req.n_generated - 1
            positions[slot, :n_fed] = p0 + np.arange(n_fed, dtype=np.int32)
            if n_fed > 1:
                tokens[slot, 1:n_fed] = draft
            n_valid[slot] = n_fed
            temps[slot] = req.temperature
            out_idx[slot] = req.n_generated
            sample_slots.append(slot)

        sample_slots.extend(p.slot for p in prefills if p.completes_prompt)

        return StepPlan(tokens=tokens, n_valid=n_valid, positions=positions,
                        temperatures=temps, reset_mask=reset,
                        token_src=token_src, out_idx=out_idx,
                        sample_slots=sample_slots, prefills=prefills,
                        n_decode=len(decode_slots))

    # -- commit ---------------------------------------------------------
    def commit(self, plan: StepPlan, sampled: Optional[np.ndarray],
               step: int,
               accepted: Optional[Dict[int, np.ndarray]] = None
               ) -> List[Request]:
        """Apply one step's results; returns requests finished this step.

        ``sampled`` (the host copy of this step's samples) is only
        required when EOS detection is on; count-based finishing works
        without ever reading token values (the engine keeps them on
        device until a request completes).

        ``accepted`` (speculative decoding) maps every sampled slot to
        the token values the verify step committed (1..n_fed of them).
        Each decode row commits its accepted count, EOS-truncated, and
        the unaccepted tail of the row's up-front page reserve is
        returned via ``PagedKVCache.shrink``.  A count outside the
        plan's reserve raises loudly — by construction (grow-up-front)
        acceptance can never need a mid-step allocation, so an
        out-of-reserve commit is a scheduler/engine contract violation,
        not a recoverable page fault.
        """
        if accepted is None and self.eos_id is not None and sampled is None:
            raise ValueError("eos_id set but no sampled tokens provided")
        for slot, chunk in plan.prefill_chunks.items():
            req = self.active[slot]
            req.prompt_pos += chunk
            if req.prompt_done:
                req.state = RequestState.DECODING
        done: List[Request] = []
        self.last_commit_counts = {}
        for slot in plan.sample_slots:
            req = self.active[slot]
            if accepted is None:
                n_commit = 1
                eos_hit = (self.eos_id is not None
                           and int(sampled[slot]) == self.eos_id)
            else:
                toks = np.asarray(accepted[slot]).reshape(-1)
                reserve = (int(plan.n_valid[slot]) if plan.token_src[slot]
                           else 1)
                if not 1 <= len(toks) <= reserve:
                    raise RuntimeError(
                        f"slot {slot}: committed {len(toks)} token(s) "
                        f"against a {reserve}-token page reserve — "
                        "acceptance must never outrun the plan's "
                        "up-front grow")
                eos_hit = False
                if self.eos_id is not None:
                    hits = np.nonzero(toks == self.eos_id)[0]
                    if len(hits):
                        toks = toks[:int(hits[0]) + 1]
                        eos_hit = True
                n_commit = len(toks)
            first = req.n_generated == 0
            req.n_generated += n_commit
            if first:
                req.first_token_step = step
            if eos_hit:
                req.finish_reason = "eos"
            elif req.n_generated >= req.max_new_tokens:
                req.finish_reason = "max_new_tokens"
            elif req.prompt_len + req.n_generated >= self.kv.max_len:
                req.finish_reason = "max_len"
            if (accepted is not None and plan.token_src[slot]
                    and not req.finish_reason):
                # hand the unaccepted tail of the reserve back (a
                # finishing slot is released wholesale just below)
                unused = int(plan.n_valid[slot]) - n_commit
                if unused:
                    self.kv.shrink(slot, unused)
            self.last_commit_counts[slot] = n_commit
            if req.finish_reason:
                req.state = RequestState.FINISHED
                req.finish_step = step
                req.finish_slot = slot
                # pool the full prompt's page-aligned prefix before the
                # release drops the slot's page refs: the freed slot's
                # device rows keep the K/V until the slot is re-claimed
                self.kv.cache_prefix(slot, req.prompt, ctx_key=req.ctx_key)
                self.kv.release(slot)
                self.active.pop(slot)
                self._admission_order.remove(slot)
                req.slot = None
                self.finished.append(req)
                done.append(req)
        return done
