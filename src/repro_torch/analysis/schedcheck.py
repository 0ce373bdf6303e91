"""Serve shadow-state checker: every scheduler/page-table transition
replayed against a pure-Python shadow machine.

The paged serving stack keeps three coupled books: the per-shard
``PageTable`` refcounts, the ``PagedKVCache`` slot/prefix-entry maps,
and the ``Scheduler``'s slot->request bindings.  Each is individually
defensive (double release raises), but the *cross*-invariants — every
refcount explained by an owner, no page surviving a drain, no slot bound
to two rids, admission/preemption staying inside the contracts the
ROADMAP pins — are exactly what a refactor breaks silently.

:class:`SchedChecker` attaches to a live engine
(``ContinuousBatchingEngine(check=True)``) by wrapping the bound
methods of its cache/tables/scheduler.  Each wrapped call first replays
the transition on the shadow state (emitting a
:class:`~repro.analysis.findings.Finding` on any illegal move — *before*
the real structure gets a chance to raise or, worse, corrupt), then runs
the real operation.  ``check_step()`` (called by the engine after every
step) and ``check_drain()`` (after a full ``run()``) re-derive the
global invariants from scratch:

* **refcount conservation** — for every shard, every allocated page's
  refcount equals the number of owners holding it (active slots via
  ``SlotInfo.pages``/``aux_pages`` + pooled prefix entries), and the
  shadow refcount map is identical to the table's.
* **leak-free drain** — with no active slots and no pooled entries, all
  tables must be empty; pooled entries may pin pages, but only pages
  they own.
* **slot binding** — ``sched.active`` maps each slot to a request whose
  ``.slot`` points back; no rid appears under two slots, no queued
  request holds a slot.
* **prefix pool** — one entry never claims the same page twice, and an
  entry's pages are refcounted at least once (its own pin).
* **admission/preemption legality** — an admission claims a free,
  non-excluded slot in the requested shard; a preemption victim is
  strictly younger than the stalled request and in the requested shard.

Findings use the ``<schedcheck:...>`` pseudo-path (line 0) so they
travel the same CLI/waiver/report path as every other rule; the rule ids
live in ``repro.analysis.registry.SCHED_RULES``.  Pure Python, no jax —
the checker never touches device state (device rows are the *engine's*
contract; this machine checks the host bookkeeping that addresses them).
"""
from __future__ import annotations

import functools
from typing import Any, Dict, List, Optional, Set

from repro_torch.analysis.findings import Finding
from repro_torch.analysis.registry import SCHED_RULES


class SchedChecker:
    """Shadow state machine over one engine's (kv, sched) pair.

    Use :meth:`attach` on a live ``PagedKVCache`` + ``Scheduler``; the
    event methods (``on_alloc`` / ``on_incref`` / ``on_free`` / ...) are
    also callable directly, which is how the unit tests corrupt a single
    transition and assert the named finding.
    """

    def __init__(self, kv, sched=None):
        self.kv = kv
        self.sched = sched
        self.findings: List[Finding] = []
        # shadow refcounts: one {page: refs} map per shard table
        self.ref: List[Dict[int, int]] = [dict() for _ in kv.tables]
        self.n_events = 0

    # -- reporting -------------------------------------------------------
    def _emit(self, rule: str, message: str, *,
              context: Optional[Dict[str, Any]] = None) -> None:
        sev = SCHED_RULES[rule].severity
        self.findings.append(Finding(
            rule, sev, "<schedcheck:engine>", 0, message, context=context))

    @property
    def error_findings(self) -> List[Finding]:
        return [f for f in self.findings if f.severity == "error"]

    def rows(self) -> List[Dict[str, Any]]:
        return [f.row() for f in self.findings]

    # -- transition events ----------------------------------------------
    def on_alloc(self, shard: int, pages: List[int]) -> None:
        self.n_events += 1
        ref = self.ref[shard]
        for p in pages:
            if ref.get(p, 0) != 0:
                self._emit("refcount-conservation",
                           f"page {p} (shard {shard}) allocated while the "
                           f"shadow still holds {ref[p]} reference(s) — the "
                           "free list handed out a live page",
                           context={"shard": shard, "page": p})
            ref[p] = 1

    def on_incref(self, shard: int, pages: List[int]) -> None:
        self.n_events += 1
        ref = self.ref[shard]
        for p in pages:
            if ref.get(p, 0) <= 0:
                self._emit("prefix-double-claim",
                           f"incref of page {p} (shard {shard}) with no "
                           "live shadow reference — sharing a page nobody "
                           "owns",
                           context={"shard": shard, "page": p})
            ref[p] = ref.get(p, 0) + 1

    def on_free(self, shard: int, pages: List[int]) -> None:
        self.n_events += 1
        ref = self.ref[shard]
        for p in pages:
            if ref.get(p, 0) <= 0:
                self._emit("double-free",
                           f"free of page {p} (shard {shard}) whose shadow "
                           "refcount is already 0 — a double free the cache "
                           "may or may not catch",
                           context={"shard": shard, "page": p})
                ref.pop(p, None)
                continue
            ref[p] -= 1
            if ref[p] == 0:
                del ref[p]

    def on_admit(self, shard: int, slot: int, *,
                 was_free: bool, excluded: bool) -> None:
        self.n_events += 1
        lo = shard * self.kv.slots_per_shard
        if not (lo <= slot < lo + self.kv.slots_per_shard):
            self._emit("illegal-admission",
                       f"admission claimed slot {slot} outside shard "
                       f"{shard}'s block [{lo}, "
                       f"{lo + self.kv.slots_per_shard}) — the donor-copy "
                       "contract requires shard-local placement",
                       context={"shard": shard, "slot": slot})
        if not was_free:
            self._emit("illegal-admission",
                       f"admission claimed slot {slot} while it was still "
                       "active", context={"slot": slot})
        if excluded:
            self._emit("illegal-admission",
                       f"admission claimed slot {slot} excluded as an "
                       "in-flight prefix donor — its device rows are not "
                       "yet copied", context={"slot": slot})

    def on_preempt(self, victim: int, *, younger_than: Optional[int],
                   shard: Optional[int], order: List[int]) -> None:
        """``order`` is the admission order *before* the preemption."""
        self.n_events += 1
        if shard is not None and self.kv.shard_of(victim) != shard:
            self._emit("illegal-preemption",
                       f"preemption victim slot {victim} lives in shard "
                       f"{self.kv.shard_of(victim)}, but the stalled slot "
                       f"needs pages from shard {shard}",
                       context={"victim": victim, "shard": shard})
        if younger_than is not None and younger_than in order \
                and victim in order \
                and order.index(victim) <= order.index(younger_than):
            self._emit("illegal-preemption",
                       f"preemption victim slot {victim} is not strictly "
                       f"younger than stalled slot {younger_than} — elders "
                       "must never be evicted (livelock guard)",
                       context={"victim": victim,
                                "younger_than": younger_than})

    # -- global invariant passes ----------------------------------------
    def _owner_counts(self) -> List[Dict[int, int]]:
        """Expected per-page refcounts from the books: active slots +
        pooled prefix entries, per shard."""
        owners: List[Dict[int, int]] = [dict() for _ in self.kv.tables]
        for slot, info in self.kv.slots.items():
            cnt = owners[self.kv.shard_of(slot)]
            for p in list(info.pages) + list(info.aux_pages):
                cnt[p] = cnt.get(p, 0) + 1
        for shard, lru in enumerate(self.kv._prefix_lru):
            cnt = owners[shard]
            for entry in lru.values():
                seen: Set[int] = set()
                for p in entry.pages:
                    if p in seen:
                        self._emit(
                            "prefix-double-claim",
                            f"prefix entry eid={entry.eid} (shard {shard}) "
                            f"lists page {p} twice",
                            context={"shard": shard, "eid": entry.eid,
                                     "page": p})
                    seen.add(p)
                    cnt[p] = cnt.get(p, 0) + 1
        return owners

    def check_step(self) -> List[Finding]:
        """Full conservation + binding pass; returns NEW findings."""
        before = len(self.findings)
        owners = self._owner_counts()
        for shard, table in enumerate(self.kv.tables):
            actual = dict(table._ref)
            if self.ref[shard] != actual:
                drift = {p: (self.ref[shard].get(p, 0), actual.get(p, 0))
                         for p in set(self.ref[shard]) | set(actual)
                         if self.ref[shard].get(p, 0) != actual.get(p, 0)}
                self._emit(
                    "refcount-conservation",
                    f"shard {shard}: shadow refcounts diverge from the "
                    f"page table on {len(drift)} page(s) "
                    f"(page: shadow vs table) {drift}",
                    context={"shard": shard,
                             "drift": {str(k): list(v)
                                       for k, v in drift.items()}})
            expect = owners[shard]
            if expect != actual:
                drift = {p: (expect.get(p, 0), actual.get(p, 0))
                         for p in set(expect) | set(actual)
                         if expect.get(p, 0) != actual.get(p, 0)}
                leaked = [p for p, (e, a) in drift.items() if a > e]
                over = [p for p, (e, a) in drift.items() if e > a]
                if leaked:
                    self._emit(
                        "refcount-conservation",
                        f"shard {shard}: page(s) {sorted(leaked)} hold more "
                        "references than slot/prefix owners explain — a "
                        "leaked reference that will never free",
                        context={"shard": shard, "pages": sorted(leaked)})
                if over:
                    self._emit(
                        "refcount-conservation",
                        f"shard {shard}: page(s) {sorted(over)} are claimed "
                        "by more owners than their refcount — a future free "
                        "will recycle a page somebody still reads",
                        context={"shard": shard, "pages": sorted(over)})
        if self.sched is not None:
            by_rid: Dict[int, int] = {}
            for slot, req in self.sched.active.items():
                if req.slot != slot:
                    self._emit(
                        "slot-double-bind",
                        f"active map binds slot {slot} to rid {req.rid}, "
                        f"but the request points at slot {req.slot}",
                        context={"slot": slot, "rid": req.rid})
                if req.rid in by_rid:
                    self._emit(
                        "slot-double-bind",
                        f"rid {req.rid} is bound to slots "
                        f"{by_rid[req.rid]} and {slot} at once",
                        context={"rid": req.rid,
                                 "slots": [by_rid[req.rid], slot]})
                by_rid[req.rid] = slot
            for req in self.sched.queue:
                if req.slot is not None:
                    self._emit(
                        "slot-double-bind",
                        f"queued rid {req.rid} still holds slot "
                        f"{req.slot} — a queued request owns no slot",
                        context={"rid": req.rid, "slot": req.slot})
        return self.findings[before:]

    def check_drain(self) -> List[Finding]:
        """Post-drain pass: with no active work, only pooled prefix
        entries may pin pages; everything else is a leak."""
        before = len(self.findings)
        self.check_step()
        if self.sched is not None and (self.sched.active
                                       or self.sched.queue):
            return self.findings[before:]       # not actually drained
        owners = self._owner_counts()
        for shard, table in enumerate(self.kv.tables):
            orphans = sorted(p for p in table._ref if p not in owners[shard])
            if orphans:
                self._emit(
                    "page-leak",
                    f"shard {shard}: page(s) {orphans} still allocated "
                    "after a full drain with no slot or prefix entry "
                    "owning them",
                    context={"shard": shard, "pages": orphans})
            if not self.kv._prefix_lru[shard] and not self.kv.slots \
                    and table.n_used:
                self._emit(
                    "page-leak",
                    f"shard {shard}: {table.n_used} page(s) allocated "
                    "after a drain with an empty prefix pool — nothing "
                    "can ever free them",
                    context={"shard": shard, "n_used": table.n_used})
        return self.findings[before:]

    # -- live attachment -------------------------------------------------
    @classmethod
    def attach(cls, kv, sched) -> "SchedChecker":
        """Wrap the (kv, sched) pair's mutating methods so every
        transition replays through a new checker; returns it."""
        chk = cls(kv, sched)

        for shard, table in enumerate(kv.tables):
            chk._wrap_table(shard, table)

        real_admit = kv.admit

        @functools.wraps(real_admit)
        def admit(first_chunk, *, exclude=frozenset(), shard=0, **kw):
            free_before = set(kv.free_slots_in(shard))
            slot = real_admit(first_chunk, exclude=exclude, shard=shard,
                              **kw)
            chk.on_admit(shard, slot, was_free=slot in free_before,
                         excluded=slot in exclude)
            return slot

        kv.admit = admit

        real_preempt = sched._preempt_youngest

        @functools.wraps(real_preempt)
        def preempt(younger_than=None, shard=None):
            order = list(sched._admission_order)
            victim = real_preempt(younger_than=younger_than, shard=shard)
            if victim is not None:
                chk.on_preempt(victim, younger_than=younger_than,
                               shard=shard, order=order)
            return victim

        sched._preempt_youngest = preempt
        return chk

    def _wrap_table(self, shard: int, table) -> None:
        real_alloc, real_incref, real_free = (
            table.alloc, table.incref, table.free)

        @functools.wraps(real_alloc)
        def alloc(n):
            pages = real_alloc(n)
            self.on_alloc(shard, pages)
            return pages

        @functools.wraps(real_incref)
        def incref(pages):
            pages = list(pages)
            # shadow first: the checker must flag the bad transition even
            # when the table itself is about to raise
            self.on_incref(shard, pages)
            return real_incref(pages)

        @functools.wraps(real_free)
        def free(pages):
            pages = list(pages)
            self.on_free(shard, pages)
            return real_free(pages)

        table.alloc, table.incref, table.free = alloc, incref, free
