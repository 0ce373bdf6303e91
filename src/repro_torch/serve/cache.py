"""Paged/slotted KV-cache bookkeeping for the continuous-batching engine.

Host-side only — no jax imports.  The device-side KV tensors are the
model's batched cache (``LM.init_cache(n_slots, max_len)``); this module
manages the two resources layered on top of it, in the style of the
paged-KV runners (vLLM / sarathi block managers, hyadmin page tables):

  * **slots** — batch rows of the fixed-shape jitted step.  A request owns
    one slot from admission until it finishes (EOS / max-len) or is
    preempted; the slot is then recycled for the next queued request.
  * **pages** — fixed-size chunks of KV capacity.  Each slot's pages are
    allocated lazily as its sequence grows (prompt chunks commit, decode
    tokens append) and freed together on release.  The page budget may be
    smaller than ``n_slots * pages_per_slot`` (oversubscription), in which
    case admission and decode growth can fail -> the scheduler reacts by
    queueing / preempting.

``PageTable`` is the **refcounted** free-list: a page is handed out with
refcount 1, extra owners take refs via ``incref``, and ``free`` drops one
ref — the page returns to the free list only at zero.  Refs > 1 arise
from **prefix sharing**: a request admitted against a cached prefix
shares the prefix pages with the cache entry (and with any other request
sharing the same prefix) instead of allocating its own.

``PagedKVCache`` adds the per-slot view (page lists, committed lengths),
the occupancy metrics the engine reports, and the **prefix cache**:

  * keys are a page-aligned rolling hash of prompt-token chunks
    (sha256 chained per ``page_size`` tokens, seeded with the request's
    read-only-context hash so vlm/audio prefixes never match across
    different image/audio contexts);
  * when a request releases its slot, the page-aligned prefix of its
    *prompt* pages moves into a bounded LRU pool (``prefix_pool``
    entries) instead of being freed — the donor slot's device rows keep
    the K/V until the slot is next claimed;
  * admission matches the longest cached page-aligned prefix and shares
    those pages (incref); the engine copies the donor slot's K/V rows
    into the new slot once, instead of recomputing the prefix
    chunk-by-chunk;
  * pooled pages are reclaimed (LRU-first eviction) the moment a real
    allocation would otherwise fail, so the pool only ever uses spare
    capacity and never blocks admission or decode growth.

**Slot shards** (``n_shards > 1``): when the serving engine shards the
slot ("batch") axis over a device mesh, the page budget and the prefix
pool partition with it.  Slots split into ``n_shards`` contiguous blocks
(matching ``NamedSharding``'s contiguous block layout of the batch
axis), each shard owns its own :class:`PageTable` (``budget /
n_shards`` pages) and its own prefix-pool LRU, and every operation that
names a slot (grow / release / cache_prefix) stays inside that slot's
shard.  Admission and prefix matching take an explicit ``shard``; a
donor row and the slot admitted against it therefore always live on the
same device block, so the engine's prefix copy never crosses a shard
boundary.  ``n_shards=1`` (the default) is bit-for-bit the unsharded
behavior.
"""
from __future__ import annotations

import dataclasses
import hashlib
from collections import OrderedDict
from typing import Dict, Iterable, List, Optional, Sequence

import numpy as np


class PageTable:
    """Fixed-size refcounted page free-list (ids ``0..n_pages-1``).

    ``alloc`` hands out pages with refcount 1; ``incref`` adds an owner
    (prefix sharing); ``free`` drops one ref and recycles the page at
    zero.  Releasing a page that is not allocated is a real bookkeeping
    hazard (double release) and fails loudly.
    """

    def __init__(self, n_pages: int, page_size: int):
        if n_pages <= 0 or page_size <= 0:
            raise ValueError("n_pages and page_size must be positive")
        self.n_pages = n_pages
        self.page_size = page_size
        self._free: List[int] = list(range(n_pages - 1, -1, -1))
        self._ref: Dict[int, int] = {}

    @property
    def n_free(self) -> int:
        return len(self._free)

    @property
    def n_used(self) -> int:
        return len(self._ref)

    def refcount(self, page: int) -> int:
        return self._ref.get(page, 0)

    def pages_for(self, n_tokens: int) -> int:
        """Pages needed to hold ``n_tokens`` tokens."""
        return -(-n_tokens // self.page_size)

    def can_alloc(self, n: int) -> bool:
        return n <= self.n_free

    def alloc(self, n: int) -> List[int]:
        if not self.can_alloc(n):
            raise RuntimeError(
                f"page table exhausted: want {n}, free {self.n_free}")
        pages = [self._free.pop() for _ in range(n)]
        for p in pages:
            self._ref[p] = 1
        return pages

    def incref(self, pages: Iterable[int]) -> None:
        """Add an owner to already-allocated pages (prefix sharing)."""
        for p in pages:
            if p not in self._ref:
                raise RuntimeError(
                    f"incref of page {p} which is not allocated")
            self._ref[p] += 1

    def free(self, pages: Iterable[int]) -> None:
        """Drop one reference per page; recycle pages reaching zero."""
        for p in pages:
            ref = self._ref.get(p)
            if ref is None:
                raise RuntimeError(
                    f"double release: page {p} is not allocated")
            if ref == 1:
                del self._ref[p]
                self._free.append(p)
            else:
                self._ref[p] = ref - 1


@dataclasses.dataclass
class SlotInfo:
    pages: List[int]
    length: int                 # committed tokens (prompt written + generated)
    aux_pages: List[int] = dataclasses.field(default_factory=list)


@dataclasses.dataclass
class PrefixEntry:
    """One pooled prefix: ``length`` prompt tokens whose K/V live in the
    (free) donor ``slot``'s device rows, pinned through ``pages``."""
    eid: int
    slot: int
    length: int                 # page-aligned token count
    pages: List[int]            # one ref held by the entry
    keys: List[bytes]           # rolling-hash key per page boundary


def context_key(extra: Optional[Dict[str, np.ndarray]]) -> Optional[bytes]:
    """Hash a request's read-only context (image embeds / audio frames)
    into the prefix-key seed: prompt K/V of cross-attention families
    depends on the context, so prefixes only match when it is identical."""
    if not extra:
        return None
    h = hashlib.sha256()
    for name in sorted(extra):
        arr = np.ascontiguousarray(extra[name])
        h.update(name.encode())
        h.update(str(arr.shape).encode() + str(arr.dtype).encode())
        h.update(arr.tobytes())
    return h.digest()


class PagedKVCache:
    """Slot pool + page accounting over a ``(n_slots, max_len)`` KV cache.

    ``page_budget`` defaults to full backing (``n_slots * pages_per_slot``
    plus per-slot aux pages; admission never blocks on pages); pass a
    smaller budget to model memory-constrained serving where the
    scheduler must queue or preempt.

    ``slot_aux_tokens`` accounts the per-slot *auxiliary* decode state of
    the DecodeState protocol — the read-only cross-attention context
    (image tokens / audio frames) a vlm/audio request installs at
    admission.  Aux pages are reserved for the slot's whole lifetime
    (they never grow with the sequence) and are released with the slot,
    so an oversubscribed budget sees the true per-request footprint.

    ``prefix_pool`` > 0 enables the prefix cache: up to that many
    released prefix entries are retained (LRU, per shard) for
    page-aligned prompt reuse; 0 (the default) disables it entirely.

    ``n_shards`` > 1 partitions slots, page budget, and prefix pool into
    contiguous slot-shard blocks (see module docstring); both must
    divide evenly so every shard is identical.
    """

    def __init__(self, n_slots: int, max_len: int, page_size: int = 16,
                 page_budget: Optional[int] = None,
                 slot_aux_tokens: int = 0,
                 prefix_pool: int = 0,
                 n_shards: int = 1):
        if max_len % page_size:
            raise ValueError(
                f"max_len {max_len} must be a multiple of page_size "
                f"{page_size}")
        if n_shards < 1 or n_slots % n_shards:
            raise ValueError(
                f"n_slots {n_slots} must split evenly over n_shards "
                f"{n_shards} (the slot axis shards into equal blocks)")
        self.n_slots = n_slots
        self.n_shards = n_shards
        self.slots_per_shard = n_slots // n_shards
        self.max_len = max_len
        self.page_size = page_size
        self.pages_per_slot = max_len // page_size
        self.slot_aux_tokens = slot_aux_tokens
        self.aux_pages_per_slot = -(-slot_aux_tokens // page_size)
        budget = (n_slots * (self.pages_per_slot + self.aux_pages_per_slot)
                  if page_budget is None else page_budget)
        if budget % n_shards:
            raise ValueError(
                f"page_budget {budget} must split evenly over n_shards "
                f"{n_shards} (each slot shard owns its own page table)")
        self.tables: List[PageTable] = [
            PageTable(budget // n_shards, page_size) for _ in range(n_shards)]
        self.slots: Dict[int, SlotInfo] = {}
        # -- prefix cache (one pool per shard) ---------------------------
        self.prefix_pool = prefix_pool
        self._prefix_lru: List["OrderedDict[int, PrefixEntry]"] = [
            OrderedDict() for _ in range(n_shards)]
        self._prefix_index: List[Dict[bytes, int]] = [
            {} for _ in range(n_shards)]              # boundary hash -> eid
        self._slot_entries: Dict[int, set] = {}       # donor slot -> {eid}
        self._next_eid = 0
        self.prefix_evictions = 0

    # -- page-index array (paged flash-decode kernel contract) -----------
    def page_index_array(self) -> np.ndarray:
        """(n_slots, pages_per_slot) int32 page ids for the fused paged
        decode kernel (``kernels/paged_attention``).

        The device KV cache is the model's dense (n_slots, max_len, ...)
        batched cache; viewed as a page pool of
        ``n_slots * pages_per_slot`` chunks of ``page_size`` tokens, slot
        ``s`` physically owns pool pages ``s*pages_per_slot + j`` — the
        *identity* layout.  The logical ``PageTable`` ids above manage
        budget/refcounts only; they never relocate device rows, so the
        kernel's page-index array is this fixed identity map (which also
        licenses the XLA impl's zero-gather reshape view).  The engine
        uploads it once as a device array and threads it through
        ``decode_step``.
        """
        return np.arange(self.n_slots * self.pages_per_slot,
                         dtype=np.int32).reshape(self.n_slots,
                                                 self.pages_per_slot)

    # -- shards ----------------------------------------------------------
    def shard_of(self, slot: int) -> int:
        """Slot-shard owning ``slot`` (contiguous blocks, matching the
        device layout of a NamedSharding over the batch axis)."""
        return slot // self.slots_per_shard

    @property
    def table(self) -> PageTable:
        """Shard 0's page table — the whole table when ``n_shards == 1``
        (the common case and the unsharded engines' view)."""
        return self.tables[0]

    @property
    def page_budget(self) -> int:
        """Total pages across every shard's table."""
        return sum(t.n_pages for t in self.tables)

    def free_pages_in(self, shard: int) -> int:
        return self.tables[shard].n_free

    def free_slots_in(self, shard: int) -> List[int]:
        lo = shard * self.slots_per_shard
        return [s for s in range(lo, lo + self.slots_per_shard)
                if s not in self.slots]

    # -- slots ----------------------------------------------------------
    @property
    def free_slots(self) -> List[int]:
        return [s for s in range(self.n_slots) if s not in self.slots]

    @property
    def n_active(self) -> int:
        return len(self.slots)

    def occupancy(self) -> float:
        """Fraction of slots currently owned by a request."""
        return self.n_active / self.n_slots

    def page_utilization(self) -> float:
        return (sum(t.n_used for t in self.tables)
                / sum(t.n_pages for t in self.tables))

    # -- prefix cache ----------------------------------------------------
    @property
    def n_prefix_entries(self) -> int:
        return sum(len(lru) for lru in self._prefix_lru)

    @property
    def prefix_pages(self) -> int:
        """Pages currently pinned by pooled prefix entries (summed over
        shards; page ids are per-shard, so distinctness is per shard)."""
        return sum(len({p for e in lru.values() for p in e.pages})
                   for lru in self._prefix_lru)

    def _hash_chain(self, tokens: Sequence[int],
                    ctx_key: Optional[bytes]) -> List[bytes]:
        """Rolling hash of ``tokens`` checkpointed at page boundaries:
        one key per *full* page, chained so key i commits tokens
        ``[0, (i+1)*page_size)`` plus the context seed."""
        toks = np.asarray(tokens, np.int64)
        h = hashlib.sha256(b"prefix\0" + (ctx_key or b"")).digest()
        keys: List[bytes] = []
        p = self.page_size
        for i in range(len(toks) // p):
            h = hashlib.sha256(h + toks[i * p:(i + 1) * p].tobytes()).digest()
            keys.append(h)
        return keys

    def prefix_keys(self, prompt: Sequence[int],
                    ctx_key: Optional[bytes] = None) -> List[bytes]:
        """The prompt's matchable boundary keys — capped one page-aligned
        boundary below the full prompt, so at least one token is always
        re-prefilled and the completing chunk produces the first sample's
        logits.  Pure in (prompt, ctx_key, page_size): callers admitting
        repeatedly (a queued request retried every step) should compute
        once and pass the result to :meth:`match_prefix`."""
        n_keys = (len(prompt) - 1) // self.page_size
        return self._hash_chain(
            np.asarray(prompt)[:n_keys * self.page_size], ctx_key)

    def match_prefix(self, prompt: Sequence[int],
                     ctx_key: Optional[bytes] = None,
                     keys: Optional[List[bytes]] = None,
                     shard: int = 0) -> tuple[int, Optional[PrefixEntry]]:
        """Longest page-aligned prefix of ``prompt`` cached in ``shard``'s
        pool (donor rows of other shards live on other devices, so only
        shard-local entries are usable).  Read-only: the LRU touch
        happens when an admission actually consumes the entry
        (``admit``), not on every blocked attempt."""
        if not self.prefix_pool or not self._prefix_lru[shard]:
            return 0, None
        if keys is None:
            keys = self.prefix_keys(prompt, ctx_key)
        for i in range(len(keys), 0, -1):
            eid = self._prefix_index[shard].get(keys[i - 1])
            if eid is not None:
                return i * self.page_size, self._prefix_lru[shard][eid]
        return 0, None

    def cache_prefix(self, slot: int, tokens: Sequence[int],
                     ctx_key: Optional[bytes] = None) -> Optional[PrefixEntry]:
        """Retain the page-aligned prefix of an active slot's committed
        prompt ``tokens`` in the slot's shard pool.  Call *before*
        ``release``: the entry takes its own reference on the prefix
        pages, so the subsequent release leaves them pinned."""
        if not self.prefix_pool:
            return None
        n_pages = len(tokens) // self.page_size
        if n_pages == 0:
            return None
        shard = self.shard_of(slot)
        lru, index = self._prefix_lru[shard], self._prefix_index[shard]
        length = n_pages * self.page_size
        keys = self._hash_chain(np.asarray(tokens)[:length], ctx_key)
        if keys[-1] in index:                              # exact duplicate
            lru.move_to_end(index[keys[-1]])
            return None
        info = self.slots[slot]
        pages = list(info.pages[:n_pages])
        self.tables[shard].incref(pages)
        eid = self._next_eid
        self._next_eid += 1
        entry = PrefixEntry(eid=eid, slot=slot, length=length,
                            pages=pages, keys=keys)
        lru[eid] = entry
        shadowed = set()
        for k in keys:
            prev = index.get(k)
            if prev is not None:
                shadowed.add(prev)
            index[k] = eid                                 # newest wins
        self._slot_entries.setdefault(slot, set()).add(eid)
        # an older entry whose every key now resolves to the new superset
        # entry can never match again — evict it eagerly rather than let
        # it pin pages and a pool slot until it ages out of the LRU
        for prev in shadowed:
            old = lru.get(prev)
            if old is not None and not any(
                    index.get(k) == prev for k in old.keys):
                self._evict(prev, shard)
        while len(lru) > self.prefix_pool:
            self._evict_lru(shard)
        return entry

    def _evict(self, eid: int, shard: int) -> None:
        entry = self._prefix_lru[shard].pop(eid)
        self.tables[shard].free(entry.pages)
        for k in entry.keys:
            if self._prefix_index[shard].get(k) == eid:
                del self._prefix_index[shard][k]
        owners = self._slot_entries.get(entry.slot)
        if owners is not None:
            owners.discard(eid)
            if not owners:
                del self._slot_entries[entry.slot]
        self.prefix_evictions += 1

    def _evict_lru(self, shard: int) -> None:
        self._evict(next(iter(self._prefix_lru[shard])), shard)

    def _reclaim(self, need: int, keep: frozenset = frozenset(),
                 shard: int = 0) -> None:
        """Evict ``shard``'s pooled prefixes (LRU-first) until ``need``
        pages can be allocated — the pool uses spare capacity only and
        never starves a real allocation.  Eviction only happens when it
        can actually enable the allocation: pages shared with active
        slots are not recoverable (freeing the pool ref leaves them
        pinned), so if ``need`` exceeds free + recoverable pages, nothing
        is evicted and the hit potential survives the failed attempt.
        Pages shared only *between* pooled entries are recovered by
        cascading evictions."""
        table, lru = self.tables[shard], self._prefix_lru[shard]
        while not table.can_alloc(need):
            pooled_refs: Dict[int, int] = {}
            for eid, entry in lru.items():
                if eid in keep:
                    continue
                for p in entry.pages:
                    pooled_refs[p] = pooled_refs.get(p, 0) + 1
            recoverable = {p for p, r in pooled_refs.items()
                           if r == table.refcount(p)}
            if table.n_free + len(recoverable) < need:
                return
            victim = next(eid for eid, e in lru.items()
                          if eid not in keep
                          and any(p in recoverable for p in e.pages))
            self._evict(victim, shard)

    def clear_prefix_cache(self) -> None:
        """Drop every pooled entry (frees all entry-held page refs)."""
        for shard, lru in enumerate(self._prefix_lru):
            for eid in list(lru):
                self._evict(eid, shard)

    # -- lifecycle ------------------------------------------------------
    def can_admit(self, first_chunk: int, *, prefix_len: int = 0,
                  prefix_entry: Optional[PrefixEntry] = None,
                  exclude: frozenset = frozenset(),
                  shard: int = 0) -> bool:
        """True when a request could be admitted into ``shard`` now —
        with ``first_chunk`` fresh prompt tokens on top of an optional
        ``prefix_len``-token shared prefix.  Reclaims the shard's pooled
        pages as needed (never the entry being matched); ``exclude``
        removes slots from consideration (in-flight prefix donors whose
        device rows must stay intact)."""
        table = self.tables[shard]
        shared = 0 if prefix_entry is None else prefix_len // self.page_size
        need = (table.pages_for(prefix_len + first_chunk) - shared
                + self.aux_pages_per_slot)
        if not [s for s in self.free_slots_in(shard) if s not in exclude]:
            return False
        keep = (frozenset() if prefix_entry is None
                else frozenset((prefix_entry.eid,)))
        self._reclaim(need, keep, shard)
        return table.can_alloc(need)

    def admit(self, first_chunk: int, *, prefix_len: int = 0,
              prefix_entry: Optional[PrefixEntry] = None,
              exclude: frozenset = frozenset(),
              shard: int = 0) -> int:
        """Claim a free slot in ``shard`` with pages for the first prompt
        chunk plus the slot's lifetime aux-state (context) pages.

        With a prefix match, the entry's pages covering ``prefix_len``
        tokens are *shared* (incref) rather than allocated, and the slot
        starts with ``prefix_len`` committed tokens.  The matched entry
        must live in the same shard (its donor row is device-local to
        the shard's slot block).  The chunk + aux pages come from one
        combined allocation, so a failed admission can never leak the
        chunk pages when the aux tail does not fit.
        """
        if not self.can_admit(first_chunk, prefix_len=prefix_len,
                              prefix_entry=prefix_entry, exclude=exclude,
                              shard=shard):
            raise RuntimeError("no free slot / pages for admission")
        table, lru = self.tables[shard], self._prefix_lru[shard]
        free = [s for s in self.free_slots_in(shard) if s not in exclude]
        # prefer a slot not holding pooled prefix rows; else reuse the
        # matched donor in place (evicts only the entry being consumed);
        # else claim the slot whose entries we must drop anyway
        clean = [s for s in free if not self._slot_entries.get(s)]
        if clean:
            slot = clean[0]
        elif prefix_entry is not None and prefix_entry.slot in free:
            slot = prefix_entry.slot
        else:
            slot = free[0]
        shared = ([] if prefix_entry is None
                  else list(prefix_entry.pages[:prefix_len // self.page_size]))
        # take our reference on the shared pages BEFORE evicting the
        # entries on the claimed slot (the matched entry may live there)
        table.incref(shared)
        if prefix_entry is not None and prefix_entry.eid in lru:
            lru.move_to_end(prefix_entry.eid)  # LRU touch on use
        for eid in list(self._slot_entries.get(slot, ())):
            self._evict(eid, shard)            # claimed slot rows are dead
        need = (table.pages_for(prefix_len + first_chunk) - len(shared)
                + self.aux_pages_per_slot)
        newly = table.alloc(need)              # atomic: chunk + aux together
        split = need - self.aux_pages_per_slot
        self.slots[slot] = SlotInfo(pages=shared + newly[:split],
                                    length=prefix_len,
                                    aux_pages=newly[split:])
        return slot

    def grow(self, slot: int, n_tokens: int) -> bool:
        """Commit ``n_tokens`` more tokens to ``slot``, allocating pages
        from the slot's shard as the sequence crosses page boundaries.
        Returns False (state unchanged) if the page budget or slot
        capacity cannot cover it."""
        info = self.slots[slot]
        shard = self.shard_of(slot)
        table = self.tables[shard]
        new_len = info.length + n_tokens
        if new_len > self.max_len:
            return False
        need = table.pages_for(new_len) - len(info.pages)
        if need > 0:
            self._reclaim(need, shard=shard)
            if not table.can_alloc(need):
                return False
            info.pages.extend(table.alloc(need))
        info.length = new_len
        return True

    def shrink(self, slot: int, n_tokens: int) -> None:
        """Un-commit the last ``n_tokens`` tokens of ``slot``, freeing
        tail pages that fall empty.  This is the speculative-decode
        reserve release: a verify step grows the slot by the full fed
        width up front (so no allocation can fail mid-step), then
        shrinks back to the accepted frontier after acceptance.  The
        caller must only shrink tokens it grew this step — never into
        prefix-shared prompt pages — which the scheduler guarantees by
        bounding the shrink by the step's own reserve."""
        if n_tokens == 0:
            return
        info = self.slots[slot]
        if n_tokens < 0 or n_tokens > info.length:
            raise RuntimeError(
                f"slot {slot}: cannot shrink {n_tokens} token(s) out of "
                f"{info.length}")
        table = self.tables[self.shard_of(slot)]
        new_len = info.length - n_tokens
        keep = table.pages_for(new_len)
        if keep < len(info.pages):
            table.free(info.pages[keep:])
            del info.pages[keep:]
        info.length = new_len

    def release(self, slot: int) -> None:
        """Free the slot and drop its page references (aux included);
        pages shared with pooled prefixes or other slots stay allocated."""
        info = self.slots.pop(slot, None)
        if info is None:
            raise RuntimeError(
                f"double release: slot {slot} is not active")
        table = self.tables[self.shard_of(slot)]
        table.free(info.pages)
        table.free(info.aux_pages)

    def length(self, slot: int) -> int:
        return self.slots[slot].length
