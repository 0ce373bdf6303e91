"""Model-free n-gram drafter for speculative decoding (prompt lookup).

The continuous engine's speculative path amortizes the memory-bound
decode sweep over up to ``k`` extra tokens per step — but only when
something can *propose* those tokens for free.  :class:`NGramDrafter`
is the model-free proposer: per request it keeps the token history
(prompt + committed generations) and, each step, looks the history's
own suffix n-gram up in that history ("prompt lookup" drafting, the
draft-model-free scheme of LLMA / prompt-lookup-decoding): the longest
suffix n-gram (``ngram_max`` down to ``ngram_min`` tokens) that recurs
earlier in the history proposes the ``k`` tokens that followed its most
recent earlier occurrence.  Repetitive contexts — structured prompts,
quoting/summarization, and the short greedy cycles temp-0 decoding
falls into — hit long drafts; incompressible contexts propose nothing
and the engine degrades to the ordinary one-token step.

Host-side only (numpy over small per-request lists, no jax): proposals
feed the scheduler's plan composition and the verify forward does all
device work.  The drafter is deliberately stateless about acceptance —
it just mirrors committed tokens:

  * ``add_request(rid, prompt)`` at submit;
  * ``commit(rid, n_generated, tokens)`` after every engine commit.
    The call is **self-healing**: the history is truncated to
    ``prompt_len + (n_generated - len(tokens))`` before appending, so a
    recompute-style preemption (which discards the victim's generated
    tokens and restarts ``n_generated`` at 1 on re-admission) silently
    rewinds the history instead of corrupting it;
  * ``drop(rid)`` on finish.

``propose(rid)`` never raises on an unknown/short history — a cold
start simply drafts nothing (empty array), which the scheduler treats
as an ordinary single-token decode row.
"""
from __future__ import annotations

from typing import Dict, List, Sequence

import numpy as np


class NGramDrafter:
    """Per-request suffix-map proposer over committed tokens + prompt.

    ``k`` is the maximum draft length per proposal; ``ngram_max`` /
    ``ngram_min`` bound the suffix n-gram sizes tried (longest first —
    a longer matched context drafts with higher acceptance).  With
    ``ngram_min=1`` the drafter falls back to a last-token bigram
    lookup, which locks onto period-1/2 greedy cycles immediately.
    """

    def __init__(self, k: int = 4, *, ngram_max: int = 3,
                 ngram_min: int = 1, accept_floor: float = 0.45,
                 probe_every: int = 16, min_trials: int = 4):
        if k < 1:
            raise ValueError(f"draft length k must be >= 1, got {k}")
        if not 1 <= ngram_min <= ngram_max:
            raise ValueError(
                f"need 1 <= ngram_min <= ngram_max, got "
                f"[{ngram_min}, {ngram_max}]")
        self.k = k
        self.ngram_max = ngram_max
        self.ngram_min = ngram_min
        self.accept_floor = float(accept_floor)
        self.probe_every = int(probe_every)
        self.min_trials = int(min_trials)
        self._hist: Dict[int, List[int]] = {}
        self._plen: Dict[int, int] = {}
        # adaptive throttle state: rid -> [accept EMA, n feedbacks,
        # suppressed-opportunity counter since the last probe]
        self._ema: Dict[int, List[float]] = {}

    # -- lifecycle -------------------------------------------------------
    def add_request(self, rid: int, prompt: Sequence[int]) -> None:
        """Register a request's prompt as its initial history."""
        toks = np.asarray(prompt).reshape(-1).tolist()
        self._hist[rid] = [int(t) for t in toks]
        self._plen[rid] = len(toks)

    def commit(self, rid: int, n_generated: int,
               tokens: Sequence[int]) -> None:
        """Mirror one commit: after this call the history holds exactly
        ``prompt + the first n_generated committed tokens``.  Truncating
        to ``prompt_len + n_generated - len(tokens)`` first makes the
        call self-healing across preemptions (generation restarts from
        token 0) and duplicate deliveries."""
        hist = self._hist.get(rid)
        if hist is None:
            return
        tokens = [int(t) for t in np.asarray(tokens).reshape(-1)]
        base = self._plen[rid] + int(n_generated) - len(tokens)
        if base < self._plen[rid]:
            raise ValueError(
                f"rid={rid}: commit of {len(tokens)} token(s) at "
                f"n_generated={n_generated} would truncate into the "
                "prompt")
        del hist[base:]
        hist.extend(tokens)

    def feedback(self, rid: int, drafted: int, accepted: int) -> None:
        """Report one verify outcome (``accepted`` of ``drafted`` draft
        tokens survived).  Drives the adaptive throttle: an EMA of the
        per-step acceptance fraction decides whether this request keeps
        drafting.  A request whose context the model refuses to continue
        (incompressible / non-repeating trajectory) pays the wide verify
        forward for nothing every step — once the EMA sinks below
        ``accept_floor`` the drafter goes quiet for that request and the
        engine's no-draft fast path restores plain-step cost, re-probing
        every ``probe_every`` suppressed steps in case the trajectory
        later falls into a draftable cycle."""
        if drafted <= 0:
            return
        st = self._ema.setdefault(rid, [1.0, 0, 0])
        st[0] = 0.75 * st[0] + 0.25 * (accepted / drafted)
        st[1] += 1

    def throttled(self, rid: int, step: int | None = None) -> bool:
        """True when ``rid`` should stay quiet this step.

        A request whose accept EMA has sunk below ``accept_floor``
        (after at least ``min_trials`` feedbacks) is throttled:
        proposing would only
        widen the verify forward for tokens the model keeps rejecting.
        Throttled requests still probe every ``probe_every``-th step —
        pass the engine's step index so *every* throttled request probes
        on the same step, leaving the steps in between draft-free (the
        engine's no-draft fast path then runs them at plain-step cost);
        without a step index a per-request suppressed-call counter paces
        the probes instead."""
        st = self._ema.get(rid)
        if (st is None or st[1] < self.min_trials
                or st[0] >= self.accept_floor):
            return False
        if step is not None:
            return int(step) % self.probe_every != 0
        st[2] += 1
        return st[2] % self.probe_every != 0

    def drop(self, rid: int) -> None:
        """Forget a finished (or abandoned) request."""
        self._hist.pop(rid, None)
        self._plen.pop(rid, None)
        self._ema.pop(rid, None)

    def history(self, rid: int) -> List[int]:
        """The mirrored history (tests / debugging)."""
        return list(self._hist.get(rid, ()))

    # -- proposal --------------------------------------------------------
    def propose(self, rid: int, k: int | None = None) -> np.ndarray:
        """Draft up to ``k`` continuation tokens for ``rid``.

        Tries suffix n-grams longest-first: the first size whose suffix
        recurs earlier in the history (most recent earlier occurrence
        wins) drafts the tokens that followed that occurrence.  Returns
        an int32 array of length 0..k; unknown rids and cold starts
        draft nothing.
        """
        k = self.k if k is None else int(k)
        hist = self._hist.get(rid)
        if hist is None or k < 1 or len(hist) < self.ngram_min + 1:
            return np.zeros((0,), np.int32)
        arr = np.asarray(hist, np.int64)
        hi = min(self.ngram_max, len(arr) - 1)
        for n in range(hi, self.ngram_min - 1, -1):
            pat = arr[-n:]
            m = len(arr) - n          # starts 0..len-n-1: the suffix's
            if m <= 0:                # own occurrence is excluded and a
                continue              # continuation token always exists
            ok = np.ones(m, bool)
            for j in range(n):
                ok &= arr[j:j + m] == pat[j]
            hits = np.nonzero(ok)[0]
            if len(hits):
                i = int(hits[-1])
                # the continuation window runs from the match into the
                # suffix's own occurrence; a match ``period`` tokens
                # before the suffix only has ``period`` literal tokens
                # available, so extend the draft by extrapolating that
                # period — a period-p greedy cycle then fills all k
                # draft slots instead of capping at p tokens per step
                start, L = i + n, len(arr)
                period = L - n - i
                idx = start + np.arange(k)
                over = idx >= L
                idx[over] = L - period + ((idx[over] - L) % period)
                return arr[idx].astype(np.int32)
        return np.zeros((0,), np.int32)
