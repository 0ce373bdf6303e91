"""The port's speculative decoding against the reference, on the CPU.

- ``repro_torch.serve.draft.NGramDrafter`` (a copy) against the
  original on tests/test_serve_spec.py's drafter cases and on random
  histories: the same proposals, histories and throttle decisions;
- temperature-0 tokens of the port's engine with ``spec_decode=True,
  spec_k=4`` equal its tokens with it off and the JAX speculative
  engine's, for the five families of tests/test_serve_spec.py, on its
  mix (a preemption, a mid-run admission), with drafts forced on every
  greedy decode row so that the verify path runs on every family;
- the recurrent families' two-pass verify: after a step whose draft is
  rejected, the state (conv windows, SSD ``h``) equals the JAX
  two-pass's;
- an engine with speculative decoding off builds no drafter.

Reduced fp32 configs, the JAX tree carried over by ``params_from_numpy``
(every ``gate_attn`` 0.5, since at its zero init the context does not
matter).  Every port engine here runs under the port's shadow-state
checker (``_DEFAULT_CHECK``), the JAX engines with ``check=True``; both
must end with no error finding.
"""
import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from repro.configs import reduced_config as jax_reduced_config
from repro.models import build_model as jax_build_model
from repro.models.decode_state import stub_context
from repro.serve import ContinuousBatchingEngine as JaxEngine
from repro.serve.draft import NGramDrafter as JaxDrafter
from repro_torch.configs import reduced_config
from repro_torch.models.model import LM
from repro_torch.serve.draft import NGramDrafter
from repro_torch.serve.engine import ContinuousBatchingEngine
from repro_torch.weights import params_from_numpy

FAMILY_ARCHS = [
    ("lm", "granite-3-2b"),
    ("ssm", "mamba2-780m"),
    ("hybrid", "jamba-v0.1-52b"),
    ("vlm", "llama-3.2-vision-90b"),
    ("audio", "whisper-base"),
]
PAGE = 8
GATE = 0.5
TOL = dict(rtol=1e-4, atol=1e-4)
# tests/test_serve_spec.py's mix: two page-crossing requests under a
# tight budget (a preemption) and a mid-run admission; the first prompt
# is motif-tiled so the n-gram drafter proposes on its own
REQUESTS = [(15, 6), (15, 5), (7, 6)]


@pytest.fixture(autouse=True)
def port_shadow_checker(monkeypatch):
    """Every port engine built in a test runs with ``check=True``; at
    teardown none may hold an error finding."""
    built = []
    orig = ContinuousBatchingEngine.__init__

    def init(self, *args, **kwargs):
        orig(self, *args, **kwargs)
        built.append(self)

    monkeypatch.setattr(ContinuousBatchingEngine, "_DEFAULT_CHECK", True)
    monkeypatch.setattr(ContinuousBatchingEngine, "__init__", init)
    yield
    errors = [f.format() for eng in built for f in eng.check_findings
              if f.severity == "error"]
    assert not errors, "\n".join(errors)


def _gated(tree):
    if isinstance(tree, dict):
        return {k: (np.full_like(v, GATE) if k == "gate_attn" else _gated(v))
                for k, v in tree.items()}
    return tree


def _pair(arch):
    jmodel = jax_build_model(jax_reduced_config(arch))
    tree = _gated(jax.tree.map(np.asarray,
                               jmodel.init_params(jax.random.key(0))))
    model = LM(reduced_config(arch), device="cpu")
    return (jmodel, jax.tree.map(jnp.asarray, tree), model,
            params_from_numpy(tree, "cpu"))


# ---------------------------------------------------------------------------
# the drafter copy
# ---------------------------------------------------------------------------
DRAFTERS = pytest.mark.parametrize("cls", [NGramDrafter, JaxDrafter],
                                   ids=["port", "reference"])


@DRAFTERS
def test_drafter_prefers_longer_ngram_and_most_recent_hit(cls):
    d = cls(k=4, ngram_max=3, ngram_min=1)
    d.add_request(0, [5, 7, 7, 5, 7])
    np.testing.assert_array_equal(d.propose(0), [7, 5, 7, 7])
    d.add_request(1, [1, 2, 5, 1, 2, 6, 1, 2])
    assert d.propose(1)[0] == 6


@DRAFTERS
def test_drafter_periodic_extension_fills_k(cls):
    d = cls(k=6)
    d.add_request(0, [5, 9, 1, 2, 1, 2, 1, 2])
    np.testing.assert_array_equal(d.propose(0), [1, 2, 1, 2, 1, 2])
    d.add_request(1, [1, 2, 3, 4, 5, 6, 7, 1, 2, 3])
    np.testing.assert_array_equal(d.propose(1), [4, 5, 6, 7, 1, 2])


@DRAFTERS
def test_drafter_cold_start_and_unknown_rid_draft_nothing(cls):
    d = cls(k=4)
    assert len(d.propose(99)) == 0
    d.add_request(0, [42])
    assert len(d.propose(0)) == 0
    d.add_request(1, np.arange(1, 9))
    assert len(d.propose(1)) == 0


@DRAFTERS
def test_drafter_commit_is_self_healing_across_preemption(cls):
    d = cls(k=4)
    d.add_request(0, [10, 11, 12])
    d.commit(0, 2, [7, 8])
    assert d.history(0) == [10, 11, 12, 7, 8]
    d.commit(0, 1, [9])
    assert d.history(0) == [10, 11, 12, 9]
    with pytest.raises(ValueError, match="truncate into the prompt"):
        d.commit(0, 0, [1, 2])
    d.drop(0)
    assert d.history(0) == []


@DRAFTERS
def test_drafter_throttle_quiets_rejected_requests_and_probes(cls):
    d = cls(k=4, accept_floor=0.45, probe_every=4, min_trials=2)
    d.add_request(0, [1, 2, 1, 2])
    assert not d.throttled(0)
    for _ in range(3):
        d.feedback(0, 4, 0)
    assert d.throttled(0, step=1)
    assert not d.throttled(0, step=4)
    for _ in range(4):
        d.feedback(0, 4, 4)
    assert not d.throttled(0, step=1)
    assert len(d.propose(0)) > 0


def test_drafter_copy_agrees_with_the_original_on_random_histories():
    """Random short-alphabet histories (so n-grams recur), commits that
    rewind as a preemption does, feedback and throttle at every step:
    both drafters give the same proposals, histories and decisions."""
    rng = np.random.default_rng(0)
    for trial in range(20):
        kw = dict(k=int(rng.integers(1, 7)), ngram_max=int(rng.integers(1, 4)),
                  ngram_min=1, probe_every=3, min_trials=1)
        a, b = NGramDrafter(**kw), JaxDrafter(**kw)
        prompt = rng.integers(0, 4, size=int(rng.integers(1, 12)))
        for d in (a, b):
            d.add_request(trial, prompt)
        n_gen = 0
        for step in range(12):
            np.testing.assert_array_equal(a.propose(trial), b.propose(trial))
            if rng.random() < 0.2 and n_gen:
                n_gen, toks = 1, rng.integers(0, 4, size=1)     # rewind
            else:
                toks = rng.integers(0, 4, size=int(rng.integers(1, 4)))
                n_gen += len(toks)
            drafted = int(rng.integers(0, 5))
            accepted = int(rng.integers(0, drafted + 1))
            for d in (a, b):
                d.commit(trial, n_gen, toks)
                d.feedback(trial, drafted, accepted)
            assert a.history(trial) == b.history(trial)
            assert a.throttled(trial, step) == b.throttled(trial, step)


# ---------------------------------------------------------------------------
# engine: spec-on = spec-off = the JAX spec engine, five families
# ---------------------------------------------------------------------------
def _force_drafts(eng, vocab_size):
    """Draft on every greedy decode row (tests/test_serve_spec.py's
    helper): the n-gram proposal when there is one, else a deterministic
    filler from the history's last token.  Greedy acceptance keeps the
    tokens whatever is drafted; the same history gives both engines the
    same drafts."""
    ngram = eng.drafter.propose

    def propose(rid, k=None):
        d = ngram(rid, k)
        if len(d):
            return d
        h = eng.drafter.history(rid)
        if not h:
            return np.zeros((0,), np.int32)
        raw = (np.arange(1, 5) * 2654435761 + h[-1]) % (vocab_size - 1)
        return (raw + 1).astype(np.int32)

    eng.drafter.propose = propose
    eng.drafter.throttled = lambda *a, **kw: False


def _workload(cfg, seed=3):
    rng = np.random.default_rng(seed)
    prompts = [np.tile(rng.integers(1, cfg.vocab_size, size=2),
                       REQUESTS[0][0])[:REQUESTS[0][0]]]
    prompts += [rng.integers(1, cfg.vocab_size, size=n)
                for n, _ in REQUESTS[1:]]
    extras = [stub_context(cfg, rng, scale=0.05) for _ in REQUESTS]
    return prompts, extras


def _serve(eng, prompts, extras):
    rids = [eng.submit(p, g, extra=e)
            for p, (_, g), e in zip(prompts, REQUESTS, extras)]
    out = eng.run()
    return [np.asarray(out[r]).tolist() for r in rids]


@pytest.mark.parametrize("family,arch", FAMILY_ARCHS,
                         ids=[f for f, _ in FAMILY_ARCHS])
def test_spec_tokens_match_spec_off_and_jax(family, arch):
    jmodel, jparams, model, params = _pair(arch)
    cfg = model.cfg
    prompts, extras = _workload(cfg)
    aux = -(-model.decode_state.context_tokens(cfg) // PAGE)
    kw = dict(n_slots=2, max_len=32, page_size=PAGE, prefill_chunk=4,
              page_budget=4 + 2 * aux)
    outs, engines = {}, {}
    for name, cls, p, spec in (
            ("port spec", ContinuousBatchingEngine, params, True),
            ("port off", ContinuousBatchingEngine, params, False),
            ("jax spec", JaxEngine, jparams, True)):
        m = jmodel if cls is JaxEngine else model
        extra_kw = dict(check=True) if cls is JaxEngine else {}
        eng = cls(m, p, spec_decode=spec, spec_k=4, **kw, **extra_kw)
        if spec:
            _force_drafts(eng, cfg.vocab_size)
        outs[name] = _serve(eng, prompts, extras)
        engines[name] = eng
        assert sum(r.n_preemptions for r in eng.requests()) >= 1, name
    assert outs["port spec"] == outs["port off"], family
    assert outs["port spec"] == outs["jax spec"], family
    mine, ref = (engines[n].stats.summary() for n in ("port spec",
                                                      "jax spec"))
    assert mine["drafted_tokens"] > 0, "the verify path never ran"
    for key in ("drafted_tokens", "accepted_draft_tokens", "accept_rate",
                "generated_tokens"):
        assert mine[key] == ref[key], key
    assert [f.row() for f in engines["jax spec"].check_findings] == []
    # the spec-off engine counts no drafts
    assert engines["port off"].stats.summary()["drafted_tokens"] == 0


def _jax_recurrent(jc, family):
    """The reference's recurrent state in the port's layout: ssm
    {"layers": {"h", "conv"}} (L, B, ...); hybrid {"periods": {"ssm":
    (P, n_mamba, B, ...)}} flattened period-major."""
    if family == "ssm":
        return {k: np.asarray(jc["layers"][k]) for k in ("h", "conv")}
    ssm = jc["periods"]["ssm"]
    return {k: np.asarray(ssm[k]).reshape((-1,) + ssm[k].shape[2:])
            for k in ("h", "conv")}


@pytest.mark.parametrize("family,arch", FAMILY_ARCHS[1:3],
                         ids=[f for f, _ in FAMILY_ARCHS[1:3]])
def test_two_pass_state_matches_jax_after_a_rejected_draft(family, arch):
    """One request, drafts forced; stepped together until the first
    verify step that rejects part of its draft.  The port restores its
    snapshot and replays with n_valid = n_accept; the reference replays
    on its pre-step cache: the recurrent state must agree, and the
    snapshot holds every leaf but the K/V entries."""
    jmodel, jparams, model, params = _pair(arch)
    cfg = model.cfg
    prompt = np.random.default_rng(5).integers(1, cfg.vocab_size, size=9)
    kw = dict(n_slots=1, max_len=32, page_size=PAGE, prefill_chunk=16,
              spec_decode=True, spec_k=4)
    eng = ContinuousBatchingEngine(model, params, **kw)
    jeng = JaxEngine(jmodel, jparams, check=True, **kw)
    for e in (eng, jeng):
        _force_drafts(e, cfg.vocab_size)
        e.submit(prompt, 12)
    rejected = False
    while not rejected:
        assert eng.step() == jeng.step()
        s, js = eng.stats, jeng.stats
        assert (s.drafted_tokens, s.accepted_draft_tokens) == \
            (js.drafted_tokens, js.accepted_draft_tokens)
        rejected = s.accepted_draft_tokens < s.drafted_tokens
    want = _jax_recurrent(jeng.cache, family)
    got = eng.cache if family == "ssm" else eng.cache["ssm"]
    for k in ("h", "conv"):
        np.testing.assert_allclose(got[k].numpy(), want[k], err_msg=k, **TOL)
    # the snapshot: h and conv (and the hybrid's pos), never its K/V
    assert len(eng._snapshot) == (2 if family == "ssm" else 3)
    per_slot = sum(t[:, 0].numel() * t.element_size()
                   for t in (got["h"], got["conv"]))
    assert eng.snapshot_bytes >= per_slot
    out, jout = eng.run(), jeng.run()
    assert {r: t.tolist() for r, t in out.items()} == \
        {r: np.asarray(t).tolist() for r, t in jout.items()}


def test_spec_off_engine_builds_no_drafter():
    model = LM(reduced_config("granite-3-2b"), device="cpu")
    params = model.init_params(torch.Generator().manual_seed(0))
    eng = ContinuousBatchingEngine(model, params, n_slots=2, max_len=32,
                                   page_size=PAGE, prefill_chunk=8)
    assert not eng.spec_decode and eng.drafter is None
    assert eng.spec_k == 0 and eng.snapshot_bytes == 0
    with pytest.raises(ValueError, match="spec_k >= 1"):
        ContinuousBatchingEngine(model, params, n_slots=2, max_len=32,
                                 page_size=PAGE, spec_decode=True, spec_k=0)
