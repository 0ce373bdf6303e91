"""The port's serving stack against the reference.

1. The copied host-only scheduler and paged cache against the originals:
   the same request stream (chunked prefill, mid-run submissions, a page
   budget small enough to preempt) must compose identical ``StepPlan``s
   step by step, with ``repro.analysis.schedcheck.SchedChecker`` attached
   to both pairs and clean.
2. Temperature-0 token parity between the port's engine (plain paged
   attention on the CPU, fp32 reduced ``granite-3-2b``) and the JAX
   ``ContinuousBatchingEngine`` on the same weights, under chunked
   prefill, mid-run admission and forced preemption (the cases of
   tests/test_serve.py).  On a divergence the failure message carries the
   reference's top-2 logit gap at the first divergent token.
"""
import dataclasses

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from repro.analysis.schedcheck import SchedChecker
from repro.configs import reduced_config as jax_reduced_config
from repro.models import build_model as jax_build_model
from repro.serve import ContinuousBatchingEngine as JaxEngine
from repro.serve.cache import PagedKVCache as JaxKV
from repro.serve.scheduler import Scheduler as JaxScheduler
from repro_torch.configs import reduced_config
from repro_torch.models.model import LM
from repro_torch.serve.cache import PagedKVCache
from repro_torch.serve.engine import ContinuousBatchingEngine
from repro_torch.serve.scheduler import Scheduler
from repro_torch.weights import params_from_numpy


# ---------------------------------------------------------------------------
# scheduler + cache copies vs the originals
# ---------------------------------------------------------------------------
def _plan_fields(plan):
    d = {f.name: getattr(plan, f.name) for f in dataclasses.fields(plan)
         if f.name != "prefills"}
    d["prefills"] = [dataclasses.asdict(p) for p in plan.prefills]
    return d


def _assert_same(a, b, where):
    if isinstance(a, dict):
        assert a.keys() == b.keys(), where
        for k in a:
            _assert_same(a[k], b[k], f"{where}.{k}")
    elif isinstance(a, list):
        assert len(a) == len(b), where
        for i, (x, y) in enumerate(zip(a, b)):
            _assert_same(x, y, f"{where}[{i}]")
    else:
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b),
                                      err_msg=where)


@pytest.mark.parametrize("budget", [None, 7])
def test_scheduler_copy_composes_identical_plans(budget):
    rng = np.random.default_rng(7)
    stream = [(rng.integers(1, 100, size=int(n)), int(g), int(at))
              for n, g, at in zip(rng.integers(3, 20, size=8),
                                  rng.integers(1, 8, size=8),
                                  [0, 0, 0, 2, 3, 5, 9, 9])]
    pairs = []
    for kv_cls, sched_cls in ((JaxKV, JaxScheduler),
                              (PagedKVCache, Scheduler)):
        kv = kv_cls(3, 32, 4, page_budget=budget)
        sched = sched_cls(kv, prefill_chunk=5)
        pairs.append((kv, sched, SchedChecker.attach(kv, sched)))
    step = 0
    while step < 200:
        for _, sched, _ in pairs:
            for prompt, g, at in stream:
                if at == step:
                    sched.submit(prompt, g, step=step)
        plans = [sched.next_plan(step) for _, sched, _ in pairs]
        assert (plans[0] is None) == (plans[1] is None), step
        if plans[0] is None and not pairs[0][1].has_work():
            break
        if plans[0] is not None:
            _assert_same(_plan_fields(plans[0]), _plan_fields(plans[1]),
                         f"step {step}")
            for (_, sched, checker), plan in zip(pairs, plans):
                sched.commit(plan, None, step)
                checker.check_step()
        step += 1
    assert not pairs[0][1].has_work() and not pairs[1][1].has_work()
    for kv, sched, checker in pairs:
        checker.check_drain()
        assert not [f for f in checker.findings if f.severity == "error"]
    got = [[(r.rid, r.n_generated, r.n_preemptions, r.finish_step)
            for r in sched.finished] for _, sched, _ in pairs]
    assert got[0] == got[1]
    if budget is not None:
        assert sum(r.n_preemptions for r in pairs[1][1].finished) > 0


# ---------------------------------------------------------------------------
# engine token parity
# ---------------------------------------------------------------------------
@pytest.fixture(scope="module")
def granite():
    jcfg = jax_reduced_config("granite-3-2b")
    jmodel = jax_build_model(jcfg)
    jparams = jmodel.init_params(jax.random.key(0))
    model = LM(reduced_config("granite-3-2b"), device="cpu")
    params = params_from_numpy(jax.tree.map(np.asarray, jparams),
                               device="cpu")
    return jmodel, jparams, model, params


def _logit_gap(jmodel, jparams, context):
    """Reference top-2 logit gap at the token after ``context``."""
    n = len(context)
    cache = jmodel.init_cache(1, n + 1)
    logits, _, _ = jmodel.forward(
        jparams, jnp.asarray(context, jnp.int32)[None],
        jnp.arange(n, dtype=jnp.int32)[None], mode="decode", cache=cache)
    top = np.sort(np.asarray(logits[0, -1]))[-2:]
    return float(top[1] - top[0])


def _serve(engine, reqs, checker=None):
    rids = [engine.submit(p, g) for p, g in reqs]
    if checker is not None:
        # drive the port's steps one by one under the shadow checker
        while engine.step():
            checker.check_step()
        checker.check_step()
    out = engine.run()
    return [np.asarray(out[r]) for r in rids], engine


CASES = {
    # prompts longer than the chunk: several chunks per prompt
    "chunked_prefill": dict(kw=dict(n_slots=3, max_len=48, page_size=8,
                                    prefill_chunk=5),
                            reqs=[(17, 6), (11, 5), (23, 4)]),
    # three requests on two slots: the third enters a recycled slot
    "midrun_admission": dict(kw=dict(n_slots=2, max_len=48, page_size=8,
                                     prefill_chunk=6),
                             reqs=[(9, 4), (5, 10), (7, 4)]),
    # a page budget of 4 cannot hold both requests: the younger one is
    # preempted mid-prefill and recomputed from token 0
    "forced_preemption": dict(kw=dict(n_slots=2, max_len=32, page_size=8,
                                      page_budget=4, prefill_chunk=4),
                              reqs=[(15, 8), (20, 2)]),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_engine_greedy_tokens_match_jax(granite, case):
    jmodel, jparams, model, params = granite
    spec = CASES[case]
    rng = np.random.default_rng(3)
    reqs = [(rng.integers(1, model.cfg.vocab_size, size=n), g)
            for n, g in spec["reqs"]]
    want, jeng = _serve(JaxEngine(jmodel, jparams, check=True,
                                  **spec["kw"]), reqs)
    eng = ContinuousBatchingEngine(model, params, **spec["kw"])
    checker = SchedChecker.attach(eng.kv, eng.sched)
    got, eng = _serve(eng, reqs, checker)
    checker.check_drain()
    for findings in (jeng.check_findings, checker.findings):
        assert not [f.format() for f in findings if f.severity == "error"]
    for i, ((prompt, _), w, g) in enumerate(zip(reqs, want, got)):
        if not np.array_equal(w, g):
            k = int(np.argmax(w[:len(g)] != g[:len(w)]))
            gap = _logit_gap(jmodel, jparams,
                             np.concatenate([prompt, w[:k]]))
            pytest.fail(f"{case}: request {i} diverges at token {k} "
                        f"(jax {w.tolist()} vs port {g.tolist()}); "
                        f"reference top-2 logit gap there: {gap:.3e}")
    jpre = sorted(r.n_preemptions for r in jeng.requests())
    pre = sorted(r.n_preemptions for r in eng.requests())
    assert pre == jpre
    if case == "forced_preemption":
        assert max(pre) >= 1
    if case == "midrun_admission":
        assert max(r.admit_step for r in eng.requests()) > 0
    assert eng.stats.generated_tokens == sum(len(t) for t in got)
    assert eng.kv.table.n_used == 0 and eng.kv.n_active == 0


def test_engine_eos_finishes_request(granite):
    """EOS is the engine's one per-step host read: with the second greedy
    token as EOS, the request stops there (as tests/test_serve.py holds
    the reference)."""
    _, _, model, params = granite
    prompt = np.random.default_rng(1).integers(1, model.cfg.vocab_size, 12)
    kw = dict(n_slots=1, max_len=48, page_size=8, prefill_chunk=6)
    ref = ContinuousBatchingEngine(model, params, **kw)
    rid = ref.submit(prompt, 6)
    full = ref.run()[rid].tolist()
    eos = full[1]
    eng = ContinuousBatchingEngine(model, params, eos_id=eos, **kw)
    rid = eng.submit(prompt, 6)
    out = eng.run()[rid].tolist()
    assert eng.requests()[0].finish_reason == "eos"
    assert out == full[:full.index(eos) + 1]


def test_engine_temperature_sampling_is_seeded_and_in_range(granite):
    """temp > 0 draws from the engine's torch.Generator: the same seed
    gives the same tokens, every token is a valid id, and greedy rows in
    the same batch are unaffected (distribution parity with the
    reference, not threefry bit parity)."""
    _, _, model, params = granite
    rng = np.random.default_rng(5)
    prompts = [rng.integers(1, model.cfg.vocab_size, size=n)
               for n in (6, 9)]

    def run(seed):
        eng = ContinuousBatchingEngine(model, params, n_slots=2, max_len=32,
                                       page_size=8, seed=seed)
        hot = eng.submit(prompts[0], 8, temperature=1.0)
        cold = eng.submit(prompts[1], 8)
        out = eng.run()
        return out[hot], out[cold]

    a, b, c = run(0), run(0), run(1)
    np.testing.assert_array_equal(a[0], b[0])
    np.testing.assert_array_equal(a[1], c[1])
    assert all(0 <= t < model.cfg.padded_vocab for t in a[0])


def test_engine_rejects_unported_options(granite):
    _, _, model, params = granite
    for kw in (dict(analyze=True), dict(mesh=object()), dict(sp_kv=True),
               dict(retune=True),
               dict(chunk_policy="stall_free", tbt_target_s=0.01)):
        with pytest.raises(NotImplementedError):
            ContinuousBatchingEngine(model, params, n_slots=1, max_len=16,
                                     **kw)


def test_sampling_distribution_matches_softmax():
    """Gumbel-max draws follow softmax(logits / T) (chi-square-free check:
    empirical frequencies within 0.02 of the target over 20000 rows)."""
    from repro_torch.serve.sampling import sample_tokens
    logits = torch.tensor([[2.0, 1.0, 0.0, -1.0]]).repeat(20000, 1)
    temps = torch.full((20000,), 0.7)
    g = torch.Generator().manual_seed(0)
    toks = sample_tokens(logits, temps, g, any_temp=True)
    freq = np.bincount(toks.numpy(), minlength=4) / 20000
    want = torch.softmax(logits[0] / 0.7, dim=-1).numpy()
    np.testing.assert_allclose(freq, want, atol=0.02)
