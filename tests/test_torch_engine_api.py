"""The port engine's API against the JAX engine's, on the CPU.

- ``EngineStats.summary()``: the reference's key set without its three
  modeled keys (``model_flops``, ``model_bytes``,
  ``model_tflops_per_s``: ``StepCostModel`` is not ported) and with the
  port's ``forwards``, the zero-step case (its ``note``) included; the
  counts and the occupancy and page utilization equal the reference's;
  times are ``None`` on the CPU;
- ``reset()`` and a rerun give the same tokens, plans and stats;
- ``results()`` in the middle of a run, then after it;
- ``generate()`` against the JAX engine's ``generate`` at temperature 0;
- ``last_plan`` / ``last_sampled_rids`` / ``last_admitted_rids`` step by
  step against the JAX engine's, with prefix hits, drafts and a
  preemption;
- the serve launcher's ``--prefix-cache`` and ``--speculative`` (and
  ``run(prefix_cache=, speculative=, spec_k=)``) on a reduced
  granite-3-2b, and what it still refuses.

Reduced fp32 granite-3-2b, the JAX tree carried over by
``params_from_numpy``.  Every port engine runs under the port's
shadow-state checker (``_DEFAULT_CHECK``), the JAX ones with
``check=True``: no error finding.
"""
import dataclasses

import numpy as np
import pytest

import jax
import torch

from repro.configs import reduced_config as jax_reduced_config
from repro.models import build_model as jax_build_model
from repro.serve import ContinuousBatchingEngine as JaxEngine
from repro.serve.engine import EngineStats as JaxStats
from repro_torch.configs import reduced_config
from repro_torch.launch import serve as launch_serve
from repro_torch.models.model import LM
from repro_torch.serve.engine import ContinuousBatchingEngine, EngineStats
from repro_torch.weights import params_from_numpy

ARCH = "granite-3-2b"
MODELED = {"model_flops", "model_bytes", "model_tflops_per_s"}


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


@pytest.fixture(scope="module")
def granite():
    jmodel = jax_build_model(jax_reduced_config(ARCH))
    jparams = jmodel.init_params(jax.random.key(0))
    model = LM(reduced_config(ARCH), device="cpu")
    params = params_from_numpy(jax.tree.map(np.asarray, jparams), "cpu")
    return jmodel, jparams, model, params


# a shared 16-token prefix (two pages), prompts of 18-23 tokens, 5-8 new,
# on 2 slots under a 6-page budget: prefix hits, a preemption, drafts
KW = dict(n_slots=2, max_len=32, page_size=8, prefill_chunk=6,
          page_budget=6)


def _requests(vocab, seed=2):
    rng = np.random.default_rng(seed)
    shared = np.tile(rng.integers(1, vocab, size=4), 4)
    return [(np.concatenate([shared, rng.integers(1, vocab, size=n)]), g)
            for n, g in ((2, 8), (5, 6), (7, 5), (3, 7))]


def _plan_fields(plan):
    if plan is None:
        return None
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


def test_summary_keys_are_the_references_without_the_modeled_ones(granite):
    jmodel, jparams, model, params = granite
    empty, jempty = EngineStats().summary(), JaxStats().summary()
    assert set(empty) == (set(jempty) - MODELED) | {"forwards"}
    assert {k: v for k, v in empty.items() if k != "forwards"} == \
        {k: v for k, v in jempty.items() if k not in MODELED}
    reqs = _requests(model.cfg.vocab_size)
    eng = ContinuousBatchingEngine(model, params, prefix_cache=True, **KW)
    jeng = JaxEngine(jmodel, jparams, prefix_cache=True, check=True, **KW)
    for e in (eng, jeng):
        for p, g in reqs:
            e.submit(p, g)
        e.run()
    got, want = eng.stats.summary(), jeng.stats.summary()
    assert set(got) == (set(want) - MODELED) | {"forwards"}
    for key in ("steps", "generated_tokens", "mean_occupancy",
                "mean_page_utilization", "prefix_hit_tokens",
                "prefix_hit_rate", "drafted_tokens",
                "accepted_draft_tokens", "accept_rate"):
        assert got[key] == pytest.approx(want[key]), key
    assert got["prefix_hit_tokens"] > 0
    # device times only: none on the CPU
    assert got["tok_per_s"] is None and got["step_ms_p50"] is None
    assert got["step_ms_p95"] is None


@pytest.mark.parametrize("spec", [False, True], ids=["plain", "spec"])
def test_reset_then_rerun_gives_the_same_run(granite, spec):
    _, _, model, params = granite
    reqs = _requests(model.cfg.vocab_size)
    eng = ContinuousBatchingEngine(model, params, prefix_cache=True,
                                   spec_decode=spec, **KW)
    runs = []
    for _ in range(2):
        rids = [eng.submit(p, g) for p, g in reqs]
        plans = []
        while eng.step():
            plans.append(_plan_fields(eng.last_plan))
        out = eng.run()
        runs.append(([out[r].tolist() for r in rids], plans,
                     eng.stats.summary(), eng.check_findings))
        checker = eng.checker
        eng.reset()
        assert eng.checker is not checker and eng.stats.steps == []
        assert eng.results() == {} and eng.last_plan is None
        assert eng.kv.table.n_used == 0 and not eng.sched.has_work()
        assert not bool(eng._out_buf.any())
        assert all(not bool(t.any()) for t in (eng.cache["k"],
                                               eng.cache["pos"]))
    assert runs[0][0] == runs[1][0]
    _assert_same(runs[0][1], runs[1][1], "plans")
    assert runs[0][2] == runs[1][2]
    if spec:
        assert runs[0][2]["drafted_tokens"] > 0


def test_results_mid_run_then_after_it(granite):
    _, _, model, params = granite
    reqs = _requests(model.cfg.vocab_size)
    eng = ContinuousBatchingEngine(model, params, **KW)
    rids = [eng.submit(p, g) for p, g in reqs]
    seen = []
    while eng.step():
        now = eng.results()
        assert set(seen) <= set(now)
        for r in now:
            assert len(now[r]) == dict(zip(rids, [g for _, g in reqs]))[r]
        seen = list(now)
    assert 0 < len(seen) < len(rids)           # some finished, not all
    final = eng.run()
    assert sorted(final) == sorted(rids) == sorted(eng.results())
    for r in seen:
        np.testing.assert_array_equal(final[r], eng.results()[r])


def test_generate_matches_jax_generate(granite):
    jmodel, jparams, model, params = granite
    prompts = np.random.default_rng(6).integers(
        1, model.cfg.vocab_size, size=(3, 11))
    kw = dict(n_slots=2, max_len=32, page_size=8, prefill_chunk=4)
    got = ContinuousBatchingEngine(model, params, **kw).generate(prompts, 6)
    want = JaxEngine(jmodel, jparams, check=True, **kw).generate(prompts, 6)
    assert got.shape == (3, 6) and got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    # tensors are taken as the batch too
    again = ContinuousBatchingEngine(model, params, **kw).generate(
        torch.from_numpy(prompts), 6)
    assert torch.equal(again, got)


@pytest.mark.parametrize("spec", [False, True], ids=["plain", "spec"])
def test_last_step_records_match_jax_step_by_step(granite, spec):
    jmodel, jparams, model, params = granite
    reqs = _requests(model.cfg.vocab_size)
    kw = dict(KW, prefix_cache=True, spec_decode=spec, spec_k=3)
    eng = ContinuousBatchingEngine(model, params, **kw)
    jeng = JaxEngine(jmodel, jparams, check=True, **kw)
    for e in (eng, jeng):
        for p, g in reqs[:3]:
            e.submit(p, g)
    step, admitted = 0, []
    while True:
        if step == 4:
            for e in (eng, jeng):
                e.submit(*reqs[3])
        more = eng.step()
        assert more == jeng.step(), step
        _assert_same(_plan_fields(eng.last_plan),
                     _plan_fields(jeng.last_plan), f"step {step}")
        assert eng.last_sampled_rids == jeng.last_sampled_rids, step
        assert eng.last_admitted_rids == jeng.last_admitted_rids, step
        admitted += eng.last_admitted_rids
        step += 1
        if not more:
            break
    assert sorted(set(admitted)) == [0, 1, 2, 3]
    assert sum(r.n_preemptions for r in eng.requests()) >= 1
    out, jout = eng.run(), jeng.run()
    assert {r: t.tolist() for r, t in out.items()} == \
        {r: np.asarray(t).tolist() for r, t in jout.items()}
    if spec:
        assert eng.stats.drafted_tokens == jeng.stats.drafted_tokens > 0


# ---------------------------------------------------------------------------
# the launcher
# ---------------------------------------------------------------------------
def test_launch_serve_runs_prefix_cache_and_speculative_on_the_cpu():
    base = dict(reduced=True, device="cpu", slots=2, requests=4,
                prompt_len=16, gen_len=6, prefill_chunk=4, page_size=8)
    plain = launch_serve.run(ARCH, **base)
    spec = launch_serve.run(ARCH, speculative=True, spec_k=3, **base)
    warm = launch_serve.run(ARCH, prefix_cache=True, prefix_pool=4, **base)
    for res in (plain, spec, warm):
        assert res["engine"] == "continuous" and res["run_ms"] is None
        assert all(len(t) == 6 for t in res["tokens"].values())
    assert {r: t.tolist() for r, t in spec["tokens"].items()} == \
        {r: t.tolist() for r, t in plain["tokens"].items()}
    assert {r: t.tolist() for r, t in warm["tokens"].items()} == \
        {r: t.tolist() for r, t in plain["tokens"].items()}
    assert spec["speculative"] and not plain["speculative"]
    assert spec["drafted_tokens"] > 0 and plain["drafted_tokens"] == 0
    assert warm["prefix_cache"] and not plain["prefix_cache"]
    assert "speculative: accept_rate" in launch_serve.report(spec)
    assert "prefix cache:" in launch_serve.report(warm)


def test_launch_serve_cli_flags_and_what_it_still_refuses():
    res = launch_serve.main(["--arch", ARCH, "--reduced", "--device", "cpu",
                             "--slots", "2", "--requests", "2",
                             "--prompt-len", "8", "--gen-len", "3",
                             "--prefix-cache", "--prefix-pool", "2",
                             "--speculative", "--spec-k", "2"])
    assert res["prefix_cache"] and res["speculative"]
    assert all(len(t) == 3 for t in res["tokens"].values())
    for kw in (dict(open_loop=True), dict(chunk_policy="stall_free")):
        with pytest.raises(NotImplementedError, match="A7"):
            launch_serve.run(ARCH, reduced=True, device="cpu", **kw)
    with pytest.raises(ValueError, match="static engine"):
        launch_serve.run(ARCH, reduced=True, device="cpu", static=True,
                         speculative=True)
