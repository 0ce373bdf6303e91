"""The port's open-loop front end against the reference's, on the CPU.

- ``serve/arrivals.py`` and ``serve/slo.py`` are verbatim copies: the
  same seeded arrivals, trace payloads and latency dicts; a trace written
  by either package replays in the other;
- ``OpenLoopFrontend(clock="model")`` on a port engine whose ``hw`` is
  the reference's ceilings (``REF_HW``: ``TPU_V5E``'s numbers, every
  peak its bf16 one, so ``modeled_step_time`` ticks as the JAX engine's)
  gives the JAX front end's ``RequestEvents``, queue depth, makespan,
  completed arrivals and tokens exactly: reduced fp32 granite-3-2b
  (Poisson arrivals, a preemption and a prefix hit), mamba2-780m and
  whisper-base (arrivals carrying their audio frames);
- the reference's stall-free contention test, with the chunk widths
  plan by plan equal to the JAX engine's;
- ``clock="wall"`` and the stall-free policy's wall feedback raise on the
  CPU, where nothing is timed;
- the serve launcher's open-loop flags on the CPU with ``--clock model``
  (gamma arrivals, an SLO, a recorded trace replayed to the same
  tokens, closed-loop arrivals giving ``engine.run()``'s tokens);
- the latency block passes both packages' Report ``validate``.

Every engine runs with the shadow-state checker on (``check=True``): no
error finding.
"""
import dataclasses
import json
import pathlib

import numpy as np
import pytest

import jax
import torch

from repro.configs import reduced_config as jax_reduced_config
from repro.core.costmodel import TPU_V5E
from repro.models import build_model as jax_build_model
from repro.models.decode_state import stub_context as jax_stub_context
from repro.perf import report as jax_report
from repro.serve import ContinuousBatchingEngine as JaxEngine
from repro.serve import OpenLoopFrontend as JaxFrontend
from repro.serve import arrivals as jax_arrivals
from repro.serve import slo as jax_slo
from repro_torch.configs import reduced_config
from repro_torch.core.costmodel import HWSpec
from repro_torch.launch import serve as launch_serve
from repro_torch.models.model import LM
from repro_torch.perf import report
from repro_torch.perf.measure import wall_clock
from repro_torch.serve import (SLO, ContinuousBatchingEngine,
                               OpenLoopFrontend, arrivals, slo)
from repro_torch.weights import params_from_numpy

ROOT = pathlib.Path(__file__).resolve().parents[1]
ARCH = "granite-3-2b"
PAGE = 8
# the reference's ceilings in the port's HWSpec: its model clock divides
# flops by peak_flops_bf16 whatever the dtype, so every peak is that one
REF_HW = HWSpec(name=TPU_V5E.name, hbm_bw=TPU_V5E.hbm_bw, l2_bytes=0.0,
                peak_flops_bf16=TPU_V5E.peak_flops_bf16,
                peak_flops_tf32=TPU_V5E.peak_flops_bf16,
                peak_flops_fp32=TPU_V5E.peak_flops_bf16,
                peak_flops_fp64=TPU_V5E.peak_flops_bf16)


@pytest.fixture(scope="module")
def pairs():
    """``get(arch)``: the JAX model and tree of the reduced config, and
    the port's LM with the same weights (built once per arch)."""
    built = {}

    def get(arch):
        if arch not in built:
            jmodel = jax_build_model(jax_reduced_config(arch))
            jparams = jmodel.init_params(jax.random.key(0))
            model = LM(reduced_config(arch), device="cpu")
            params = params_from_numpy(jax.tree.map(np.asarray, jparams),
                                       "cpu")
            built[arch] = (jmodel, jparams, model, params)
        return built[arch]

    return get


def _engines(pairs, arch, **kw):
    """A JAX engine and a port engine priced by REF_HW, both checked."""
    jmodel, jparams, model, params = pairs(arch)
    jeng = JaxEngine(jmodel, jparams, check=True, **kw)
    eng = ContinuousBatchingEngine(model, params, check=True, **kw)
    eng.hw = REF_HW
    return jeng, eng


def _no_errors(*engines):
    errors = [f.format() for e in engines for f in e.check_findings
              if f.severity == "error"]
    assert not errors, "\n".join(errors)


def _arr(a):
    return (a.arrival_s, np.asarray(a.prompt).tolist(), a.max_new_tokens,
            a.temperature,
            None if a.extra is None else {k: np.asarray(v).tolist()
                                          for k, v in a.extra.items()})


# ---------------------------------------------------------------------------
# the copies
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("name", ["arrivals", "slo"])
def test_copies_are_verbatim(name):
    port = ROOT / "src" / "repro_torch" / "serve" / f"{name}.py"
    ref = ROOT / "src" / "repro" / "serve" / f"{name}.py"
    assert port.read_text() == ref.read_text()


def _workload(mod, n=48, seed=3):
    return mod.synthetic_requests(n, (4, 40), (2, 9), 500, seed=seed,
                                  shared_prefix=8)


def test_arrival_generators_give_the_references_arrivals():
    reqs, jreqs = _workload(arrivals), _workload(jax_arrivals)
    assert [(p.tolist(), g) for p, g in reqs] == \
        [(p.tolist(), g) for p, g in jreqs]
    extra = {"audio_frames": np.ones((3, 2), np.float32)}
    for name, kw in (("poisson_arrivals", dict(rate=7.0, seed=5)),
                     ("poisson_arrivals", dict(rate=0.5, seed=1,
                                               start_s=2.0,
                                               temperature=0.7)),
                     ("gamma_arrivals", dict(rate=3.0, cv=2.5, seed=1)),
                     ("gamma_arrivals", dict(rate=9.0, cv=0.5, seed=4,
                                             extra=extra)),
                     ("closed_loop_arrivals", dict(temperature=0.3))):
        got = getattr(arrivals, name)(reqs, **kw)
        want = getattr(jax_arrivals, name)(jreqs, **kw)
        assert [_arr(a) for a in got] == [_arr(a) for a in want], name
        assert arrivals.trace_payload(got) == jax_arrivals.trace_payload(
            want)
    for mod in (arrivals, jax_arrivals):
        with pytest.raises(ValueError, match="rate"):
            mod.poisson_arrivals(reqs[:2], rate=0.0)
        with pytest.raises(ValueError, match="cv"):
            mod.gamma_arrivals(reqs[:2], rate=1.0, cv=0.0)


def test_a_trace_written_by_either_package_replays_in_the_other(tmp_path):
    reqs, jreqs = _workload(arrivals, 12), _workload(jax_arrivals, 12)
    arr = arrivals.gamma_arrivals(reqs, 4.0, cv=2.0, seed=2,
                                  temperature=0.5)
    jarr = jax_arrivals.gamma_arrivals(jreqs, 4.0, cv=2.0, seed=2,
                                       temperature=0.5)
    mine, theirs = tmp_path / "port.json", tmp_path / "jax.json"
    arrivals.save_trace(mine, arr)
    jax_arrivals.save_trace(theirs, jarr)
    assert mine.read_text() == theirs.read_text()
    assert json.loads(mine.read_text())["schema"] == "repro.serve.trace"
    for path in (mine, theirs):
        assert [_arr(a) for a in arrivals.trace_arrivals(path)] == \
            [_arr(a) for a in jax_arrivals.trace_arrivals(path)] == \
            [_arr(a) for a in arr]
    synth = {"schema": "repro.serve.trace",
             "requests": [{"arrival_s": 0.5, "prompt_len": 7,
                           "max_new_tokens": 3},
                          {"arrival_s": 0.1, "prompt": [4, 5],
                           "max_new_tokens": 2}]}
    assert [_arr(a) for a in arrivals.trace_arrivals(
        synth, vocab_size=50, seed=9)] == [_arr(a) for a in
                                           jax_arrivals.trace_arrivals(
                                               synth, vocab_size=50,
                                               seed=9)]


def _events(mod):
    ev = mod.RequestEvents
    return [
        ev(rid=0, arrival_s=0.0, enqueue_s=0.0, prompt_len=4,
           max_new_tokens=3, first_sched_s=0.01,
           token_times_s=[0.1, 0.2, 0.35], finish_s=0.35,
           finish_reason="max_new_tokens", n_generated=3),
        ev(rid=1, arrival_s=0.1, enqueue_s=0.12, prompt_len=9,
           max_new_tokens=4, first_sched_s=0.3,
           token_times_s=[0.5, 0.5, 0.5, 1.5], finish_s=1.5,
           finish_reason="max_new_tokens", n_generated=4,
           n_preemptions=1, prefix_len=8),
        ev(rid=2, arrival_s=0.9, enqueue_s=0.9, prompt_len=6,
           max_new_tokens=5, first_sched_s=1.0, token_times_s=[1.2],
           n_generated=1)]


def test_latency_summaries_are_the_references():
    depth = [(0.0, 2), (0.4, 1), (1.0, 3), (1.6, 0)]
    for bounds in (None, (0.2, 0.5), (1.0, 2.0)):
        mine = None if bounds is None else SLO(*bounds)
        theirs = None if bounds is None else jax_slo.SLO(*bounds)
        for kw in (dict(), dict(makespan_s=2.0, queue_depth=depth)):
            assert slo.latency_summary(_events(slo), slo=mine, **kw) == \
                jax_slo.latency_summary(_events(jax_slo), slo=theirs, **kw)
    assert slo.latency_summary([], slo=SLO(1, 1)) == \
        jax_slo.latency_summary([], slo=jax_slo.SLO(1, 1))
    assert slo.queue_depth_stats(depth) == jax_slo.queue_depth_stats(depth)
    assert [slo.SLO(0.2, 0.5).met_by(e) for e in _events(slo)] == \
        [jax_slo.SLO(0.2, 0.5).met_by(e) for e in _events(jax_slo)] == \
        [True, False, False]


# ---------------------------------------------------------------------------
# the front end under the model clock against the JAX front end
# ---------------------------------------------------------------------------
def _run_both(jeng, eng, make_arrivals):
    """Both front ends on the model clock over the same arrivals (each
    package's generator); everything they return must be equal."""
    jres = JaxFrontend(jeng, clock="model").run(make_arrivals(jax_arrivals))
    res = OpenLoopFrontend(eng, clock="model").run(make_arrivals(arrivals))
    assert res.clock == "model"
    assert [dataclasses.asdict(e) for e in res.events] == \
        [dataclasses.asdict(e) for e in jres.events]
    assert res.queue_depth == jres.queue_depth
    assert res.makespan_s == jres.makespan_s > 0
    assert [_arr(a) for a in res.completed_arrivals] == \
        [_arr(a) for a in jres.completed_arrivals]
    assert sorted(res.results) == sorted(jres.results)
    for rid in jres.results:
        np.testing.assert_array_equal(res.results[rid],
                                      np.asarray(jres.results[rid]))
    lim = jax_slo.SLO(ttft_s=res.makespan_s / 4, tbt_s=res.makespan_s / 20)
    assert res.summary(SLO(lim.ttft_s, lim.tbt_s)) == jres.summary(lim)
    for key in ("model_flops", "model_bytes", "steps", "generated_tokens"):
        assert res.engine_summary[key] == jres.engine_summary[key], key
    assert eng.step_feedback == "wall"           # restored after the run
    _no_errors(jeng, eng)
    return res


def test_model_clock_matches_jax_granite_poisson_preemption_prefix(pairs):
    """Half the prompts share a two-page prefix; a 6-page budget on 2
    slots forces preemptions; Poisson arrivals at about the service rate
    queue requests behind released donors, so admissions hit the pool."""
    kw = dict(n_slots=2, max_len=48, page_size=PAGE, prefill_chunk=6,
              page_budget=6, prefix_cache=True)
    jeng, eng = _engines(pairs, ARCH, **kw)
    step = jeng.modeled_step_time(2, 0)
    assert eng.modeled_step_time(2, 0) == step

    def make(mod):
        rng = np.random.default_rng(7)
        vocab = eng.model.cfg.vocab_size
        shared = rng.integers(1, vocab, size=2 * PAGE)
        reqs = []
        for i in range(8):
            own = rng.integers(1, vocab, size=int(rng.integers(8, 20)))
            prompt = np.concatenate([shared, own]) if i % 2 else own
            reqs.append((prompt, int(rng.integers(6, 13))))
        return mod.poisson_arrivals(reqs, rate=0.2 / step, seed=11)

    res = _run_both(jeng, eng, make)
    assert sum(e.n_preemptions for e in res.events) > 0
    assert any(e.prefix_len > 0 for e in res.events)
    assert max(d for _, d in res.queue_depth) > 0
    # closed-loop arrivals through the front end are engine.run()'s steps
    eng.reset()
    reqs = [(np.asarray(a.prompt), a.max_new_tokens)
            for a in make(arrivals)]
    rids = [eng.submit(p, g) for p, g in reqs]
    ref = eng.run()
    eng.reset()
    closed = OpenLoopFrontend(eng, clock="model").run(
        arrivals.closed_loop_arrivals(reqs))
    for rid in rids:
        np.testing.assert_array_equal(closed.results[rid], ref[rid])
    assert all(e.completed for e in closed.events)


def test_model_clock_matches_jax_mamba2(pairs):
    kw = dict(n_slots=2, max_len=32, page_size=PAGE, prefill_chunk=4,
              page_budget=4)
    jeng, eng = _engines(pairs, "mamba2-780m", **kw)
    step = jeng.modeled_step_time(2, 0)

    def make(mod):
        reqs = mod.synthetic_requests(6, (4, 16), (3, 7),
                                      eng.model.cfg.vocab_size, seed=4)
        return mod.poisson_arrivals(reqs, rate=0.3 / step, seed=3)

    res = _run_both(jeng, eng, make)
    assert sum(e.n_preemptions for e in res.events) > 0


def test_model_clock_matches_jax_whisper_with_extra(pairs):
    """Each arrival carries its own audio frames; the engines install
    them at every admission (a preemption's re-admission too)."""
    cfg = pairs("whisper-base")[2].cfg
    aux = -(-cfg.n_audio_ctx // PAGE)
    kw = dict(n_slots=2, max_len=32, page_size=PAGE, prefill_chunk=4,
              page_budget=4 + 2 * aux)
    jeng, eng = _engines(pairs, "whisper-base", **kw)
    step = jeng.modeled_step_time(2, 0)

    def make(mod):
        rng = np.random.default_rng(2)
        out, t = [], 0.0
        for n, g in ((15, 5), (15, 4), (7, 6), (9, 3)):
            prompt = rng.integers(1, cfg.vocab_size, size=n)
            extra = jax_stub_context(cfg, rng, scale=0.05)
            t += float(rng.exponential(3 * step))
            out.append(mod.ArrivalRequest(t, prompt, g, extra=extra))
        return out

    res = _run_both(jeng, eng, make)
    assert sum(e.n_preemptions for e in res.events) > 0


def _plan_log(eng):
    """Wrap ``eng.step`` to log each executed plan's composition: the
    decode rows, each prefill row's width, the chunk width chosen."""
    log = []
    orig = eng.step

    def step():
        more = orig()
        plan = eng.last_plan
        if plan is not None:
            log.append((plan.n_decode,
                        tuple(int(pf.n_valid[0]) for pf in plan.prefills),
                        eng.sched.last_chunk_width))
        return more

    eng.step = step
    return log


def test_stall_free_chunks_bound_tbt_and_match_the_jax_engines(pairs):
    """The reference's contention test: request 0 is mid-decode when a
    64-token prompt arrives; under the stall-free policy with a target
    below a full 8-wide chunk riding the decode, the chunks narrow and
    request 0's worst gap drops below the fixed policy's, with the same
    tokens.  Both policies' chunk widths, plan by plan, equal the JAX
    engine's."""
    rng = np.random.default_rng(31)
    vocab = pairs(ARCH)[2].cfg.vocab_size
    decode_prompt = rng.integers(1, vocab, size=4)
    prefill_prompt = rng.integers(1, vocab, size=64)
    kw = dict(n_slots=2, max_len=96, page_size=PAGE, prefill_chunk=8)
    jeng, eng = _engines(pairs, ARCH, chunk_policy="fixed", **kw)
    t_arrive = (eng.modeled_step_time(0, 4)
                + 2.5 * eng.modeled_step_time(1, 0))
    target = 0.9 * eng.modeled_step_time(1, 8)
    assert (t_arrive, target) == (
        jeng.modeled_step_time(0, 4) + 2.5 * jeng.modeled_step_time(1, 0),
        0.9 * jeng.modeled_step_time(1, 8))

    def run(front, e, mod):
        log = _plan_log(e)
        res = front(e, clock="model").run(
            [mod.ArrivalRequest(0.0, decode_prompt, 24),
             mod.ArrivalRequest(t_arrive, prefill_prompt, 1)])
        (ev,) = [x for x in res.events if x.rid == 0]
        assert ev.completed and ev.max_tbt_s is not None
        return ev.max_tbt_s, res, log

    out = {}
    for policy in ("fixed", "stall_free"):
        if policy == "stall_free":
            jeng, eng = _engines(pairs, ARCH, chunk_policy=policy,
                                 tbt_target_s=target, **kw)
        mine = run(OpenLoopFrontend, eng, arrivals)
        theirs = run(JaxFrontend, jeng, jax_arrivals)
        assert mine[2] == theirs[2], policy           # plan by plan
        assert mine[0] == theirs[0]
        assert [dataclasses.asdict(e) for e in mine[1].events] == \
            [dataclasses.asdict(e) for e in theirs[1].events]
        _no_errors(jeng, eng)
        out[policy] = mine
    fixed_tbt, fixed, fixed_log = out["fixed"]
    free_tbt, free, free_log = out["stall_free"]
    assert fixed_tbt == pytest.approx(eng.modeled_step_time(1, 8))
    assert free_tbt < fixed_tbt
    assert {w for _, _, w in fixed_log} == {8}
    assert min(w for _, _, w in free_log) < 8
    assert sorted(free.results) == sorted(fixed.results)
    for rid in fixed.results:
        np.testing.assert_array_equal(free.results[rid], fixed.results[rid])


def test_wall_clock_and_wall_feedback_raise_off_the_card(pairs):
    _, _, model, params = pairs(ARCH)
    eng = ContinuousBatchingEngine(model, params, n_slots=2, max_len=32,
                                   page_size=PAGE, chunk_policy="stall_free",
                                   tbt_target_s=1e-3)
    with pytest.raises(ValueError, match='clock="model"'):
        OpenLoopFrontend(eng)                          # clock="wall"
    with pytest.raises(ValueError, match="clock"):
        OpenLoopFrontend(eng, clock="sundial")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            wall_clock(lambda: None)
    reqs = [(np.arange(1, 6), 3), (np.arange(2, 12), 2)]
    for p, g in reqs:
        eng.submit(p, g)
    with pytest.raises(RuntimeError, match='clock="model"'):
        eng.run()                                     # "wall" feedback
    eng.reset()
    res = OpenLoopFrontend(eng, clock="model").run(
        arrivals.closed_loop_arrivals(reqs))
    assert [e.n_generated for e in res.events] == [3, 2]
    assert eng.step_feedback == "wall" and eng.sched.sec_per_token > 0


# ---------------------------------------------------------------------------
# the launcher and the Report schema
# ---------------------------------------------------------------------------
COMMON = ["--arch", ARCH, "--reduced", "--device", "cpu", "--slots", "2",
          "--requests", "5", "--prompt-len", "12", "--min-prompt-len", "4",
          "--gen-len", "4", "--prefill-chunk", "4"]
OPEN = ["--open-loop", "--clock", "model"]


def test_launch_serve_open_loop_flags_on_the_cpu(tmp_path):
    trace = tmp_path / "trace.json"
    res = launch_serve.main(COMMON + OPEN + [
        "--arrival", "gamma", "--cv", "3", "--rate", "2e4", "--slo-ttft",
        "1e-4", "--slo-tbt", "2e-5", "--record-trace", str(trace)])
    lat = res["latency"]
    assert lat["requests"] == lat["completed"] == res["requests"] == 5
    assert (lat["slo"]["ttft_s"], lat["slo"]["tbt_s"]) == (1e-4, 2e-5)
    assert res["arrivals"] == "gamma rate=20000.0/s cv=3.0"
    assert all(4 <= len(p) <= 12 for p in res["prompts"])
    assert res["engine_summary"]["model_flops"] > 0
    assert res["makespan_s"] == lat["makespan_s"] > 0
    text = launch_serve.report(res)
    for what in ("TTFT: p50=", "TBT: p50=", "E2E: p50=", "queue depth:",
                 "SLO(ttft<=", "recorded 5 completed arrival(s)"):
        assert what in text, what
    # the recorded trace replays to the same workload and tokens, and the
    # JAX package reads it as the same workload
    replay = launch_serve.main(COMMON + OPEN + ["--trace", str(trace)])
    assert replay["arrivals"] == f"trace {trace}"
    assert [_arr(a) for a in replay["completed_arrivals"]] == \
        [_arr(a) for a in res["completed_arrivals"]] == \
        [_arr(a) for a in jax_arrivals.trace_arrivals(trace)]
    assert {r: t.tolist() for r, t in replay["tokens"].items()} == \
        {r: t.tolist() for r, t in res["tokens"].items()}
    # rate 0: every request at t=0 through the front end, engine.run()'s
    # tokens (the same prompts: granite draws no stub context)
    closed = launch_serve.main(COMMON + OPEN)
    plain = launch_serve.main(COMMON)
    assert closed["arrivals"] == "closed-loop (all at t=0)"
    assert plain["latency"] is None and not plain["open_loop"]
    assert {r: t.tolist() for r, t in closed["tokens"].items()} == \
        {r: t.tolist() for r, t in plain["tokens"].items()}


@pytest.mark.parametrize("kw,match", [
    (dict(record_trace="x.json"), "--record-trace needs --open-loop"),
    (dict(open_loop=True, clock="model", arrival="trace"),
     "--arrival trace needs --trace"),
    (dict(static=True, open_loop=True), "static engine"),
    (dict(open_loop=True, clock="sundial"), "clock"),
])
def test_launch_serve_refuses_what_the_reference_refuses(kw, match):
    with pytest.raises(ValueError, match=match):
        launch_serve.run(ARCH, reduced=True, device="cpu", **kw)


def test_latency_block_passes_both_validators(tmp_path):
    res = launch_serve.run(ARCH, reduced=True, device="cpu", slots=2,
                           requests=4, prompt_len=8, gen_len=3,
                           open_loop=True, clock="model", rate=1e4)
    row = {"arch": ARCH, "latency": res["latency"]}
    rep = report.make_report("open_loop", [row], meta={"clock": "model"})
    payload = json.loads(rep.to_json())
    assert report.validate(payload) == [] == jax_report.validate(payload)
    path = tmp_path / "r.json"
    path.write_text(rep.to_json())
    assert report.validate_path(path) == [] == jax_report.validate_path(path)
    assert report.Report.from_payload(payload).rows == [row]
    assert payload["hw"]["name"] == "h100_sxm"
    assert payload["environment"]["torch_version"] == torch.__version__
    assert payload["created_unix"] > 1.6e9
    # a partial latency block fails both alike
    del payload["rows"][0]["latency"]["ttft_s"]["p99"]
    del payload["rows"][0]["latency"]["makespan_s"]
    assert report.validate(payload) == jax_report.validate(payload) != []
    hw = REF_HW
    assert report.roofline_fraction(3e12, 4e9, 0.05, hw) == \
        jax_report.roofline_fraction(3e12, 4e9, 0.05, TPU_V5E)
    assert report.roofline_fraction(1.0, 1.0, 0.0) == 0.0
