"""The port's copy of the serve shadow-state checker against the original.

``repro_torch.analysis.schedcheck.SchedChecker`` (with its copies of
``Finding`` and ``SCHED_RULES``) and ``repro.analysis.schedcheck``'s are
driven through the same scripted transitions — each on its own package's
``PagedKVCache`` and ``Scheduler`` — including the faults
tests/test_analysis.py injects (a double free, a prefix claim of a page
nobody owns and illegal admissions and preemptions, a live double free
through the page table, a leaked page at drain, one rid on two slots):
both must report the same ``(rule, severity)`` findings, and the ones
those tests name.  The rule table and ``Finding``'s rows equal the
originals, and a live port engine with ``check=True`` (prefix cache,
preemption, drain) stays clean.
"""
import dataclasses
import os
import pathlib
import subprocess
import sys

import numpy as np
import pytest
import torch

from repro.analysis import findings as ref_findings
from repro.analysis import registry as ref_registry
from repro.analysis.schedcheck import SchedChecker as RefChecker
from repro.serve import PagedKVCache as RefKV
from repro.serve import Scheduler as RefScheduler
from repro_torch.analysis import findings, registry
from repro_torch.analysis.schedcheck import SchedChecker
from repro_torch.configs import reduced_config
from repro_torch.models.model import LM
from repro_torch.serve.cache import PagedKVCache
from repro_torch.serve.engine import ContinuousBatchingEngine
from repro_torch.serve.scheduler import Scheduler

STACKS = {"port": (SchedChecker, PagedKVCache, Scheduler),
          "reference": (RefChecker, RefKV, RefScheduler)}


def _bare_pair(kv_cls, sched_cls, **kw):
    kv = kv_cls(n_slots=2, max_len=32, page_size=8, **kw)
    return kv, sched_cls(kv, prefill_chunk=4)


def _double_free(chk_cls, kv_cls, sched_cls):
    chk = chk_cls(*_bare_pair(kv_cls, sched_cls))
    chk.on_alloc(0, [3, 4])
    chk.on_free(0, [3, 4])
    chk.on_free(0, [3])
    return chk


def _claim_and_admission(chk_cls, kv_cls, sched_cls):
    chk = chk_cls(*_bare_pair(kv_cls, sched_cls))
    chk.on_incref(0, [9])
    chk.on_admit(0, 7, was_free=True, excluded=False)
    chk.on_admit(0, 0, was_free=False, excluded=False)
    chk.on_admit(0, 1, was_free=True, excluded=True)
    chk.on_preempt(0, younger_than=1, shard=None, order=[0, 1])
    return chk


def _live_double_free(chk_cls, kv_cls, sched_cls):
    kv, sched = _bare_pair(kv_cls, sched_cls)
    chk = chk_cls.attach(kv, sched)
    s = kv.admit(first_chunk=8)
    assert kv.grow(s, 8)
    pages = list(kv.slots[s].pages)
    kv.release(s)
    assert chk.findings == [] and chk.n_events >= 3
    with pytest.raises(RuntimeError):
        kv.table.free(pages)
    return chk


def _leaked_page(chk_cls, kv_cls, sched_cls):
    chk = chk_cls.attach(*_bare_pair(kv_cls, sched_cls))
    chk.kv.table.alloc(1)
    chk.check_drain()
    return chk


def _dual_rid_slot(chk_cls, kv_cls, sched_cls):
    kv, sched = _bare_pair(kv_cls, sched_cls)
    chk = chk_cls.attach(kv, sched)
    sched.submit(np.arange(1, 5), max_new_tokens=2)
    sched.submit(np.arange(1, 5), max_new_tokens=2)
    plan = sched.next_plan(step=0)
    sched.commit(plan, None, step=0)
    assert chk.check_step() == []
    s0, s1 = sorted(sched.active)
    sched.active[s1] = sched.active[s0]
    chk.check_step()
    return chk


def _prefix_pool_drain(chk_cls, kv_cls, sched_cls):
    """A clean history: shared-prefix requests through a prefix pool and
    a budget that preempts, to a full drain."""
    kv, sched = _bare_pair(kv_cls, sched_cls, prefix_pool=4, page_budget=6)
    chk = chk_cls.attach(kv, sched)
    rng = np.random.default_rng(0)
    shared = rng.integers(1, 50, size=16)
    for i in range(4):
        sched.submit(np.concatenate([shared, rng.integers(1, 50, size=3 + i)]),
                     max_new_tokens=4, step=0)
    step = 0
    while sched.has_work() and step < 200:
        plan = sched.next_plan(step)
        if plan is not None:
            sched.commit(plan, None, step)
            chk.check_step()
        step += 1
    chk.check_drain()
    assert sched.prefix_hit_tokens > 0
    return chk


SCENARIOS = {
    "double_free": (_double_free, ["double-free"]),
    "claim_and_admission": (_claim_and_admission,
                            ["prefix-double-claim", "illegal-admission",
                             "illegal-admission", "illegal-admission",
                             "illegal-preemption"]),
    "live_double_free": (_live_double_free, ["double-free"]),
    "leaked_page": (_leaked_page, ["page-leak"]),
    "dual_rid_slot": (_dual_rid_slot, ["slot-double-bind"]),
    "prefix_pool_drain": (_prefix_pool_drain, []),
}


@pytest.mark.parametrize("name", sorted(SCENARIOS))
def test_checker_copy_reports_what_the_original_reports(name):
    script, rules = SCENARIOS[name]
    got = {label: script(*stack) for label, stack in STACKS.items()}
    port, ref = ([(f.rule, f.severity) for f in got[k].findings]
                 for k in ("port", "reference"))
    assert port == ref
    assert [f.message for f in got["port"].findings] == \
        [f.message for f in got["reference"].findings]
    assert got["port"].n_events == got["reference"].n_events
    # the named faults are found (a leak also breaks the refcount pass)
    assert set(rules) <= set(r for r, _ in port)
    assert bool(rules) == bool(port)
    if name in ("double_free", "claim_and_admission", "live_double_free"):
        assert [r for r, _ in port] == rules
    assert [f.rule for f in got["port"].error_findings] == \
        [r for r, s in port if s == "error"]


def test_rule_table_and_finding_rows_equal_the_originals():
    assert {k: dataclasses.astuple(r)
            for k, r in registry.SCHED_RULES.items()} == \
        {k: dataclasses.astuple(r)
         for k, r in ref_registry.SCHED_RULES.items()}
    assert findings.SEVERITIES == ref_findings.SEVERITIES
    for ctx in (None, {"shard": 0, "pages": [1, 2]}):
        args = ("page-leak", "error", "<schedcheck:engine>", 0, "m", ctx)
        mine, ref = findings.Finding(*args), ref_findings.Finding(*args)
        assert mine.row() == ref.row() and mine.format() == ref.format()
    chk = SchedChecker(PagedKVCache(2, 32, 8))
    chk.on_free(0, [1])
    assert chk.rows() == [f.row() for f in chk.findings]


def test_engine_check_full_cycle_stays_clean():
    """submit -> prefix hit -> drain on a live port engine with
    check=True under a 6-page budget (tests/test_analysis.py's full
    cycle): the checker
    sees every transition, finds nothing, and an engine with check off
    has no checker."""
    cfg = reduced_config("granite-3-2b")
    model = LM(cfg, device="cpu")
    params = model.init_params(torch.Generator().manual_seed(0))
    page = 8
    eng = ContinuousBatchingEngine(model, params, n_slots=2, max_len=32,
                                   page_size=page, page_budget=6,
                                   prefill_chunk=8, prefix_cache=True,
                                   check=True)
    rng = np.random.default_rng(0)
    shared = rng.integers(1, cfg.vocab_size, size=2 * page)
    rids = [eng.submit(np.concatenate(
        [shared, rng.integers(1, cfg.vocab_size, size=3 + i)]), 4)
        for i in range(4)]
    out = eng.run()
    assert all(len(out[r]) == 4 for r in rids)
    assert eng.check_findings == [] and eng.checker.n_events > 0
    assert eng.sched.prefix_hit_tokens > 0
    off = ContinuousBatchingEngine(model, params, n_slots=1, max_len=16,
                                   page_size=8, check=False)
    assert off.checker is None and off.check_findings == []


def test_the_copies_import_neither_jax_nor_the_reference():
    """The engine, the checker copy and the drafter copy load no jax and
    no module of ``repro``."""
    root = pathlib.Path(__file__).resolve().parents[1]
    code = ("import sys, repro_torch.serve.engine, "
            "repro_torch.analysis.schedcheck, repro_torch.serve.draft; "
            "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'repro')); print(bad); sys.exit(bool(bad))")
    env = dict(os.environ, PYTHONPATH=str(root / "src"))
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, env=env, cwd=root)
    assert proc.returncode == 0, proc.stdout + proc.stderr
