"""The port's autotuner (``repro_torch.core.autotune``) and B1's tuned
split on the serving path, against the JAX package's
``repro.core.autotune`` on the CPU:

- ``cached_best_config`` with ``measure_group`` replaced, in both
  packages, by the same fixed medians: the same row, then a hit, a miss
  on a changed candidate grid, and ``retune``; the cache file is a
  Report the reference's validator accepts;
- ``tune_paged_attention``'s key is the reference's but for its impl
  field, and its candidates are the split counts ``split_plan`` makes;
- ``select_multiplier``'s structure: bigger tiles win until the on-chip
  budget, and the tile past it is flagged, as the reference's;
- the engine on the CPU: ``paged_meta`` says no sweep can be timed,
  ``retune=True`` raises, the ssm skips with the reference's reason, and
  ``paged_kernel=False`` tunes nothing; the CPU twin ignores a split.
"""
import dataclasses
import json

import numpy as np
import pytest
import torch

from repro.core import autotune as jax_autotune
from repro.perf import report as jax_report
from repro_torch.configs import reduced_config
from repro_torch.core import autotune
from repro_torch.core.costmodel import H100_SXM
from repro_torch.kernels.gemm import kernel as gemm_kernel
from repro_torch.kernels.paged_attention import kernel as pa_kernel
from repro_torch.kernels.paged_attention import ops as pa_ops
from repro_torch.kernels.stream import kernel as stream_kernel
from repro_torch.models.attention import PagedDecodeState
from repro_torch.models.model import LM
from repro_torch.serve.engine import ContinuousBatchingEngine


@dataclasses.dataclass
class _M:
    median_s: float
    all_s: list


def _fixed(medians):
    """A stand-in for measure_group: each label's fixed median (labels not
    in ``medians`` get one from their name), every sample at it, never
    calling a candidate."""
    def measure_group(candidates, reps=3, **kw):
        out = {}
        for k in candidates:
            t = medians.get(k, 1e-3 + 1e-6 * len(k))
            out[k] = _M(t, [t] * reps)
        return out
    return measure_group


MEDIANS = {"a": 3e-5, "b": 1e-5, "c": 2e-5, "d": 0.5e-5}


@pytest.fixture
def fixed(monkeypatch):
    monkeypatch.setattr(jax_autotune, "measure_group", _fixed(MEDIANS))
    monkeypatch.setattr(autotune, "measure_group", _fixed(MEDIANS))


def _both(tmp_path, labels, **kw):
    cands = {k: (None, ()) for k in labels}
    mine = autotune.cached_best_config("k1", cands,
                                       cache_path=tmp_path / "pt.json", **kw)
    ref = jax_autotune.cached_best_config("k1", cands,
                                          cache_path=tmp_path / "jax.json",
                                          **kw)
    return mine, ref


def test_cached_best_config_matches_the_reference(fixed, tmp_path):
    mine, ref = _both(tmp_path, "abc")
    assert mine == ref
    assert mine["source"] == "measured" and mine["best"] == "b"
    # a hit
    mine, ref = _both(tmp_path, "abc")
    assert mine == ref and mine["source"] == "cache"
    # a changed candidate grid misses, and replaces the row
    mine, ref = _both(tmp_path, "abcd")
    assert mine == ref and mine["source"] == "measured"
    assert mine["best"] == "d"
    # retune measures again
    mine, ref = _both(tmp_path, "abcd", retune=True)
    assert mine == ref and mine["source"] == "measured"
    rows = [json.loads((tmp_path / f).read_text())["rows"]
            for f in ("pt.json", "jax.json")]
    assert rows[0] == rows[1] and len(rows[0]) == 1


def test_cache_file_is_a_valid_report(fixed, tmp_path):
    autotune.cached_best_config("k1", {"a": (None, ()), "b": (None, ())},
                                cache_path=tmp_path / "c.json")
    autotune.cached_best_config("k2", {"c": (None, ())},
                                cache_path=tmp_path / "c.json")
    payload = json.loads((tmp_path / "c.json").read_text())
    assert jax_report.validate(payload) == []
    assert [r["key"] for r in payload["rows"]] == ["k1", "k2"]
    assert payload["benchmark"] == "autotune_cache"
    # written by rename: no temporary file is left beside it
    assert sorted(p.name for p in tmp_path.iterdir()) == ["c.json"]


def test_cache_lives_in_build():
    assert autotune.AUTOTUNE_CACHE_PATH.parent.name == "build"
    assert "benchmarks" not in autotune.AUTOTUNE_CACHE_PATH.parts


GRANITE_DECODE = dict(n_slots=8, max_len=512, page_size=16, n_kv_heads=8,
                      n_q_heads=32, head_dim=64, dtype="bfloat16")


def test_tune_paged_attention_key_follows_the_reference(fixed, tmp_path):
    mine = autotune.tune_paged_attention(**GRANITE_DECODE, device="cpu",
                                         cache_path=tmp_path / "pt.json")
    ref = jax_autotune.tune_paged_attention(
        **GRANITE_DECODE, cache_path=tmp_path / "jax.json")
    assert mine["key"].split("/")[:-1] == ref["key"].split("/")[:-1]
    assert mine["key"].split("/")[-1] == autotune.PAGED_IMPL
    assert set(ref) <= set(mine) | {"block_pages"}
    assert mine["source"] == ref["source"] == "measured"
    # every distinct count split_plan makes of a forced 1..MAX_SPLITS
    want = sorted({pa_kernel.split_plan(8, 8, 4, 512, H100_SXM.sm_count,
                                        head_dim=64, splits=s).splits
                   for s in range(1, pa_kernel.MAX_SPLITS + 1)})
    assert sorted(int(k[1:]) for k in mine["medians_s"]) == want
    # the plan's own count at granite's decode on an H100 SXM, kept: the
    # stand-in's medians are all alike
    assert mine["plan_splits"] == 3 and mine["splits"] == 3
    assert "kept" in mine["why"]
    assert mine["kv_valid"] == [64, 128, 192, 256, 320, 384, 448, 512]
    assert mine["reps"] == autotune.PAGED_REPS
    again = autotune.tune_paged_attention(**GRANITE_DECODE, device="cpu",
                                          cache_path=tmp_path / "pt.json")
    assert again["source"] == "cache" and again["splits"] == mine["splits"]
    assert again["spread_s"] == mine["spread_s"]


def _rounds(*pairs, n=15):
    """Per-round samples: each label's time alternating between its two
    values round by round."""
    return {k: [(a, b)[i % 2] for i in range(n)] for k, a, b in pairs}


@pytest.mark.parametrize("samples,want", [
    # a count 19% under the plan in every round: taken
    (_rounds(("s1", 3.4, 3.4), ("s2", 2.6, 2.6), ("s3", 3.2, 3.2),
             ("s4", 3.3, 3.3)), 2),
    # faster in every round but by 6%, as at granite's decode: kept
    (_rounds(("s1", 3.4, 3.4), ("s2", 3.0, 3.0), ("s3", 3.2, 3.2),
             ("s4", 3.3, 3.3)), 3),
    # 25% under the plan's median but faster in half the rounds: kept
    (_rounds(("s1", 3.4, 3.4), ("s2", 2.4, 3.5), ("s3", 3.2, 3.2),
             ("s4", 3.3, 3.3)), 3),
    # two counts past both bars: the faster
    (_rounds(("s1", 3.4, 3.4), ("s2", 2.6, 2.6), ("s3", 3.2, 3.2),
             ("s4", 2.5, 2.5)), 4),
])
def test_pick_splits_keeps_the_plan_unless_beaten(samples, want):
    got, why = autotune.pick_splits(samples, 3)
    assert got == want and why
    assert ("kept" in why) == (want == 3)


def test_tune_paged_attention_takes_a_count_that_beats_the_plan(monkeypatch,
                                                            tmp_path):
    """Split count 2 faster than the plan's 3 in every round: served at
    2, and the cache gives the same pick."""
    meds = {"s1": 4e-5, "s2": 2e-5, "s3": 3e-5, "s4": 2.5e-5}
    monkeypatch.setattr(autotune, "measure_group", _fixed(meds))
    got = autotune.tune_paged_attention(**GRANITE_DECODE, device="cpu",
                                        cache_path=tmp_path / "c.json")
    assert got["best"] == "s2" and got["splits"] == 2
    assert "beat split_plan" in got["why"]
    again = autotune.tune_paged_attention(**GRANITE_DECODE, device="cpu",
                                          cache_path=tmp_path / "c.json")
    assert (again["source"], again["splits"]) == ("cache", 2)


def test_tune_rejects_another_impl(tmp_path):
    with pytest.raises(ValueError, match="cuda_paged_partials"):
        autotune.tune_paged_attention(**GRANITE_DECODE, impl="pallas",
                                      device="cpu", cache_path=tmp_path)


def test_select_multiplier_structure_follows_the_reference():
    """Bigger tiles win until the on-chip budget; the tile past it is
    flagged and not picked (the reference: VMEM; here registers)."""
    ref_best, ref_reports = jax_autotune.select_multiplier(
        jax_autotune.gemm_shape(4096, 4096, 4096, bk=512))
    assert ref_best >= 2
    for dtype in (torch.float32, torch.float64):
        best, reports = autotune.select_multiplier(
            autotune.gemm_shape(4096, 4096, 4096, dtype))
        by = {r.multiplier: r for r in reports}
        assert 2 <= best < 8
        assert by[1].predicted_s > by[best].predicted_s
        assert not by[8].fits_vmem and by[8].spill and by[8].bound == "spill"
        assert by[best].fits_vmem
    # fp64 accumulators take two registers: the cliff comes at m 4
    fp64 = {r.multiplier: r for r in autotune.select_multiplier(
        autotune.gemm_shape(4096, 4096, 4096, torch.float64))[1]}
    assert fp64[4].spill and not fp64[2].spill


def test_gemm_shape_reads_the_kernel_plan():
    ks = autotune.gemm_shape(1000, 300, 700, torch.float64)
    for m, p in ks.plans.items():
        plan = gemm_kernel.plan(1000, 700, 300, torch.float64, m)
        assert p.blocks == plan.grid[0] * plan.grid[1]
        assert p.smem_bytes == plan.smem
        bm, bn, _ = gemm_kernel.TILES[m] + (0,)
        assert p.acc_regs == bm * bn // gemm_kernel.THREADS * 2
        assert p.threads == gemm_kernel.THREADS


def test_stream_shape_reads_the_kernel_plan():
    n = (1 << 20) + 3
    ks = autotune.stream_shape(n)
    for m, p in ks.plans.items():
        assert p.blocks == stream_kernel.plan(n, m).grid
        assert p.blocks == -(-(-(-n // 4)) // (256 * m))
    red = autotune.grid_reduction(ks)
    # the ragged last block: 1025 blocks at m 1, 129 at m 8
    assert red[1] == 1.0 and red[8] == 1025 / 129


def test_predict_waves_and_occupancy():
    ks = autotune.stream_shape(1 << 26)
    r = autotune.predict(ks, 1)
    # 40 registers x 256 threads: 6 blocks an SM by the register file
    assert (r.regs_per_thread, r.blocks_per_sm) == (40, 6)
    assert r.waves == -(-ks.plans[1].blocks // (6 * H100_SXM.sm_count))
    # a block past the shared-memory budget cannot launch
    ks = autotune.flash_shape(4096, 128, 16)
    assert autotune.predict(ks, 8).bound == "smem"
    assert autotune.select_multiplier(ks)[0] == 1


def test_measured_sweep_needs_the_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    x = torch.ones(4)
    with pytest.raises(RuntimeError):
        autotune.measured_sweep({"a": (lambda x: x, (x,))})


# ---------------------------------------------------------------------------
# B1's split on the serving path, on the CPU
# ---------------------------------------------------------------------------
def _engine(arch, **kw):
    cfg = reduced_config(arch)
    model = LM(cfg, device="cpu")
    params = model.init_params(torch.Generator().manual_seed(0))
    return model, params, ContinuousBatchingEngine(
        model, params, n_slots=2, max_len=32, page_size=8, **kw)


def test_engine_paged_meta_on_the_cpu():
    _, _, eng = _engine("granite-3-2b")
    assert "CPU" in eng.paged_meta["skipped"]
    assert eng._paged_splits is None
    _, _, off = _engine("granite-3-2b", paged_kernel=False)
    assert off.paged_meta is None


def test_engine_retune_raises_on_the_cpu():
    model, params, _ = _engine("granite-3-2b")
    with pytest.raises(RuntimeError, match="CUDA card"):
        ContinuousBatchingEngine(model, params, n_slots=2, max_len=32,
                                 page_size=8, retune=True)


def test_engine_ssm_skips_as_the_reference():
    _, _, eng = _engine("mamba2-780m")
    assert eng.paged_meta == {
        "skipped": "family 'ssm' has no attention KV cache"}
    # retune has nothing to measure there either
    model, params, _ = _engine("mamba2-780m")
    eng = ContinuousBatchingEngine(model, params, n_slots=2, max_len=32,
                                   retune=True)
    assert "ssm" in eng.paged_meta["skipped"]


def test_cpu_twin_ignores_the_split():
    rng = np.random.default_rng(0)
    q = torch.from_numpy(rng.standard_normal((2, 1, 8, 64))).float()
    kp = torch.from_numpy(rng.standard_normal((8, 16, 2, 64))).float()
    vp = torch.from_numpy(rng.standard_normal((8, 16, 2, 64))).float()
    idx = torch.arange(8, dtype=torch.int32).view(2, 4)
    pos = torch.tensor([[40], [63]], dtype=torch.int32)
    valid = torch.tensor([41, 64], dtype=torch.int32)
    a = pa_ops.paged_attention(q, kp, vp, idx, pos, valid, page_size=16)
    b = pa_ops.paged_attention(q, kp, vp, idx, pos, valid, page_size=16,
                               splits=3)
    assert torch.equal(a, b)
    assert PagedDecodeState(None, 16).splits is None
