"""The port's analytic cost model against the reference's, on the CPU.

- ``ModelConfig.param_counts`` (R7's miscounts kept), ``forward_flops``
  (decode and prefill, with and without the encoder), ``step_flops``,
  ``model_flops``, ``param_bytes``, ``step_hbm_bytes`` and
  ``_cache_bytes`` equal the reference's exactly, for all ten archs,
  full and reduced, at a few shapes;
- ``StepCostModel.step_cost`` equals the reference's;
- ``modeled_step_time`` is ``max(flops / peak(compute dtype), bytes /
  hbm_bw)`` of the engine's ``hw``, which a test may set;
- ``EngineStats`` of both engines accumulate the reference's modeled
  flops and bytes.
"""
import dataclasses

import numpy as np
import pytest

import jax

from repro.configs import ARCH_IDS as JAX_ARCH_IDS
from repro.configs import get_config as jax_get_config
from repro.configs import reduced_config as jax_reduced_config
from repro.configs.shapes import ShapeSpec as JaxShapeSpec
from repro.core import costmodel as jax_costmodel
from repro.models import build_model as jax_build_model
from repro.serve import ContinuousBatchingEngine as JaxEngine
from repro.serve import StaticBatchEngine as JaxStatic
from repro.serve.engine import StepCostModel as JaxStepCostModel
from repro_torch.configs import ARCH_IDS, get_config, reduced_config
from repro_torch.configs.shapes import ShapeSpec
from repro_torch.core import costmodel
from repro_torch.models.model import LM
from repro_torch.serve.engine import (ContinuousBatchingEngine,
                                      StaticBatchEngine, StepCostModel)
from repro_torch.weights import params_from_numpy

CONFIGS = [(arch, size) for arch in ARCH_IDS for size in ("full", "reduced")]
# (name, seq_len, batch, kind)
SHAPES = [("train", 128, 4, "train"), ("train_long", 4096, 1, "train"),
          ("prefill", 512, 8, "prefill"), ("decode", 288, 8, "decode"),
          ("decode_long", 32768, 1, "decode")]


def _pair(arch, size):
    if size == "full":
        return get_config(arch), jax_get_config(arch)
    return reduced_config(arch), jax_reduced_config(arch)


def test_arch_ids_and_shape_spec_are_the_references():
    assert sorted(ARCH_IDS) == sorted(JAX_ARCH_IDS)
    assert [f.name for f in dataclasses.fields(ShapeSpec)] == \
        [f.name for f in dataclasses.fields(JaxShapeSpec)]
    assert dataclasses.asdict(costmodel.ImplOpts()) == \
        dataclasses.asdict(jax_costmodel.ImplOpts())


@pytest.mark.parametrize("arch,size", CONFIGS)
def test_cost_model_equals_the_references(arch, size):
    cfg, jcfg = _pair(arch, size)
    assert cfg.param_counts() == jcfg.param_counts()
    assert costmodel.param_bytes(cfg) == jax_costmodel.param_bytes(jcfg)
    for enc in (True, False):
        for seq, batch in ((1, 1), (1, 8), (512, 1), (96, 4)):
            assert costmodel.forward_flops(
                cfg, batch, seq, include_encoder=enc) == \
                jax_costmodel.forward_flops(jcfg, batch, seq,
                                            include_encoder=enc)
            assert costmodel.forward_flops(
                cfg, batch, seq, kv_len=256, decode=True,
                include_encoder=enc) == jax_costmodel.forward_flops(
                    jcfg, batch, seq, kv_len=256, decode=True,
                    include_encoder=enc)
    opts = costmodel.ImplOpts(block_causal=False, remat="none")
    jopts = jax_costmodel.ImplOpts(block_causal=False, remat="none")
    for spec in SHAPES:
        shape, jshape = ShapeSpec(*spec), JaxShapeSpec(*spec)
        assert costmodel.step_flops(cfg, shape) == \
            jax_costmodel.step_flops(jcfg, jshape)
        assert costmodel.step_flops(cfg, shape, opts) == \
            jax_costmodel.step_flops(jcfg, jshape, jopts)
        assert costmodel.model_flops(cfg, shape) == \
            jax_costmodel.model_flops(jcfg, jshape)
        assert costmodel.step_hbm_bytes(cfg, shape) == \
            jax_costmodel.step_hbm_bytes(jcfg, jshape)
        assert costmodel.step_hbm_bytes(cfg, shape, opts) == \
            jax_costmodel.step_hbm_bytes(jcfg, jshape, jopts)
        assert costmodel._cache_bytes(cfg, spec[2], spec[1]) == \
            jax_costmodel._cache_bytes(jcfg, spec[2], spec[1])


def test_param_counts_keep_the_references_miscounts():
    """R7: the vlm counts a self-attention block in each cross layer,
    whisper leaves out its decoder's cross-attention; kept, so the
    modeled clock is the reference's."""
    vlm = get_config("llama-3.2-vision-90b")
    total, _ = vlm.param_counts()
    assert total == pytest.approx(90.69e9, rel=1e-3)
    audio = get_config("whisper-base")
    assert audio.param_counts()[0] == pytest.approx(90.98e6, rel=1e-3)


@pytest.mark.parametrize("arch,size", CONFIGS)
def test_step_cost_model_equals_the_references(arch, size):
    cfg, jcfg = _pair(arch, size)
    for max_len in (32, 512):
        mine, ref = StepCostModel(cfg, max_len), JaxStepCostModel(jcfg,
                                                                  max_len)
        assert vars(mine) == vars(ref)
        for n_decode, n_prefill in ((0, 0), (8, 0), (0, 32), (3, 17),
                                    (8, 256)):
            assert mine.step_cost(n_decode, n_prefill) == \
                ref.step_cost(n_decode, n_prefill)


@pytest.fixture(scope="module")
def granite():
    arch = "granite-3-2b"
    jmodel = jax_build_model(jax_reduced_config(arch))
    jparams = jmodel.init_params(jax.random.key(0))
    model = LM(reduced_config(arch), device="cpu")
    params = params_from_numpy(jax.tree.map(np.asarray, jparams), "cpu")
    return jmodel, jparams, model, params


def test_modeled_step_time_is_the_roofline_of_the_engines_hw(granite):
    _, _, model, params = granite
    eng = ContinuousBatchingEngine(model, params, n_slots=2, max_len=32,
                                   page_size=8)
    assert eng.hw == costmodel.H100_SXM             # the CPU's stand-in
    for hw in (costmodel.H100_SXM, costmodel.H100_PCIE,
               costmodel.HWSpec(name="test", hbm_bw=1e9, l2_bytes=0.0,
                                peak_flops_bf16=1e15, peak_flops_tf32=1e14,
                                peak_flops_fp32=3e9, peak_flops_fp64=1e9)):
        eng.hw = hw
        for n_decode, n_prefill in ((2, 0), (0, 8), (1, 5), (2, 16)):
            fl, by = eng._cost.step_cost(n_decode, n_prefill)
            # the reduced config computes in fp32: the fp32 peak
            want = max(fl / hw.peak_flops_fp32, by / hw.hbm_bw)
            assert eng.modeled_step_time(n_decode, n_prefill) == want
    bf16 = StepCostModel(get_config("granite-3-2b"), 512)
    fl, by = bf16.step_cost(8, 0)
    # the full-width decode step of 8 rows at max_len 512 on the SXM part
    t = max(fl / costmodel.H100_SXM.peak_flops_bf16,
            by / costmodel.H100_SXM.hbm_bw)
    assert (fl, by) == pytest.approx((4.12e10, 5.24e9), rel=2e-3)
    assert t * 1e3 == pytest.approx(1.563, rel=1e-3)


def test_engine_stats_accumulate_the_references_modeled_work(granite):
    jmodel, jparams, model, params = granite
    rng = np.random.default_rng(4)
    prompts = [rng.integers(1, model.cfg.vocab_size, size=n)
               for n in (5, 11, 7)]
    kw = dict(n_slots=2, max_len=32, page_size=8, prefill_chunk=4)
    eng = ContinuousBatchingEngine(model, params, **kw)
    jeng = JaxEngine(jmodel, jparams, **kw)
    for e in (eng, jeng):
        for p in prompts:
            e.submit(p, 4)
        e.run()
    assert eng.stats.model_flops == jeng.stats.model_flops > 0
    assert eng.stats.model_bytes == jeng.stats.model_bytes > 0
    static = StaticBatchEngine(model, params, max_len=32, batch=2)
    jstatic = JaxStatic(jmodel, jparams, max_len=32, batch=2)
    toks = np.stack([prompts[0], prompts[2][:5]])
    static.generate(toks, n_steps=3)
    jstatic.generate(jax.numpy.asarray(toks), n_steps=3)
    assert (static.stats.model_flops, static.stats.model_bytes) == \
        (jstatic.stats.model_flops, jstatic.stats.model_bytes)
    assert static.stats.summary()["model_tflops_per_s"] is None
