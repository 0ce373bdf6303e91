"""The port's examples (``repro_torch.examples``), the counterparts of the
scripts under ``examples/``, on the CPU at reduced configs:

- each ``main`` runs with ``--device cpu`` and returns what it printed;
- quickstart's loss falls over its train steps and its greedy tokens are
  the JAX engine's on the same weights (fp32, passed through numpy);
- serve_decode recycles slots, and ``--mesh`` / ``--sp-kv`` (and
  qsim_demo's ``--distributed``) raise naming ROADMAP A10, as the
  launcher's ``NOT_PORTED`` does;
- autotune_demo's pick is the cost model's, its kernel check passes;
- qsim_demo's versions agree with the JAX package's on the same circuit;
- importing the new modules leaves jax (and the reference) out.
"""
import os
import pathlib
import subprocess
import sys

import numpy as np
import pytest
import torch

from repro_torch.examples import (autotune_demo, qsim_demo, quickstart,
                                  serve_decode)

ROOT = pathlib.Path(__file__).resolve().parents[1]


def test_quickstart_on_the_cpu(capsys):
    out = quickstart.main(["--device", "cpu", "--arch", "granite-3-2b"])
    assert len(out["losses"]) == 3 and out["losses"][-1] < out["losses"][0]
    assert out["tokens"].shape == (2, 8)
    assert "CPU" in out["paged_meta"]["skipped"]
    assert "generated:" in capsys.readouterr().out


def test_quickstart_greedy_tokens_are_the_jax_engines():
    """The serve half of the quickstart: the port's continuous engine
    against the JAX one on the same fp32 reduced weights and prompt."""
    import jax

    from repro.configs import reduced_config as jax_reduced
    from repro.models import build_model
    from repro.serve import ContinuousBatchingEngine as JaxEngine
    from repro_torch.configs import reduced_config
    from repro_torch.models.model import LM
    from repro_torch.serve import ContinuousBatchingEngine
    from repro_torch.weights import params_from_numpy
    jcfg = jax_reduced("granite-3-2b")
    jmodel = build_model(jcfg)
    jparams = jmodel.init_params(jax.random.key(0))
    rng = np.random.default_rng(0)
    prompt = rng.integers(1, jcfg.vocab_size, size=(2, 16))
    want = np.asarray(JaxEngine(jmodel, jparams, n_slots=2, max_len=64,
                                page_size=8).generate(prompt, n_steps=8))
    model = LM(reduced_config("granite-3-2b"), device="cpu")
    params = params_from_numpy(jax.tree_util.tree_map(np.asarray, jparams),
                               device="cpu")
    got = ContinuousBatchingEngine(model, params, n_slots=2, max_len=64,
                                   page_size=8).generate(prompt, n_steps=8)
    np.testing.assert_array_equal(got.numpy(), want)


def test_quickstart_serves_a_cross_attention_family():
    out = quickstart.main(["--device", "cpu", "--arch", "whisper-base"])
    assert out["losses"] == [] and out["tokens"].shape == (2, 8)


def test_serve_decode_on_the_cpu(capsys):
    out = serve_decode.main(["--device", "cpu", "--requests", "5"])
    eng = out["engine"]
    assert len(out["results"]) == 5
    assert any(r.admit_step > 0 for r in eng.requests())
    assert "admitted into recycled slots" in capsys.readouterr().out


def test_serve_decode_open_loop_on_the_model_clock():
    out = serve_decode.main(["--device", "cpu", "--open-loop", "--rate",
                             "2000", "--requests", "4"])
    assert out["latency"]["completed"] == 4


def test_serve_decode_features_on_the_cpu():
    out = serve_decode.main(["--device", "cpu", "--arch", "mamba2-780m",
                             "--speculative", "--requests", "3"])
    assert out["engine"].spec_decode and len(out["results"]) == 3
    with pytest.warns(UserWarning, match="prefix_cache=True ignored"):
        serve_decode.main(["--device", "cpu", "--arch", "mamba2-780m",
                           "--prefix-cache", "--requests", "2"])


@pytest.mark.parametrize("flag", [["--mesh", "2"], ["--sp-kv"]])
def test_serve_decode_sharding_is_not_ported(flag):
    with pytest.raises(NotImplementedError, match="A10"):
        serve_decode.main(["--device", "cpu", *flag])


def test_autotune_demo_on_the_cpu():
    from repro_torch.core import autotune
    out = autotune_demo.main(["--device", "cpu", "--size", "2048"])
    assert out["best"] == autotune.select_multiplier(
        autotune.gemm_shape(2048, 2048, 2048))[0]
    assert out["measured"] is None and out["max_abs_err"] < 1e-3
    assert out["verdicts"]["op_histogram"]


def test_qsim_demo_on_the_cpu_follows_the_jax_versions():
    import jax.numpy as jnp

    from repro.quantum import gates as jax_gates
    from repro.quantum import qsim as jax_qsim
    out = qsim_demo.main(["--device", "cpu", "--qubits", "8", "--depth",
                          "3"])
    assert set(out) == {"autovec/interleaved", "autovec/planar",
                        "kernel/planar"}
    circuit = jax_gates.random_circuit(8, 3, seed=7)
    want = np.asarray(jax_qsim.run_autovec_complex(
        jax_qsim.init_state(8), circuit))
    for v in out.values():
        assert v["fidelity"] >= 1 - 1e-5
        assert v["amp0"] == pytest.approx(abs(want[0]), abs=1e-5)
    assert jnp is not None


def test_qsim_demo_distributed_is_not_ported():
    with pytest.raises(NotImplementedError, match="A10"):
        qsim_demo.main(["--device", "cpu", "--distributed"])


def test_examples_default_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises((RuntimeError, AssertionError)):
        qsim_demo.main(["--qubits", "4"])


def test_new_modules_leave_jax_out():
    code = ("import sys, repro_torch, repro_torch.examples.quickstart, "
            "repro_torch.examples.serve_decode, "
            "repro_torch.examples.autotune_demo, "
            "repro_torch.examples.qsim_demo, repro_torch.core.autotune, "
            "repro_torch.core.counters, repro_torch.core.ophist, "
            "repro_torch.perf.channels, repro_torch.figures.table1_counters, "
            "repro_torch.figures.fig4_arith, "
            "repro_torch.figures.fig5_proxyapps, "
            "repro_torch.figures.fig6_breakdown, "
            "repro_torch.figures.fig7_lmul, "
            "repro_torch.figures.fig8_pressure; "
            "bad = sorted(m for m in sys.modules if m == 'jax' "
            "or m.startswith('jax.') or m == 'repro' "
            "or m.startswith('repro.')); print(bad); sys.exit(bool(bad))")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, env=env, cwd=ROOT)
    assert proc.returncode == 0, proc.stdout + proc.stderr


@pytest.mark.parametrize("name", ["quickstart", "serve_decode",
                                  "autotune_demo", "qsim_demo"])
def test_examples_run_as_modules(name):
    """``python -m repro_torch.examples.<name> --help`` parses (the CPU
    runs are the tests above)."""
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    proc = subprocess.run(
        [sys.executable, "-m", f"repro_torch.examples.{name}", "--help"],
        capture_output=True, text=True, env=env, cwd=ROOT)
    assert proc.returncode == 0 and "--device" in proc.stdout, proc.stderr
