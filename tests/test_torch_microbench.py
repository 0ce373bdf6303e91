"""The port's microbenchmark suite (``repro_torch.core.microbench``) against
the JAX package's (``repro.core.microbench``) on the CPU, without timing:
the same rows in the same order with the same keys, except that the TPU
ceiling ``model_tpu_gops`` becomes the card's ``bound_gops`` with ``hw``
naming the spec; and the suites' expressions compute what the JAX ones
compute on the same inputs."""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from repro.core import microbench as jax_mb
from repro_torch.core import microbench as pt_mb
from repro_torch.core.costmodel import H100_SXM
from repro_torch.kernels.strided import ops as strided_ops

CPU = torch.device("cpu")


def test_rows_have_the_reference_keys_with_the_ceiling_renamed():
    want = jax_mb.run_suite(measure=False)
    got = pt_mb.run_suite(measure=False, device=CPU)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert set(g) == (set(w) - {"model_tpu_gops"}) | {"bound_gops",
                                                          "hw"}
        for key in ("name", "dtype", "flops_per_elem", "bytes_per_elem"):
            assert g[key] == w[key], key
        assert g["hw"] == "h100_sxm" and g["host_gops"] is None


def test_ceilings_are_the_cards():
    rows = {(r["name"], r["dtype"]): r
            for r in pt_mb.run_suite(measure=False, device=CPU)}
    triad = rows[("triad", "float32")]
    assert triad["bound_gops"] == pytest.approx(3.35e12 / 12 / 1e9)
    fma = rows[("vfma", "bfloat16")]
    assert fma["bound_gops"] == pytest.approx(3.35e12 / 6 * 2 / 1e9)
    for r in rows.values():
        assert 0 < r["bound_gops"] <= H100_SXM.peak_flops_fp32 / 1e9


@pytest.mark.parametrize("op", ["add", "mul", "fma", "div"])
def test_arithmetic_expressions_match_jax(op):
    rng = np.random.default_rng(0)
    x = rng.random(256).astype(np.float32)
    y = (rng.random(256) + 0.5).astype(np.float32)
    got = pt_mb._ARITH[op][0](torch.from_numpy(x), torch.from_numpy(y))
    want = jax_mb._ARITH[op][0](jnp.asarray(x), jnp.asarray(y))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6)
    assert pt_mb._ARITH[op][1] == jax_mb._ARITH[op][1]


def test_memory_rows_gather_what_the_jax_rows_gather():
    """The strided rows call the port's strided kernels; on the same input
    they keep the rows the JAX expressions keep (x[::s], and the rows
    where i % s == 0)."""
    x = np.random.default_rng(2).random((64, 128)).astype(np.float32)
    for s in (2, 4, 8):
        want = np.asarray(jnp.asarray(x)[::s])
        for idiom in ("strided_rowwise", "overfetch_select"):
            got = strided_ops.strided_gather(torch.from_numpy(x), s, idiom)
            np.testing.assert_array_equal(got.numpy(), want)


def test_measure_needs_the_card():
    with pytest.raises((RuntimeError, ValueError)):
        pt_mb.memory_suite(rows=64, measure=True, device=CPU)


# ---------------------------------------------------------------------------
# the Fig 2 and Fig 3 drivers, without timing
# ---------------------------------------------------------------------------
from repro_torch.figures import fig2_strided, fig3_tail  # noqa: E402


def test_fig2_rows_and_output_lengths(monkeypatch):
    monkeypatch.setattr(fig2_strided, "SCALAR_MAX_ROWS", 300)
    rows = fig2_strided.run(CPU, 1001, measure=False)
    assert [(r["stride"], r["idiom"]) for r in rows] == [
        (s, i) for s in (2, 4, 8)
        for i in ("strided_rowwise", "overfetch_select", "scalar")]
    for r in rows:
        s = r["stride"]
        assert r["out_rows"] == (1001 // s if r["idiom"] == "overfetch_select"
                                 else -(-1001 // s))
        assert r["bound_gelem_per_s"] == pytest.approx(3.35e12 / 8 / 1e9)
        assert r["gelem_per_s"] is None
        # the scalar loop past the cap is left out with its reason
        assert (r["omitted"] is not None) == (
            r["idiom"] == "scalar" and -(-1001 // s) > 300)


def test_fig2_uses_the_jax_size():
    assert (fig2_strided.ROWS, fig2_strided.LANE) == (1 << 13, 128)
    assert fig2_strided.CARD_ROWS * 128 * 4 == 1 << 30


def test_fig3_rows_and_bytes_penalty():
    rows = fig3_tail.run(CPU, 1000, measure=False)
    assert [r["active_frac"] for r in rows] == [0.5, 0.75, 0.9, 0.99]
    for r in rows:
        assert r["n_valid"] == int(1000 * r["active_frac"]) * 128
        assert r["bytes_penalty"] == pytest.approx(
            1 - r["n_valid"] / (1000 * 128))
        assert r["penalty"] is None


def test_fig3_raises_when_an_idiom_is_wrong(monkeypatch):
    from repro_torch.kernels.tailmask import ref as tail_ref
    real = tail_ref.compute_masked
    monkeypatch.setattr(tail_ref, "compute_masked",
                        lambda x, n: real(x, n + 128))
    with pytest.raises(AssertionError, match="masked"):
        fig3_tail.run(CPU, 64, measure=False)
