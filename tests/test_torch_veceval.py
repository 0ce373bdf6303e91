"""The port's proxy-app harness (``repro_torch.core.veceval``) against the
JAX package's (``repro.core.veceval``) at small sizes on the CPU:

- the builders make the same inputs, bit for bit, from the same seeds;
- the port's scalar, autovec and kernel versions each match the JAX
  autovec version on those inputs (dgemm built with x64 on the JAX side,
  so both are f64);
- rows carry the JAX keys (``tpu_model_seconds`` -> ``bound_seconds`` and
  ``hw``), ``measure=True`` needs the card, and ``run_all`` runs.

Tolerances: fp32 1e-5 (roundoff of sums in another order), f64 1e-12.
"""
import inspect

import numpy as np
import pytest
import torch

import jax

from repro.core import veceval as jax_ve
from repro_torch.core import veceval as pt_ve

SIZES = {
    "stream": dict(n=4096),
    "spmv": dict(rows=72, cols=200, nnz=8),
    "sgemm": dict(M=64, K=48, N=40),
    "dgemm": dict(M=64, K=48, N=40),
    "alexnet": dict(H=16, W=16, Cin=4),
    "yolov3": dict(H=16, W=16, Cin=4),
}
APPS = list(SIZES)
JAX_SPECS = {"alexnet": [(3, 32), (3, 64), (3, 64)],
             "yolov3": [(1, 8), (3, 32), (1, 16), (3, 32)]}


def _jax_app(name):
    kw = SIZES[name]
    if name == "stream":
        return jax_ve.build_stream(kw["n"])
    if name == "spmv":
        return jax_ve.build_spmv(kw["rows"], kw["cols"], kw["nnz"])
    if name in ("sgemm", "dgemm"):
        dt = jax.numpy.float32 if name == "sgemm" else jax.numpy.float64
        return jax_ve._gemm_app(name, dt, kw["M"], kw["K"], kw["N"])
    return jax_ve._conv_net(name, JAX_SPECS[name], kw["H"], kw["W"],
                            kw["Cin"])


def _both(name):
    """(port app on the CPU, JAX app) at the small size; the JAX app's
    version functions must run under the same x64 setting."""
    pt = pt_ve.BUILDERS[name](**SIZES[name], device="cpu")
    with jax.enable_x64(name == "dgemm"):
        ja = _jax_app(name)
        want = np.asarray(
            [v for v in ja.versions if v.name == "autovec"][0].fn(
                *ja.versions[1].args))
        inputs = [np.asarray(a) for a in ja.versions[0].args]
    return pt, want, inputs


def test_conv_specs_are_the_reference_stacks():
    assert pt_ve.ALEXNET_SPECS == JAX_SPECS["alexnet"]
    assert pt_ve.YOLOV3_SPECS == JAX_SPECS["yolov3"]


@pytest.mark.parametrize("name", APPS)
def test_builders_make_identical_inputs(name):
    pt, _, inputs = _both(name)
    for v in pt.versions:
        got = [a.numpy() for a in v.args]
        assert len(got) == len(inputs)
        for g, w in zip(got, inputs):
            assert g.dtype == w.dtype and g.shape == w.shape
            np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("name", APPS)
def test_versions_match_jax_autovec(name):
    pt, want, _ = _both(name)
    tol = 1e-12 if name == "dgemm" else 1e-5
    assert {v.name for v in pt.versions} == set(pt_ve.VERSIONS)
    for v in pt.versions:
        got = v.fn(*v.args).numpy()
        assert got.shape == want.shape, v.name
        np.testing.assert_allclose(got, want, rtol=tol, atol=tol,
                                   err_msg=f"{name} {v.name}")


def test_analytic_counts_follow_the_reference():
    """flops are the JAX app's; bytes count every input once and every
    output once (the JAX spmv model leaves out the output)."""
    for name in APPS:
        pt, _, _ = _both(name)
        with jax.enable_x64(name == "dgemm"):
            ja = _jax_app(name)
        assert pt.flops == ja.flops, name
        if name in ("stream", "sgemm", "dgemm"):
            assert pt.bytes_moved == ja.bytes_moved, name
    kw = SIZES["spmv"]
    spmv = pt_ve.build_spmv(**kw, device="cpu")
    assert spmv.bytes_moved == jax_ve.build_spmv(**kw).bytes_moved \
        + kw["rows"] * 4


ROW_KEYS = {"app", "version", "host_seconds", "bound_seconds", "hw",
            "flops", "flops_source", "bytes", "bytes_source", "hlo_ops",
            "instruction_classes", "op_reduction_vs_scalar",
            "useful_flops"}


def test_rows_carry_the_reference_keys():
    app = pt_ve.build_stream(4096, device="cpu")
    rows = pt_ve.evaluate_app(app, measure=False)
    assert [r["version"] for r in rows] == list(pt_ve.VERSIONS)
    for r in rows:
        assert ROW_KEYS <= set(r), ROW_KEYS - set(r)
        assert "tpu_model_seconds" not in r
        assert r["host_seconds"] is None and r["hw"] == "h100_sxm"
        assert r["bound_seconds"] == pytest.approx(4096 * 12 / 3.35e12)
        # stream is elementwise-only: the flop counter is blind to it
        assert r["flops_source"] == r["bytes_source"] == "model"
        # the counters' channels, read on the CPU by the dispatcher
        assert r["hlo_ops"] > 0 and r["ops_source"] == "dispatch"
        assert r["op_reduction_vs_scalar"] >= 1.0


def test_long_scalar_loops_are_omitted_with_a_reason():
    app = pt_ve.build_stream(4096, device="cpu")
    rows = pt_ve.evaluate_app(app, measure=False, scalar_max_iters=16)
    by = {r["version"]: r for r in rows}
    assert "32 iterations" in by["scalar"]["omitted"]
    assert by["autovec"]["omitted"] is None


def test_measure_needs_the_card():
    app = pt_ve.build_stream(4096, device="cpu")
    with pytest.raises((RuntimeError, ValueError)):
        pt_ve.evaluate_app(app, measure=True)


def test_default_device_is_cuda():
    if torch.cuda.is_available():
        assert pt_ve.build_stream(4096).device.type == "cuda"
    else:
        with pytest.raises((RuntimeError, AssertionError)):
            pt_ve.build_stream(4096)


def test_run_all_on_cpu():
    rows = pt_ve.run_all(measure=False, apps=["stream", "yolov3"],
                         device="cpu", sizes=SIZES)
    assert [(r["app"], r["version"]) for r in rows] == [
        (a, v) for a in ("stream", "yolov3") for v in pt_ve.VERSIONS]


def test_versions_disagreeing_raise():
    app = pt_ve.build_sgemm(8, 8, 8, device="cpu")
    out = app.versions[1].fn(*app.versions[1].args)
    assert app.max_err(out, out) == 0.0
    with pytest.raises(AssertionError):
        app.max_err(out + 1e-2, out)


@pytest.mark.parametrize("name", APPS)
def test_rows_carry_counted_ops_with_the_reference_keys(name):
    """Every row carries ``hlo_ops``, ``instruction_classes`` and
    ``op_reduction_vs_scalar`` with the JAX row's keys (and its source);
    the compiler's version retires fewer ops than the scalar loop in both
    packages."""
    pt = pt_ve.BUILDERS[name](**SIZES[name], device="cpu")
    rows = {r["version"]: r for r in pt_ve.evaluate_app(pt, measure=False)}
    with jax.enable_x64(name == "dgemm"):
        ja = _jax_app(name)
        if name in ("alexnet", "yolov3"):
            # the JAX conv kernel raises on the installed jax (ROADMAP
            # R1): its rows are read without the kernel version
            ja.versions = [v for v in ja.versions if v.name != "kernel"]
        ref = {r["version"]: r for r in jax_ve.evaluate_app(
            ja, measure=False)}
    for v, r in rows.items():
        assert r["hlo_ops"] > 0 and r["ops_source"] == "dispatch"
        assert sum(r["instruction_classes"].values()) == r["hlo_ops"]
        if v in ref:
            assert set(ref[v]) - {"tpu_model_seconds"} <= set(r)
            assert set(r["instruction_classes"]) == \
                set(ref[v]["instruction_classes"])
    assert rows["scalar"]["op_reduction_vs_scalar"] == 1.0
    assert rows["autovec"]["op_reduction_vs_scalar"] > 1.0
    assert ref["autovec"]["op_reduction_vs_scalar"] > 1.0
    assert "plain twin" in rows["kernel"]["ops_note"]


@pytest.mark.parametrize("name", ["sgemm", "dgemm", "alexnet", "yolov3"])
def test_matmul_bearing_apps_read_the_flop_counter(name):
    """The flop counter calibrated reliable on matmuls: a matmul-bearing
    version's flops are the counter's, and equal the JAX app's useful
    flops; an elementwise-only app (stream, spmv) reads the model."""
    pt = pt_ve.BUILDERS[name](**SIZES[name], device="cpu")
    with jax.enable_x64(name == "dgemm"):
        ja = _jax_app(name)
    for r in pt_ve.evaluate_app(pt, measure=False):
        assert r["flops_source"] == "counter", r["version"]
        assert r["flops"] == ja.flops
    stream = pt_ve.evaluate_app(pt_ve.build_stream(4096, device="cpu"),
                                measure=False)
    assert {r["flops_source"] for r in stream} == {"model"}


def test_channel_verdicts_and_the_channels_switch():
    v = pt_ve.channel_verdicts("cpu")
    assert v["flops_matmul"] and v["op_histogram"]
    assert not v["flops_straightline"]
    app = pt_ve.build_stream(4096, device="cpu")
    # one path: every row is counted, there is no switch to turn it off
    assert "channels" not in inspect.signature(pt_ve.evaluate_app).parameters
    assert "channels" not in inspect.signature(pt_ve.run_all).parameters
    rows = pt_ve.evaluate_app(app, measure=False, scalar_max_iters=16)
    by = {r["version"]: r for r in rows}
    assert by["scalar"]["hlo_ops"] is None
    assert "iterations" in by["scalar"]["ops_note"]
    assert by["autovec"]["op_reduction_vs_scalar"] is None
