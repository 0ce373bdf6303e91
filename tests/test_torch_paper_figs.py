"""The port's paper figures (``repro_torch.figures``: Table 1, Figs 4-8)
on the CPU, at small sizes, against the JAX package's benchmarks'
(``benchmarks/fig*.py``, ``table1_counters.py``) building blocks:

- each figure's ``run(measure=False)`` returns its rows, with the bound
  beside the (absent) times where it times anything;
- Fig 4's rows are the microbenchmark suites' names and per-element
  counts, as the JAX ``core.microbench`` rows;
- Figs 5 and 6 carry the apps and versions of ``repro.core.veceval``,
  their op counts from the dispatcher, and the verdicts they were read
  under;
- Fig 7 (a)'s model picks, Fig 8's grid reduction, and the
  ``cuobjdump -res-usage`` parser on a recorded listing.
"""
import pytest

from repro.core import microbench as jax_microbench
from repro.core import veceval as jax_veceval
from repro_torch.core import ophist
from repro_torch.figures import (fig4_arith, fig5_proxyapps, fig6_breakdown,
                                 fig7_lmul, fig8_pressure, table1_counters)

SIZES = {
    "stream": dict(n=4096),
    "spmv": dict(rows=72, cols=200, nnz=8),
    "sgemm": dict(M=64, K=48, N=40),
    "dgemm": dict(M=64, K=48, N=40),
    "alexnet": dict(H=16, W=16, Cin=4),
    "yolov3": dict(H=16, W=16, Cin=4),
}


def test_table1_runs_on_the_cpu(capsys):
    rows = table1_counters.main(["--device", "cpu", "--n", "4096",
                                 "--steps", "4"])
    assert {r["channel"] for r in rows} >= {"flops_straightline",
                                            "op_histogram"}
    out = capsys.readouterr().out
    assert "Table 1" in out and "UNRELIABLE" in out


def test_fig4_rows_follow_the_jax_suites():
    rows = fig4_arith.run("cpu", measure=False)
    ref = [r.row() for r in jax_microbench.arithmetic_suite(measure=False)]
    ref += [r.row() for r in jax_microbench.memory_suite(measure=False)]
    assert [(r["name"], r["flops_per_elem"], r["bytes_per_elem"])
            for r in rows] == [(r["name"], r["flops_per_elem"],
                                r["bytes_per_elem"]) for r in ref]
    for r in rows:
        assert r["host_gops"] is None and r["bound_gops"] > 0
    fig4_arith.print_rows(rows)


def test_fig5_rows_carry_speedup_and_op_reduction():
    rows = fig5_proxyapps.run("cpu", measure=False, sizes=SIZES)
    assert [(r["app"], r["version"]) for r in rows] == [
        (a, v) for a in jax_veceval.BUILDERS
        for v in ("scalar", "autovec", "kernel")]
    for r in rows:
        assert r["speedup_vs_scalar"] is None          # nothing timed
        assert r["bound_seconds"] > 0 and r["ops_source"] == "dispatch"
        if r["version"] == "scalar":
            assert r["op_reduction"] == 1.0
        else:
            assert r["op_reduction"] > 1.0, r
    # the matmul-bearing apps read the flop counter, the others the model
    src = {r["app"]: r["flops_source"] for r in rows
           if r["version"] == "autovec"}
    assert src == {"stream": "model", "spmv": "model", "sgemm": "counter",
                   "dgemm": "counter", "alexnet": "counter",
                   "yolov3": "counter"}
    fig5_proxyapps.print_rows(rows)


def test_fig6_rows_carry_the_classes_and_verdicts():
    rows = fig6_breakdown.run("cpu", apps=["stream", "sgemm"], sizes=SIZES)
    assert len(rows) == 6
    for r in rows:
        assert set(ophist.CLASSES) <= set(r)
        assert r["total_ops"] == sum(r[c] for c in ophist.CLASSES)
        assert r["verdicts"]["flops_matmul"]
    by = {(r["app"], r["version"]): r for r in rows}
    # the scalar loop's ops are mostly memory movement (the row copies)
    s = by["stream", "scalar"]
    assert s["memory_movement"] > s["elementwise"] > 0
    assert by["sgemm", "autovec"]["matmul"] == 1
    fig6_breakdown.print_rows(rows)


def test_fig7_model_section():
    rows = fig7_lmul.run("cpu", measure=False)
    assert {r["section"] for r in rows} == {"a"}
    picks = {r["kernel"]: r["multiplier"] for r in rows if r["selected"]}
    assert set(picks) == set(fig7_lmul.model_shapes())
    assert picks["B6 gemm 4096^3 fp32"] == 2
    assert picks["B6 gemm 4096^3 fp64"] == 2
    assert picks["B2 flash S4096 16xH128 bf16"] == 1
    spill = {(r["kernel"], r["multiplier"]) for r in rows if r["spill"]}
    assert ("B6 gemm 4096^3 fp64", 4) in spill
    assert ("B6 gemm 4096^3 fp32", 8) in spill
    assert ("B6 gemm 4096^3 fp32", 4) not in spill
    fig7_lmul.print_rows(rows)


RES_USAGE = """
Resource usage:
 Common:
  GLOBAL:0
 Function _ZN12_GLOBAL__N_14simt9gemm_simtILi16ELi16ELb1EEEvPKfS3_Pfiii:
  REG:255 STACK:192 SHARED:0 LOCAL:0 CONSTANT[0]:380 TEXTURE:0 SURFACE:0 SAMPLER:0
 Function _ZN12_GLOBAL__N_14simt9gemm_simtILi16ELi16ELb0EEEvPKfS3_Pfiii:
  REG:255 STACK:200 SHARED:0 LOCAL:0 CONSTANT[0]:380 TEXTURE:0 SURFACE:0 SAMPLER:0
 Function _ZN12_GLOBAL__N_14simt9gemm_simtILi8ELi8ELb1EEEvPKfS3_Pfiii:
  REG:128 STACK:0 SHARED:0 LOCAL:0 CONSTANT[0]:380 TEXTURE:0 SURFACE:0 SAMPLER:0
 Function _ZN12_GLOBAL__N_14dmma9gemm_dmmaILi256ELi128ELi4ELi2ELb1EEEvPKdS3_Pdiii:
  REG:255 STACK:96 SHARED:0 LOCAL:0 CONSTANT[0]:380 TEXTURE:0 SURFACE:0 SAMPLER:0
 Function _ZN12_GLOBAL__N_14dmma9gemm_dmmaILi128ELi128ELi2ELi4ELb0EEEvPKdS3_Pdiii:
  REG:168 STACK:0 SHARED:0 LOCAL:0 CONSTANT[0]:380 TEXTURE:0 SURFACE:0 SAMPLER:0
"""


def test_res_usage_parser():
    got = fig7_lmul.parse_res_usage(RES_USAGE)
    assert got[("fp32", 8)] == {"regs": 255, "stack": 200, "local": 0,
                                "spill": True}
    assert got[("fp32", 2)]["spill"] is False
    assert got[("fp64", 4)]["spill"] and not got[("fp64", 2)]["spill"]
    assert len(got) == 4


def test_fig8_model_rows():
    rows = fig8_pressure.run("cpu", measure=False)
    assert [r["multiplier"] for r in rows] == [1, 2, 4, 8]
    assert [r["block_reduction"] for r in rows] == [1.0, 2.0, 4.0, 8.0]
    for r in rows:
        assert r["measured_ms"] is None and r["bound_by"] == "bytes"
        # the model never beats the bound, and more blocks never help
        assert r["predicted_ms"] >= r["bound_ms"]
    assert rows[-1]["predicted_speedup"] >= 1.0
    assert rows[-1]["predicted_speedup"] < 1.2    # flat at the bound
    fig8_pressure.print_rows(rows)


@pytest.mark.parametrize("mod", [fig4_arith, fig5_proxyapps,
                                 fig6_breakdown, fig7_lmul, fig8_pressure,
                                 table1_counters])
def test_figures_default_to_the_card(mod):
    import torch
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises((RuntimeError, AssertionError)):
        if mod is fig7_lmul or mod is fig8_pressure:
            mod.run(measure=True)
        else:
            mod.run()
