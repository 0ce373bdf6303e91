"""The port's counter layer (``repro_torch.core.ophist``,
``core.counters``, ``perf.channels``) against the JAX package's
(``repro.core.hlo``, ``repro.core.counters``, ``repro.perf.channels``)
on the CPU:

- ``_gate`` gives the reference's ``ChannelValue`` on every branch;
- ``CounterRecord``'s error and verdict are the reference's on the same
  numbers (the port adds the absent channel: no error, unreliable);
- the add-chain ``op_histogram`` record reads ``steps`` adds, as the
  reference's does;
- the calibration's verdicts on the CPU, each with its reason;
- ``instruction_classes`` has the reference's six keys;
- ``channels_for`` picks its flops verdict by program structure
  (matmul-bearing or elementwise-only) and gates as the reference does.
"""
import numpy as np
import pytest
import torch

from repro.core import counters as jax_counters
from repro.core import hlo as jax_hlo
from repro.perf import channels as jax_channels
from repro_torch.core import counters, ophist
from repro_torch.figures import table1_counters
from repro_torch.perf import channels

N, STEPS = 1 << 12, 4


@pytest.fixture(scope="module")
def cal():
    return channels.calibrate(n=N, steps=STEPS, device="cpu")


@pytest.mark.parametrize("counter,reliable,model", [
    (5.0, True, 7.0), (5.0, True, None), (5.0, False, 7.0),
    (None, False, 7.0), (None, True, 7.0), (5.0, False, None),
    (None, False, None), (None, True, None), (0.0, True, 3.0)])
def test_gate_matches_the_reference_on_every_branch(counter, reliable,
                                                    model):
    got = channels._gate("flops", counter, reliable, model)
    want = jax_channels._gate("flops", counter, reliable, model)
    assert (got.name, got.value, got.source, got.reliable,
            got.counter_value) == (want.name, want.value, want.source,
                                   want.reliable, want.counter_value)
    assert got.row() == want.row()


@pytest.mark.parametrize("reference,measured", [
    (100.0, 100.0), (100.0, 104.9), (100.0, 105.1), (100.0, 0.0),
    (0.0, 0.0), (0.0, 0.01), (8.0, 16.0), (1e9, 0.96e9)])
def test_counter_record_matches_the_reference(reference, measured):
    got = counters.CounterRecord("c", "p", reference, measured)
    want = jax_counters.CounterRecord("c", "p", reference, measured)
    assert got.error == pytest.approx(want.error, abs=0.0)
    assert got.reliable == want.reliable
    assert got.row() == want.row()


def test_absent_channel_is_unreliable():
    r = counters.CounterRecord("bytes_copy", "copy", 64.0, None)
    assert r.error is None and not r.reliable
    assert r.row()["measured"] is None


def test_op_histogram_record_reads_steps_adds_as_the_reference(cal):
    mine = [r for r in cal.records if r.channel == "op_histogram"]
    ref = [r for r in jax_counters.calibrate(n=N, steps=STEPS)
           if r.channel == "op_histogram"]
    assert len(mine) == len(ref) == 1
    assert mine[0].program == ref[0].program == f"{STEPS}x add"
    assert mine[0].reference == ref[0].reference == STEPS
    assert mine[0].measured == ref[0].measured == STEPS
    assert mine[0].reliable and ref[0].reliable


def test_calibration_verdicts_on_the_cpu(cal):
    v = cal.verdicts
    # FlopCounterMode has formulas for matmuls, convolutions and
    # attention only: the elementwise add/mul chain and the fma read 0
    assert not v["flops_straightline"]
    # the loop-carried chain is elementwise too (and an eager loop is
    # dispatched op by op, so no trip count is hidden from the counter)
    assert not v["flops_scan"]
    # every matmul is counted exactly, each iteration of a loop included
    assert v["flops_matmul"]
    # the dispatch histogram sees every add the program runs
    assert v["op_histogram"]
    # torch has no bytes and no transcendental counter: absent
    assert not v["bytes_copy"] and not v["bytes_fused_chain"]
    assert not v["transcendental"]
    # the kernel records are the card's: no such channel on the CPU
    assert "kernel_launches" not in v
    # every reference channel keeps its row
    ref = {r.channel for r in jax_counters.calibrate(n=N, steps=STEPS)}
    assert ref <= set(v)


def test_calibration_programs_follow_the_reference(cal):
    """The records the two packages share carry the same program, known
    count and channel (the reference's dot record moves to the port's
    flops_matmul channel)."""
    ref = {(r.program, r.reference): r.channel
           for r in jax_counters.calibrate(n=N, steps=STEPS)}
    mine = {(r.program, r.reference): r.channel for r in cal.records}
    for key, ch in ref.items():
        if key[0] == "dot 256^3":
            assert mine[key] == "flops_matmul"
        elif ch == "flops_scan":
            assert mine[(f"loop({STEPS})x (add+mul)", key[1])] == ch
        else:
            assert mine[key] == ch, key


def test_instruction_classes_keep_the_reference_buckets():
    keys = set(jax_hlo.instruction_classes({}))
    assert set(ophist.instruction_classes({})) == keys
    hist = {"mm": 2, "add": 3, "view": 4, "sum": 1, "all_reduce": 1,
            "weird_op": 5, "convolution": 1, "exp": 1}
    got = ophist.instruction_classes(hist)
    assert got == {"matmul": 3, "elementwise": 4, "memory_movement": 4,
                   "collective": 1, "control": 1, "other": 5}
    # the reference buckets its HLO names the same way
    ref = jax_hlo.instruction_classes({"dot": 2, "convolution": 1,
                                       "add": 3, "exponential": 1,
                                       "reshape": 4, "reduce": 1,
                                       "all-reduce": 1, "weird": 5})
    assert ref == got


def test_op_histogram_counts_executed_ops():
    x = torch.ones(8)

    def loop(x):
        for _ in range(5):
            x = x * 2.0 + 1.0
        return x

    assert ophist.op_histogram(loop, x) == {"mul": 5, "add": 5}


def test_channels_pick_the_verdict_by_structure(cal):
    a = torch.ones((16, 16))
    x = torch.ones(64)
    mm = channels.channels_for(lambda a: a @ a, a, model_flops=1.0,
                               calibration=cal)
    assert mm.matmul_bearing and mm.flops.source == "counter"
    assert mm.flops.value == 2 * 16 ** 3 and mm.flops.reliable
    ew = channels.channels_for(lambda x: x * 2.0 + 1.0, x,
                               model_flops=123.0, calibration=cal)
    assert ew.matmul_bearing is False
    assert (ew.flops.source, ew.flops.value) == ("model", 123.0)
    assert ew.flops.counter_value == 0.0 and not ew.flops.reliable
    # bytes and transcendentals: no counter, the model's value
    assert ew.bytes_accessed.source == "none"
    b = channels.channels_for(lambda x: x + 0.0, x, model_bytes=512.0,
                              calibration=cal)
    assert (b.bytes_accessed.source, b.bytes_accessed.value) == \
        ("model", 512.0)
    assert ew.histogram_source == "dispatch"
    assert ew.op_histogram == {"mul": 1, "add": 1}
    assert ew.total_ops == 2 and ew.instruction_classes["elementwise"] == 2
    row = ew.row()
    assert row["hlo_ops"] == 2 and row["ops_source"] == "dispatch"


def test_opaque_function_reads_the_model(cal):
    x = torch.ones(64)
    ch = channels.channels_for(lambda x: x * 2.0, x, model_flops=9.0,
                               calibration=cal, opaque="compiled")
    assert (ch.flops.source, ch.flops.value) == ("model", 9.0)
    assert ch.op_histogram is None and ch.total_ops is None
    assert ch.histogram_note == "compiled" and ch.matmul_bearing is None


def test_unreliable_channel_swaps_in_model_value_as_the_reference():
    """The reference's gating test, on the port: a reliable channel reads
    the counter, an unreliable one the model."""
    cal = channels.Calibration(records=[], verdicts={
        "flops_matmul": False, "flops_straightline": False})
    a = torch.ones((8, 8))
    ch = channels.channels_for(lambda a: a @ a, a, model_flops=123.0,
                               calibration=cal)
    assert (ch.flops.source, ch.flops.value) == ("model", 123.0)
    cal.verdicts["flops_matmul"] = True
    ch = channels.channels_for(lambda a: a @ a, a, model_flops=123.0,
                               calibration=cal)
    assert ch.flops.source == "counter" and ch.flops.value != 123.0


def test_default_calibration_is_cached_by_device():
    one = channels.default_calibration("cpu")
    assert channels.default_calibration("cpu") is one
    assert one.verdicts["flops_matmul"]


def test_table1_rows(cal):
    rows = table1_counters.run("cpu", n=N, steps=STEPS)
    assert [(r["channel"], r["program"], r["measured"]) for r in rows] == \
        [(r.channel, r.program, r.measured) for r in cal.records]
    assert table1_counters.verdicts(rows) == cal.verdicts
    assert all(r["device"] == "cpu" for r in rows)


def test_calibrate_defaults_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises((RuntimeError, AssertionError)):
        counters.calibrate(n=16, steps=1)


def test_fold_proof_chain_values_match_the_reference():
    """The calibration programs compute what the reference's compute on
    the same inputs (the chain is fold-proof, so the known counts hold)."""
    x = np.ones(16, np.float32)
    xt, yt = torch.from_numpy(x), torch.from_numpy(x.copy())
    xs, ys = xt, yt
    for _ in range(STEPS):
        xs, ys = xs + ys, ys * 1.0001
    import jax.numpy as jnp
    xj, yj = jnp.asarray(x), jnp.asarray(x)
    for _ in range(STEPS):
        xj, yj = xj + yj, yj * 1.0001
    np.testing.assert_allclose(xs.numpy(), np.asarray(xj), rtol=1e-6)
    np.testing.assert_allclose(ys.numpy(), np.asarray(yj), rtol=1e-6)
