"""The port's measurement layer on the CPU: the H100 specs and their
bounds (``repro_torch.core.costmodel``), and the CUDA-event timer
(``repro_torch.perf.measure``) refusing to time anything off the card."""
import pytest
import torch

from repro_torch.core import costmodel
from repro_torch.perf import measure


@pytest.mark.parametrize("name,spec", [
    ("NVIDIA H100 80GB HBM3", "h100_sxm"), ("NVIDIA H100 PCIe", "h100_pcie"),
    ("NVIDIA H100 NVL", "h100_nvl")])
def test_hw_for_names_the_variant(name, spec):
    assert costmodel.hw_for(name).name == spec


def test_sxm_rates_are_the_data_sheet():
    hw = costmodel.H100_SXM
    assert (hw.hbm_bw, hw.l2_bytes) == (3.35e12, 50e6)
    assert [hw.peak_flops(t) for t in (torch.bfloat16, torch.float32,
                                       torch.float64)] == [989e12, 67e12,
                                                           67e12]
    assert hw.peak_flops_tf32 == 495e12
    with pytest.raises(ValueError):
        hw.peak_flops(torch.int8)


def test_bound_is_the_larger_time():
    hw = costmodel.H100_SXM
    s, by = hw.bound_s(flops=2.0, nbytes=3.35e12, dtype=torch.float32)
    assert (s, by) == (pytest.approx(1.0), "bytes")
    s, by = hw.bound_s(flops=67e12 * 2, nbytes=1.0, dtype=torch.float32)
    assert (s, by) == (pytest.approx(2.0), "operations")


def test_measure_refuses_without_a_card():
    if torch.cuda.is_available():
        with pytest.raises(ValueError):
            measure.measure(lambda x: x, torch.zeros(4))
    else:
        with pytest.raises(RuntimeError):
            measure.measure(lambda: None)
        with pytest.raises(RuntimeError):
            measure.measure_group({"a": lambda: None})


def test_measurement_rates():
    m = measure.Measurement(median_s=0.5, all_s=[0.5], reps=1)
    assert m.gops(1e9) == 2.0
