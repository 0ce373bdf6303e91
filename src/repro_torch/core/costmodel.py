"""The card's ceilings: the counterpart of ``repro.core.costmodel.HWSpec``.

Only the hardware description is ported so far; the analytic step-cost
model of the JAX module waits for the engine's cost accounting.  Every
rate is NVIDIA's published figure for the part (the H100 data sheet,
dense rates without sparsity) at the card's full power limit; a card
set below its limit runs slower under load, so a result that uses these
rates names the card and its power limit beside them.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch


@dataclasses.dataclass(frozen=True)
class HWSpec:
    name: str
    hbm_bw: float                  # device memory, bytes/s
    l2_bytes: float
    peak_flops_bf16: float         # tensor cores, dense
    peak_flops_tf32: float         # tensor cores, dense
    peak_flops_fp32: float         # CUDA cores (no tensor-core fp32 path)
    peak_flops_fp64: float         # fp64 tensor cores

    def peak_flops(self, dtype: torch.dtype) -> float:
        """The dense peak for arithmetic done in ``dtype`` without TF32:
        fp32 is the CUDA-core rate, fp64 the fp64 tensor-core rate."""
        if dtype in (torch.bfloat16, torch.float16):
            return self.peak_flops_bf16
        if dtype == torch.float32:
            return self.peak_flops_fp32
        if dtype == torch.float64:
            return self.peak_flops_fp64
        raise ValueError(f"no peak rate for {dtype}")

    def bound_s(self, flops: float, nbytes: float,
                dtype: torch.dtype) -> Tuple[float, str]:
        """Least time for work of ``flops`` operations in ``dtype`` that
        must move ``nbytes`` through device memory: the larger of the two
        times, and which of them it is ("bytes" or "operations")."""
        t_bytes = nbytes / self.hbm_bw
        t_ops = flops / self.peak_flops(dtype)
        return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                     else "operations")


H100_SXM = HWSpec(name="h100_sxm", hbm_bw=3.35e12, l2_bytes=50e6,
                  peak_flops_bf16=989e12, peak_flops_tf32=495e12,
                  peak_flops_fp32=67e12, peak_flops_fp64=67e12)
H100_PCIE = HWSpec(name="h100_pcie", hbm_bw=2.0e12, l2_bytes=50e6,
                   peak_flops_bf16=756e12, peak_flops_tf32=378e12,
                   peak_flops_fp32=51e12, peak_flops_fp64=51e12)
H100_NVL = HWSpec(name="h100_nvl", hbm_bw=3.9e12, l2_bytes=50e6,
                  peak_flops_bf16=835e12, peak_flops_tf32=418e12,
                  peak_flops_fp32=60e12, peak_flops_fp64=60e12)


def hw_for(card_name: str) -> HWSpec:
    """The variant a card's name describes (``torch.cuda.get_device_name``
    or nvidia-smi's name): PCIe and NVL say so in their names; the SXM
    part ("NVIDIA H100 80GB HBM3") does not."""
    if "PCIe" in card_name:
        return H100_PCIE
    if "NVL" in card_name:
        return H100_NVL
    return H100_SXM


def hw_of(device: torch.device, hw: Optional[HWSpec] = None) -> HWSpec:
    """``hw`` if given, else the spec of the card ``device`` is on; a CPU
    device (where only the tests run, and nothing is timed) gets the SXM
    part's spec."""
    if hw is not None:
        return hw
    if device.type == "cuda":
        return hw_for(torch.cuda.get_device_name(device))
    return H100_SXM
