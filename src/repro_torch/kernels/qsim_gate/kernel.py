"""ctypes binding of the CUDA single-qubit gate kernel (csrc/qsim_gate.cu).

``apply_gate_planar`` is the counterpart of the TPU launcher
(``repro.kernels.qsim_gate.kernel.apply_gate_planar``): planar fp32
(re, im) planes in, new planes out (out of place).  It checks device,
dtype, shape and contiguity, allocates the outputs with ``torch.empty``,
passes the gate's 8 floats by value, launches on the current stream
without synchronising, and raises if the launch returns a CUDA error.
``apply_gate_planar.launches`` counts the kernel launches made through
it.
"""
from __future__ import annotations

import ctypes
import functools
import pathlib
from typing import Sequence, Tuple

import torch

from repro_torch.kernels import common
from repro_torch.kernels.qsim_gate.ref import check_qubit

SOURCES = (pathlib.Path(__file__).parent / "csrc" / "qsim_gate.cu",)


@functools.lru_cache(maxsize=None)
def load_library() -> ctypes.CDLL:
    """Build (at first use) and load the kernel library, once a process."""
    lib = common.build_library("qsim_gate", SOURCES)
    p, f = ctypes.c_void_p, ctypes.c_float
    common.bind(lib, "qsim_gate_launch", p, p, p, p, ctypes.c_longlong,
                ctypes.c_int, f, f, f, f, f, f, f, f)
    return lib


def apply_gate_planar(re: torch.Tensor, im: torch.Tensor,
                      coeffs: Sequence[float], qubit: int
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """re, im: (2^n,) contiguous fp32 on a Hopper card; ``coeffs``: the
    gate's 8 floats (``ref.gate_coeffs``).  Returns (re', im')."""
    dev = re.device
    common.require_hopper(dev)
    if re.dim() != 1:
        raise ValueError(f"re must be (2^n,), got {tuple(re.shape)}")
    check_qubit(re.shape[0], qubit)
    common.check_operand("re", re, torch.float32, dev)
    common.check_operand("im", im, torch.float32, dev, re.shape)
    if len(coeffs) != 8:
        raise ValueError("coeffs must be the gate's 8 floats")
    out_re, out_im = torch.empty_like(re), torch.empty_like(im)
    lib = load_library()
    err = lib.qsim_gate_launch(re.data_ptr(), im.data_ptr(),
                               out_re.data_ptr(), out_im.data_ptr(),
                               re.shape[0], qubit, *map(float, coeffs),
                               common.stream_of(re))
    common.check_launch(lib, "qsim_gate_launch", err)
    apply_gate_planar.launches += 1
    return out_re, out_im


apply_gate_planar.launches = 0
