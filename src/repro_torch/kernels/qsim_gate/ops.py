"""Single-qubit gate entry (counterpart of
``repro.kernels.qsim_gate.ops.apply_gate_planar``).

A CPU tensor runs the plain version (``ref.py``); a CUDA tensor launches
the CUDA kernel (``kernel.apply_gate_planar``) or raises — there is no
fallback.  The gate's 8 floats are read on the host, so a numpy gate
costs no copy to the device.
"""
from __future__ import annotations

from typing import Tuple

import torch

from repro_torch.kernels.qsim_gate import kernel as K
from repro_torch.kernels.qsim_gate import ref


def apply_gate_planar(re, im, gate, qubit: int
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """re/im: (2^n,) planar state planes; gate: (2, 2) complex numpy array
    or tensor.  Returns (re', im'): the gate applied to ``qubit``."""
    if re.device.type == "cpu":
        return ref.apply_gate_planar(re, im, gate, qubit)
    return K.apply_gate_planar(re, im, ref.gate_coeffs(gate), qubit)
