"""Plain PyTorch versions of the single-qubit gate (counterpart of
``repro.kernels.qsim_gate.ref``): the CPU path, the on-card oracle, and
the arithmetic that ``repro_torch.quantum.qsim``'s planar versions run.

``planar_step`` is written for ``torch.compile`` as well as for eager
use: the gate arrives as 8 coefficients (``gate_coeffs``), either Python
floats or a float32 tensor on the state's device, so one compiled graph
serves every gate.
"""
from typing import Optional, Sequence, Tuple

import numpy as np
import torch


def gate_coeffs(gate) -> Tuple[float, ...]:
    """(2, 2) complex gate (numpy array or tensor) -> its 8 float32 values
    ``(a_re, a_im, b_re, b_im, c_re, c_im, d_re, d_im)`` as Python floats,
    each exactly a float32 (the gate is rounded to complex64 first, as the
    JAX package's gates are)."""
    if isinstance(gate, torch.Tensor):
        gate = gate.detach().cpu().numpy()
    g = np.asarray(gate, np.complex64)
    if g.shape != (2, 2):
        raise ValueError(f"gate must be (2, 2), got {g.shape}")
    return tuple(float(v) for z in g.reshape(-1) for v in (z.real, z.imag))


def check_qubit(n_amps: int, qubit: int) -> None:
    if n_amps < 2 or n_amps & (n_amps - 1):
        raise ValueError(f"state length {n_amps} is not a power of two >= 2")
    if not 0 <= qubit or (2 << qubit) > n_amps:
        raise ValueError(f"qubit {qubit} out of range for {n_amps} "
                         f"amplitudes")


def planar_step(re: torch.Tensor, im: torch.Tensor, g: Sequence, stride: int,
                cstride: int = 0) -> Tuple[torch.Tensor, torch.Tensor]:
    """One gate on planar (re, im) planes of n amplitudes.  ``g``: the 8
    coefficients; ``stride`` = 2^qubit.  ``cstride`` = 2^control for a
    controlled gate (0: none): the gate is kept only where the control
    bit is 1.  The same expressions, in the same order, as the JAX
    package's ``apply_gate_planar_jnp``."""
    n = re.shape[0]
    r3 = re.reshape(n // (2 * stride), 2, stride)
    i3 = im.reshape(n // (2 * stride), 2, stride)
    a0r, a1r = r3[:, 0], r3[:, 1]
    a0i, a1i = i3[:, 0], i3[:, 1]
    n0r = g[0] * a0r - g[1] * a0i + g[2] * a1r - g[3] * a1i
    n0i = g[0] * a0i + g[1] * a0r + g[2] * a1i + g[3] * a1r
    n1r = g[4] * a0r - g[5] * a0i + g[6] * a1r - g[7] * a1i
    n1i = g[4] * a0i + g[5] * a0r + g[6] * a1i + g[7] * a1r
    new_re = torch.stack([n0r, n1r], 1).reshape(n)
    new_im = torch.stack([n0i, n1i], 1).reshape(n)
    if cstride:
        new_re = controlled_select(new_re, re, cstride)
        new_im = controlled_select(new_im, im, cstride)
    return new_re, new_im


def controlled_select(new: torch.Tensor, old: torch.Tensor, cstride: int
                ) -> torch.Tensor:
    """``new`` where bit log2(cstride) of the flat index is 1, else ``old``.
    The JAX package builds ``(arange(n) >> control) & 1``; here the bit is
    the middle axis of an (n / 2cstride, 2, cstride) view, so no index
    array of n int64 is made (2 GiB at 28 qubits)."""
    shape = (-1, 2, cstride) + tuple(new.shape[1:])
    on = torch.tensor([False, True], device=new.device).view(
        (1, 2) + (1,) * (len(shape) - 2))
    return torch.where(on, new.view(shape), old.view(shape)).reshape(
        new.shape)


def apply_gate_planar(re: torch.Tensor, im: torch.Tensor, gate, qubit: int,
                      control: Optional[int] = None
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """re/im: (2^n,) planes; gate: (2, 2) complex.  Returns (re', im')."""
    check_qubit(re.shape[0], qubit)
    return planar_step(re, im, gate_coeffs(gate), 1 << qubit,
                       0 if control is None else 1 << control)


def apply_gate_complex(state: torch.Tensor, gate, qubit: int
                       ) -> torch.Tensor:
    """state: (2^n,) complex64; gate: (2, 2) complex (the JAX oracle)."""
    n = state.shape[0]
    stride = 1 << qubit
    g = torch.as_tensor(np.asarray(gate, np.complex64), device=state.device)
    s = state.reshape(n // (2 * stride), 2, stride)
    a0, a1 = s[:, 0, :], s[:, 1, :]
    new0 = g[0, 0] * a0 + g[0, 1] * a1
    new1 = g[1, 0] * a0 + g[1, 1] * a1
    return torch.stack([new0, new1], dim=1).reshape(n)
