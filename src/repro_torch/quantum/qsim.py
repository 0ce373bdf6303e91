"""State-vector quantum simulator, the paper's §6 product-level study: the
counterpart of ``repro.quantum.qsim``.

Three implementations x two memory layouts, as in the JAX package:

  layouts:
    * ``interleaved`` — amplitudes stored (2^n, 2) with re/im adjacent
      (Qsim's layout).
    * ``planar``      — separate re/im planes (the layout of the paper's
      hand-intrinsics port).

  versions:
    * ``nonvec``  — a Python loop over amplitude pairs, a few scalar tensor
      ops each (the JAX ``fori_loop``).  On the card every op is a kernel
      launch, so its time is the host's launch rate, not the card's.
    * ``autovec`` — the idiomatic reshape expression.  Eager here; the
      Fig 9 driver (``repro_torch.figures.fig9_qsim``) runs it through
      ``torch.compile`` on the card (``compiled_planar_step``,
      ``compiled_interleaved_step``).
    * ``kernel``  — ``repro_torch.kernels.qsim_gate`` (planar only): the
      hand-written CUDA kernel on the card, its plain version on the CPU.

Every function takes tensors and works on their device; ``init_state``
and friends take the device explicitly (``cuda`` unless named).  The
circuits come from ``repro_torch.quantum.gates``, the same gates as the
JAX package's from the same seeds.
"""
from __future__ import annotations

import functools
from typing import List, Optional, Tuple

import numpy as np
import torch

from repro_torch.kernels.common import resolve_device
from repro_torch.kernels.qsim_gate import ops as qg
from repro_torch.kernels.qsim_gate.ref import (apply_gate_complex as
                                               _complex_oracle, gate_coeffs,
                                               planar_step, controlled_select)
from repro_torch.quantum.gates import Gate

Planes = Tuple[torch.Tensor, torch.Tensor]


def init_state(n_qubits: int, device=None) -> torch.Tensor:
    """|0...0> as (2^n,) complex64."""
    state = torch.zeros((2 ** n_qubits,), dtype=torch.complex64,
                        device=resolve_device(device))
    state[0] = 1.0
    return state


def init_planar(n_qubits: int, device=None) -> Planes:
    """|0...0> as planar (re, im) fp32 planes."""
    dev = resolve_device(device)
    re = torch.zeros((2 ** n_qubits,), dtype=torch.float32, device=dev)
    re[0] = 1.0
    return re, torch.zeros_like(re)


def init_interleaved(n_qubits: int, device=None) -> torch.Tensor:
    """|0...0> as (2^n, 2) fp32, re/im on the last axis."""
    ri = torch.zeros((2 ** n_qubits, 2), dtype=torch.float32,
                     device=resolve_device(device))
    ri[0, 0] = 1.0
    return ri


def _strides(qubit: int, control: Optional[int]) -> Tuple[int, int]:
    return 1 << qubit, 0 if control is None else 1 << control


# ---------------------------------------------------------------------------
# autovec — complex, interleaved or planar
# ---------------------------------------------------------------------------
def apply_gate_complex(state: torch.Tensor, mat: np.ndarray, qubit: int,
                       control: Optional[int] = None) -> torch.Tensor:
    new = _complex_oracle(state, mat, qubit)
    if control is not None:
        new = controlled_select(new, state, 1 << control)
    return new


def run_autovec_complex(state: torch.Tensor, circuit: List[Gate]
                        ) -> torch.Tensor:
    for g in circuit:
        state = apply_gate_complex(state, g.matrix, g.qubit, g.control)
    return state


def interleaved_step(ri: torch.Tensor, g, stride: int, cstride: int = 0
                     ) -> torch.Tensor:
    """One gate on the (n, 2) interleaved state; ``g`` as in
    ``planar_step``.  The JAX package's ``apply_gate_interleaved``."""
    n = ri.shape[0]
    s = ri.reshape(n // (2 * stride), 2, stride, 2)
    a0re, a0im = s[:, 0, :, 0], s[:, 0, :, 1]
    a1re, a1im = s[:, 1, :, 0], s[:, 1, :, 1]
    n0re = g[0] * a0re - g[1] * a0im + g[2] * a1re - g[3] * a1im
    n0im = g[0] * a0im + g[1] * a0re + g[2] * a1im + g[3] * a1re
    n1re = g[4] * a0re - g[5] * a0im + g[6] * a1re - g[7] * a1im
    n1im = g[4] * a0im + g[5] * a0re + g[6] * a1im + g[7] * a1re
    new = torch.stack([torch.stack([n0re, n0im], -1),
                       torch.stack([n1re, n1im], -1)], 1).reshape(n, 2)
    if cstride:
        new = controlled_select(new, ri, cstride)
    return new


def apply_gate_interleaved(ri: torch.Tensor, mat: np.ndarray, qubit: int,
                           control: Optional[int] = None) -> torch.Tensor:
    """ri: (2^n, 2) float32, re/im interleaved on the last axis."""
    return interleaved_step(ri, gate_coeffs(mat), *_strides(qubit, control))


def run_autovec_interleaved(ri: torch.Tensor, circuit: List[Gate]
                            ) -> torch.Tensor:
    for g in circuit:
        ri = apply_gate_interleaved(ri, g.matrix, g.qubit, g.control)
    return ri


def apply_gate_planar_torch(re: torch.Tensor, im: torch.Tensor,
                            mat: np.ndarray, qubit: int,
                            control: Optional[int] = None) -> Planes:
    """The plain planar gate (the JAX package's ``apply_gate_planar_jnp``)."""
    return planar_step(re, im, gate_coeffs(mat), *_strides(qubit, control))


def run_autovec_planar(re: torch.Tensor, im: torch.Tensor,
                       circuit: List[Gate]) -> Planes:
    for g in circuit:
        re, im = apply_gate_planar_torch(re, im, g.matrix, g.qubit,
                                         g.control)
    return re, im


# ---------------------------------------------------------------------------
# autovec under torch.compile: one graph for every gate and size
# ---------------------------------------------------------------------------
@functools.lru_cache(maxsize=None)
def compiled_planar_step():
    """``planar_step`` through ``torch.compile(dynamic=True)``.  The gate's
    coefficients go in as a tensor and the strides as symbolic sizes, so a
    few graphs (Dynamo specialises strides of 0 and 1 and a size-1 outer
    axis) serve every gate of every circuit, where ``dynamic=False`` would
    compile once per qubit."""
    return torch.compile(planar_step, dynamic=True, fullgraph=True)


@functools.lru_cache(maxsize=None)
def compiled_interleaved_step():
    """``interleaved_step`` through ``torch.compile``, as above."""
    return torch.compile(interleaved_step, dynamic=True, fullgraph=True)


def circuit_coeffs(circuit: List[Gate], device) -> List[torch.Tensor]:
    """Each gate's 8 coefficients as a float32 tensor on ``device``, made
    once so that running the circuit copies nothing to the card."""
    return [torch.tensor(gate_coeffs(g.matrix), dtype=torch.float32,
                         device=device) for g in circuit]


def run_stepped(step, state, circuit: List[Gate],
                coeffs: List[torch.Tensor]):
    """Run ``circuit`` through ``step(*state, g, stride, cstride)`` (a
    compiled or plain ``planar_step`` or ``interleaved_step``)."""
    planar = isinstance(state, tuple)
    for g, c in zip(circuit, coeffs):
        args = (*state, c) if planar else (state, c)
        state = step(*args, *_strides(g.qubit, g.control))
    return state


# ---------------------------------------------------------------------------
# nonvec — a loop over amplitude pairs (the scalar-issue analogue)
# ---------------------------------------------------------------------------
def run_nonvec_planar(re: torch.Tensor, im: torch.Tensor,
                      circuit: List[Gate], max_pairs: Optional[int] = None
                      ) -> Planes:
    """The JAX package's ``run_nonvec_planar``: every gate visits its pairs
    k = 0, 1, ... in order with scalar ops.  ``max_pairs`` stops the walk
    after that many pairs in all (the last gate may be left part done), so
    that a large state can be timed on a prefix."""
    re, im = re.clone(), im.clone()
    n = re.shape[0]
    left = n // 2 * len(circuit) if max_pairs is None else max_pairs
    for g in circuit:
        stride, cstride = _strides(g.qubit, g.control)
        c = gate_coeffs(g.matrix)
        for k in range(min(n // 2, left)):
            i0 = (k // stride) * 2 * stride + (k % stride)
            i1 = i0 + stride
            a0r, a0i, a1r, a1i = re[i0], im[i0], re[i1], im[i1]
            n0r = c[0] * a0r - c[1] * a0i + c[2] * a1r - c[3] * a1i
            n0i = c[0] * a0i + c[1] * a0r + c[2] * a1i + c[3] * a1r
            n1r = c[4] * a0r - c[5] * a0i + c[6] * a1r - c[7] * a1i
            n1i = c[4] * a0i + c[5] * a0r + c[6] * a1i + c[7] * a1r
            if not cstride or i0 & cstride:
                re[i0], im[i0] = n0r, n0i
            if not cstride or i1 & cstride:
                re[i1], im[i1] = n1r, n1i
        left -= n // 2
        if left <= 0:
            break
    return re, im


# ---------------------------------------------------------------------------
# kernel — the CUDA planar gate
# ---------------------------------------------------------------------------
def run_kernel_planar(re: torch.Tensor, im: torch.Tensor,
                      circuit: List[Gate]) -> Planes:
    """Uncontrolled gates launch the gate kernel (``qsim_gate.ops``); the
    controlled ones (the CZ ladder) take the plain planar function.  That
    split is the JAX package's own design (``repro.quantum.qsim``): the
    hot spot Qsim optimises is the dense single-qubit sweep.  It is no
    fallback, so on the card the kernel's launches equal the uncontrolled
    gates of the circuit."""
    for g in circuit:
        if g.control is None:
            re, im = qg.apply_gate_planar(re, im, g.matrix, g.qubit)
        else:
            re, im = apply_gate_planar_torch(re, im, g.matrix, g.qubit,
                                             g.control)
    return re, im
