"""Quantum gate definitions + deterministic random circuits (Qsim study).

A copy of ``repro.quantum.gates`` (numpy only): the same gates and the same
circuits from the same seeds, held against the original by
``tests/test_torch_qsim.py``.
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional

import numpy as np

SQRT2_INV = 1.0 / np.sqrt(2.0)

H = np.array([[1, 1], [1, -1]], np.complex64) * SQRT2_INV
X = np.array([[0, 1], [1, 0]], np.complex64)
Y = np.array([[0, -1j], [1j, 0]], np.complex64)
Z = np.array([[1, 0], [0, -1]], np.complex64)
S = np.array([[1, 0], [0, 1j]], np.complex64)
T = np.array([[1, 0], [0, np.exp(1j * np.pi / 4)]], np.complex64)


def rx(theta: float) -> np.ndarray:
    c, s = np.cos(theta / 2), -1j * np.sin(theta / 2)
    return np.array([[c, s], [s, c]], np.complex64)


def rz(theta: float) -> np.ndarray:
    return np.array([[np.exp(-0.5j * theta), 0],
                     [0, np.exp(0.5j * theta)]], np.complex64)


@dataclasses.dataclass(frozen=True)
class Gate:
    matrix: np.ndarray           # (2,2) for 1q
    qubit: int
    control: Optional[int] = None   # controlled-1q when set
    name: str = "g"


def random_circuit(n_qubits: int, depth: int, seed: int = 0) -> List[Gate]:
    """Qsim-style random circuit: layers of random 1q gates + CZ ladder."""
    rng = np.random.default_rng(seed)
    pool = [("h", H), ("t", T), ("s", S),
            ("rx", None), ("rz", None)]
    circuit: List[Gate] = []
    for layer in range(depth):
        for q in range(n_qubits):
            name, mat = pool[rng.integers(len(pool))]
            if mat is None:
                theta = float(rng.uniform(0, 2 * np.pi))
                mat = rx(theta) if name == "rx" else rz(theta)
            circuit.append(Gate(mat, q, name=name))
        # entangle: CZ between (layer % 2) offset pairs
        start = layer % 2
        for q in range(start, n_qubits - 1, 2):
            circuit.append(Gate(Z, q + 1, control=q, name="cz"))
    return circuit
