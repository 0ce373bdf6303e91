"""The port's Qsim path (``repro_torch.quantum`` and the gate kernel's entry)
against the JAX package's on the CPU, on the same numpy inputs:

- ``random_circuit`` gives the same circuits in both packages;
- every version and layout of the port agrees with the JAX
  ``run_autovec_complex`` and ``run_kernel_planar`` (the Pallas kernel in
  interpret mode) at 8-10 qubits, and the state stays normalised;
- ``qsim_gate.ops.apply_gate_planar`` agrees with the JAX entry at qubits
  0, 2, 7 and 9;
- on a non-CPU tensor the entry launches the kernel or raises.

Tolerance: fp32 roundoff of a few dozen gates, atol 1e-5 (the JAX
package's own); a single gate 1e-6.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from repro.kernels.qsim_gate import ops as jax_gate_ops
from repro.quantum import gates as jax_gates
from repro.quantum import qsim as jax_qsim
from repro_torch.kernels.qsim_gate import kernel as gate_kernel
from repro_torch.kernels.qsim_gate import ops as gate_ops
from repro_torch.kernels.qsim_gate import ref as gate_ref
from repro_torch.quantum import gates, qsim

CPU = torch.device("cpu")


@pytest.mark.parametrize("n,depth,seed", [(8, 4, 3), (9, 6, 11), (5, 3, 0)])
def test_random_circuit_is_the_reference(n, depth, seed):
    got = gates.random_circuit(n, depth, seed)
    want = jax_gates.random_circuit(n, depth, seed)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert (g.qubit, g.control, g.name) == (w.qubit, w.control, w.name)
        assert g.matrix.dtype == w.matrix.dtype
        np.testing.assert_array_equal(g.matrix, w.matrix)


def test_gate_constants_are_the_reference():
    for name in ("H", "X", "Y", "Z", "S", "T"):
        np.testing.assert_array_equal(getattr(gates, name),
                                      getattr(jax_gates, name))
    for theta in (0.3, 2.0):
        np.testing.assert_array_equal(gates.rx(theta), jax_gates.rx(theta))
        np.testing.assert_array_equal(gates.rz(theta), jax_gates.rz(theta))


def _jax_reference(n, depth, seed):
    circuit = jax_gates.random_circuit(n, depth, seed)
    want = np.asarray(jax_qsim.run_autovec_complex(jax_qsim.init_state(n),
                                                   circuit))
    re0 = jnp.zeros((2 ** n,), jnp.float32).at[0].set(1.0)
    kr, ki = jax_qsim.run_kernel_planar(re0, jnp.zeros_like(re0), circuit)
    return gates.random_circuit(n, depth, seed), want, \
        np.asarray(kr) + 1j * np.asarray(ki)


def _port_versions(n, circuit):
    """Final state of every port version and layout, as complex numpy."""
    re, im = qsim.init_planar(n, CPU)
    out = {
        "autovec/complex": qsim.run_autovec_complex(
            qsim.init_state(n, CPU), circuit).numpy(),
        "autovec/interleaved": qsim.run_autovec_interleaved(
            qsim.init_interleaved(n, CPU), circuit).numpy(),
        "autovec/planar": qsim.run_autovec_planar(re, im, circuit),
        "kernel/planar": qsim.run_kernel_planar(re, im, circuit),
        # the compiled versions' call pattern: coefficients as tensors
        "stepped/planar": qsim.run_stepped(
            gate_ref.planar_step, (re, im), circuit,
            qsim.circuit_coeffs(circuit, CPU)),
        "stepped/interleaved": qsim.run_stepped(
            qsim.interleaved_step, qsim.init_interleaved(n, CPU), circuit,
            qsim.circuit_coeffs(circuit, CPU)),
    }
    for k, v in out.items():
        if isinstance(v, tuple):
            out[k] = v[0].numpy() + 1j * v[1].numpy()
        elif v.ndim == 2:
            out[k] = v[:, 0] + 1j * v[:, 1]
    return out


@pytest.mark.parametrize("n,depth,seed", [(8, 4, 3), (10, 3, 5)])
def test_versions_and_layouts_match_jax(n, depth, seed):
    circuit, want, want_kernel = _jax_reference(n, depth, seed)
    np.testing.assert_allclose(want_kernel, want, atol=1e-5)
    for name, got in _port_versions(n, circuit).items():
        assert got.shape == (2 ** n,), name
        np.testing.assert_allclose(got, want, atol=1e-5, err_msg=name)
        np.testing.assert_allclose(got, want_kernel, atol=1e-5,
                                   err_msg=name)


def test_unitarity():
    circuit = gates.random_circuit(9, 6, 11)
    re, im = qsim.run_kernel_planar(*qsim.init_planar(9, CPU), circuit)
    norm = float(torch.sqrt((re.double() ** 2 + im.double() ** 2).sum()))
    assert norm == pytest.approx(1.0, rel=1e-5)


def test_nonvec_matches_jax_on_a_prefix():
    n = 8
    circuit = gates.random_circuit(n, 4, 3)[:2 * n]
    re0 = jnp.zeros((2 ** n,), jnp.float32).at[0].set(1.0)
    wr, wi = jax_qsim.run_nonvec_planar(re0, jnp.zeros_like(re0),
                                        jax_gates.random_circuit(n, 4, 3)
                                        [:2 * n])
    gr, gi = qsim.run_nonvec_planar(*qsim.init_planar(n, CPU), circuit)
    np.testing.assert_allclose(gr.numpy(), np.asarray(wr), atol=1e-5)
    np.testing.assert_allclose(gi.numpy(), np.asarray(wi), atol=1e-5)


def test_nonvec_max_pairs_stops_mid_gate():
    """The first max_pairs pairs of the first gate are done, the rest of
    the state is the input (the cap the Fig 9 driver times)."""
    n, cap = 6, 5
    rng = np.random.default_rng(0)
    re = torch.from_numpy(rng.standard_normal(2 ** n).astype(np.float32))
    im = torch.from_numpy(rng.standard_normal(2 ** n).astype(np.float32))
    g = gates.Gate(gates.rx(0.7), 2)
    gr, gi = qsim.run_nonvec_planar(re, im, [g, g], max_pairs=cap)
    full_r, full_i = qsim.apply_gate_planar_torch(re, im, g.matrix, 2)
    touched = torch.zeros(2 ** n, dtype=torch.bool)
    for k in range(cap):
        i0 = (k // 4) * 8 + k % 4
        touched[[i0, i0 + 4]] = True
    torch.testing.assert_close(gr, torch.where(touched, full_r, re))
    torch.testing.assert_close(gi, torch.where(touched, full_i, im))


@pytest.mark.parametrize("qubit", [0, 2, 7, 9])
def test_apply_gate_planar_matches_jax(qubit):
    n = 10
    rng = np.random.default_rng(qubit)
    re = rng.standard_normal(2 ** n).astype(np.float32)
    im = rng.standard_normal(2 ** n).astype(np.float32)
    gate = (gates.rx(rng.uniform(0, 6)) @ gates.rz(rng.uniform(0, 6))
            @ gates.T).astype(np.complex64)
    gr, gi = gate_ops.apply_gate_planar(torch.from_numpy(re),
                                        torch.from_numpy(im), gate, qubit)
    wr, wi = jax_gate_ops.apply_gate_planar(jnp.asarray(re), jnp.asarray(im),
                                            jnp.asarray(gate), qubit)
    np.testing.assert_allclose(gr.numpy(), np.asarray(wr), atol=1e-6)
    np.testing.assert_allclose(gi.numpy(), np.asarray(wi), atol=1e-6)
    # a tensor gate gives the same result as the numpy one
    tr, _ = gate_ops.apply_gate_planar(torch.from_numpy(re),
                                       torch.from_numpy(im),
                                       torch.from_numpy(gate), qubit)
    torch.testing.assert_close(tr, gr, rtol=0, atol=0)


def test_planar_ref_matches_complex_oracle():
    rng = np.random.default_rng(1)
    state = torch.from_numpy((rng.standard_normal(64)
                              + 1j * rng.standard_normal(64)).astype(
                                  np.complex64))
    for q in range(6):
        want = gate_ref.apply_gate_complex(state, gates.H @ gates.S, q)
        gr, gi = gate_ref.apply_gate_planar(state.real.contiguous(),
                                            state.imag.contiguous(),
                                            gates.H @ gates.S, q)
        torch.testing.assert_close(torch.complex(gr, gi), want, atol=1e-6,
                                   rtol=0)


@pytest.mark.parametrize("qubit,n_amps", [(-1, 16), (4, 16), (0, 12),
                                          (0, 1)])
def test_bad_qubit_or_length_raises(qubit, n_amps):
    x = torch.zeros(n_amps)
    with pytest.raises(ValueError):
        gate_ops.apply_gate_planar(x, x, gates.H, qubit)


def test_non_cpu_tensor_launches_the_kernel_or_raises(monkeypatch):
    """A tensor off the CPU goes to the kernel wrapper, never to the plain
    version: with the wrapper patched to raise, the entry raises."""
    class Launched(Exception):
        pass

    def launched(*args, **kwargs):
        raise Launched

    monkeypatch.setattr(gate_kernel, "apply_gate_planar", launched)
    monkeypatch.setattr(gate_ref, "apply_gate_planar", launched)
    x = torch.zeros(16, device="meta")
    with pytest.raises(Launched):
        gate_ops.apply_gate_planar(x, x, gates.H, 1)


def test_kernel_wrapper_refuses_cpu_tensors():
    x = torch.zeros(16)
    before = gate_kernel.apply_gate_planar.launches
    with pytest.raises(RuntimeError):
        gate_kernel.apply_gate_planar(x, x, gate_ref.gate_coeffs(gates.H), 1)
    assert gate_kernel.apply_gate_planar.launches == before


def test_kernel_version_launches_once_per_uncontrolled_gate(monkeypatch):
    """run_kernel_planar sends exactly the uncontrolled gates to the
    entry; the CZ ladder takes the plain planar function."""
    seen = []
    real = gate_ops.apply_gate_planar

    def counting(re, im, gate, qubit):
        seen.append(qubit)
        return real(re, im, gate, qubit)

    monkeypatch.setattr(gate_ops, "apply_gate_planar", counting)
    circuit = gates.random_circuit(6, 3, 2)
    qsim.run_kernel_planar(*qsim.init_planar(6, CPU), circuit)
    assert seen == [g.qubit for g in circuit if g.control is None]


def test_default_device_is_cuda():
    if torch.cuda.is_available():
        assert qsim.init_state(3).device.type == "cuda"
    else:
        with pytest.raises((RuntimeError, AssertionError)):
            qsim.init_planar(3)


# ---------------------------------------------------------------------------
# the Fig 9 driver, without timing
# ---------------------------------------------------------------------------
from repro_torch.figures import fig9_qsim  # noqa: E402


def test_fig9_runs_every_version_and_holds_them_together():
    rows = fig9_qsim.run(CPU, 8, 3, measure=False)
    circuit = jax_gates.random_circuit(8, 3, seed=fig9_qsim.SEED)
    assert [r["version"] for r in rows] == list(fig9_qsim.VERSIONS)
    for r in rows:
        assert r["gates"] == len(circuit) and r["calls"] == 1
        assert r["uncontrolled_gates"] == sum(g.control is None
                                              for g in circuit)
        assert r["host_seconds"] is None and r["hw"] == "h100_sxm"
        assert r["bound_seconds"] == pytest.approx(
            16 * 2 ** 8 * len(circuit) / 3.35e12)
        if r["version"] != "nonvec/planar":
            assert r["fidelity_vs_kernel"] >= 1 - 1e-5
            assert abs(r["norm"] - 1) <= 1e-4
    assert "host-paced" in rows[0]["note"]


def test_fig9_raises_when_the_kernel_version_disagrees(monkeypatch):
    real = qsim.run_kernel_planar

    def wrong(re, im, circuit):
        r, i = real(re, im, circuit)
        return r.flip(0), i

    monkeypatch.setattr(qsim, "run_kernel_planar", wrong)
    with pytest.raises(AssertionError, match="fidelity"):
        fig9_qsim.run(CPU, 6, 2, measure=False)


def test_fig9_fidelity_of_a_state_with_itself_is_its_norm_to_the_fourth():
    re = torch.tensor([0.6, 0.0]), torch.tensor([0.0, 0.8])
    assert fig9_qsim.fidelity(re, re) == pytest.approx(1.0)
    assert fig9_qsim.norm(re) == pytest.approx(1.0)
    other = torch.tensor([0.0, 1.0]), torch.tensor([0.0, 0.0])
    assert fig9_qsim.fidelity(re, other) == pytest.approx(0.64)


def test_fig9_measure_needs_the_card():
    with pytest.raises((RuntimeError, ValueError)):
        fig9_qsim.run(CPU, 4, 1, measure=True)
