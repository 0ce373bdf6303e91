"""Single-qubit 2x2 complex gate on a planar state vector (paper §6, Qsim).

- ``ref.py`` — the plain PyTorch versions (planar and complex).
- ``csrc/qsim_gate.cu`` + ``kernel.py`` — the CUDA kernel (one thread per
  amplitude pair, the gate by value) and its ctypes binding.
- ``ops.py`` — ``apply_gate_planar(re, im, gate, qubit)``: a CPU tensor
  runs the plain version, a CUDA tensor launches the kernel or raises.
"""
