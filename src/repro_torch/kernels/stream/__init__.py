"""STREAM copy / scale / add / triad, the unit-stride memory benchmark.

- ``ref.py`` — the plain PyTorch versions.
- ``csrc/stream.cu`` + ``kernel.py`` — the CUDA kernel (all four kinds,
  one template) and its ctypes binding.
- ``ops.py`` — ``stream(kind, x, y, alpha)``: a CPU tensor runs the plain
  version, a CUDA tensor launches the kernel or raises.
"""
