"""Tiled GEMM, fp32 and fp64 (veceval's sgemm and dgemm).

- ``ref.py`` — the plain PyTorch version.
- ``csrc/gemm.cu`` + ``kernel.py`` — the CUDA kernel and its binding.
- ``ops.py`` — ``gemm``: a CPU tensor runs the plain version, a CUDA
  tensor launches the kernel or raises.
"""
