"""ELL SpMV, the irregular-access proxy app.

- ``ref.py`` — the plain PyTorch version and ``random_ell`` (a copy of
  the JAX package's numpy helper, so both packages build the same matrix).
- ``csrc/spmv.cu`` + ``kernel.py`` — the CUDA kernel and its binding.
- ``ops.py`` — ``spmv_ell``: a CPU tensor runs the plain version, a CUDA
  tensor launches the kernel or raises.
"""
