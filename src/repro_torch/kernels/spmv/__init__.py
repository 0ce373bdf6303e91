"""ELL SpMV, the irregular-access proxy app, in the JAX package's two
idioms (gather and one-hot).

- ``ref.py`` — the plain PyTorch version of each idiom and ``random_ell``
  (a copy of the JAX package's numpy helper, so both packages build the
  same matrix).
- ``csrc/spmv.cu`` + ``kernel.py`` — the two CUDA kernels and their
  bindings.
- ``ops.py`` — ``spmv_ell(idiom=...)``: a CPU tensor runs the plain
  version, a CUDA tensor launches the idiom's kernel or raises.
"""
