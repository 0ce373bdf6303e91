"""Tail handling, the paper's Fig 3 idioms (vsetvl vs masked predication):
``silu(x) * 2`` over rows that are not a whole number of tiles.

- ``ref.py`` — the plain PyTorch versions.
- ``csrc/tailmask.cu`` + ``kernel.py`` — the CUDA kernel (one template,
  with or without the mask) and its ctypes binding.
- ``ops.py`` — ``tail_compute(x, idiom, n_valid)``: a CPU tensor runs the
  plain version, a CUDA tensor launches the idiom's kernel or raises.
"""
