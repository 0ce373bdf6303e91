"""Strided row gather, the paper's Fig 2 idioms (vlse vs masked vle).

- ``ref.py`` — the plain PyTorch version.
- ``csrc/strided.cu`` + ``kernel.py`` — the CUDA kernels (row-wise reads
  of the rows needed; contiguous over-fetch of each group with a select)
  and their ctypes binding.
- ``ops.py`` — ``strided_gather(x, stride, idiom)``: a CPU tensor runs
  the plain version, a CUDA tensor launches the idiom's kernel or raises.
"""
