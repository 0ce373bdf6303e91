"""Paged flash-decode attention: the page-table walk fused into the kernel.

- ``ref.py`` — plain PyTorch versions (gather oracle + grouped partials).
- ``csrc/paged_attention.cu`` + ``kernel.py`` — the CUDA kernel for
  sm_90a and its ctypes binding.
- ``ops.py`` — ``paged_attention`` (device dispatch, normalization) and
  ``combine_partials``.
"""
