"""Flash attention: the forward (train / prefill: causal or full) and the
dense-cache decode, GQA by query grouping, softcap.

- ``ref.py`` — the plain PyTorch versions (the CPU paths and the on-card
  oracles of the kernels): ``flash_fwd`` over the grouped layout,
  ``flash_decode`` over the cache's own layout.
- ``csrc/flash_attention.cu``, ``csrc/flash_decode.cu`` + ``kernel.py`` —
  the two CUDA kernels for sm_90a (one library each) and their ctypes
  bindings.
- ``ops.py`` — ``flash_attention`` in the JAX layout (device dispatch,
  grouping) and the autograd function whose backward recomputes the
  probabilities per KV chunk from the saved log-sum-exp; ``flash_decode``
  with the JAX op's signature (device dispatch).
"""
