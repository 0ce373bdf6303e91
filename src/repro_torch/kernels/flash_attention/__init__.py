"""Flash-attention forward (train / prefill): causal or full, GQA by
query grouping, softcap.

- ``ref.py`` — the plain PyTorch version over the grouped layout (the
  CPU path and the on-card oracle of the kernel).
- ``csrc/flash_attention.cu`` + ``kernel.py`` — the CUDA kernel for
  sm_90a and its ctypes binding.
- ``ops.py`` — ``flash_attention`` in the JAX layout (device dispatch,
  grouping) and the autograd function whose backward recomputes the
  probabilities per KV chunk from the saved log-sum-exp.
"""
