"""Weight-only int8 GEMM with the dequant inside the kernel: the int8
serving path's matmul (every q-pack product of ``models.quant``).

- ``ref.py`` — the plain PyTorch versions: the quantizer and
  dequantize-then-matmul (the CPU path and the on-card oracle).
- ``csrc/wq_gemm.cu`` + ``kernel.py`` — the CUDA kernel for sm_90a and its
  ctypes binding, in both weight layouts ((K, N) and the tied unembed's
  (N, K)).
- ``ops.py`` — ``wq_gemm``: a CPU tensor runs the plain version, a CUDA
  tensor launches the kernel or raises.
"""
