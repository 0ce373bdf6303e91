"""Chunked Mamba-2 SSD scan (state-space duality): the ssm family's
prefill hot spot.

- ``ref.py`` — the plain PyTorch versions: the token-by-token oracle and
  the chunked form in the model's layout (the CPU path and the on-card
  oracle of the kernel).
- ``csrc/ssd_scan.cu`` + ``kernel.py`` — the CUDA kernel for sm_90a and
  its ctypes binding; it also writes the final state prefill needs.
- ``ops.py`` — ``ssd_chunked`` (model layout) and ``ssd_scan`` (the
  Pallas op's stream layout), with device dispatch.
"""
