"""Weight-only int8 GEMM entry (counterpart of
``repro.kernels.wq_gemm.ops``).

A CPU tensor runs the plain version (``ref.wq_gemm``); a CUDA tensor
launches the CUDA kernel (``kernel.wq_gemm``) or raises — there is no
fallback.  The kernel has no backward: on the card a call that would need
a gradient raises (int8 packs serve; they do not train).
"""
from __future__ import annotations

import torch

from repro_torch.kernels.wq_gemm import kernel as K
from repro_torch.kernels.wq_gemm import ref
from repro_torch.kernels.wq_gemm.ref import quantize  # noqa: F401 (public API)


def wq_gemm(x, q, scale, *, out_dtype=None, q_transposed=False
            ) -> torch.Tensor:
    """y (M, N) = x (M, K) @ (q * scale[N]) in ``out_dtype`` (x's unless
    given); q int8 (K, N), or (N, K) with ``q_transposed``.  The CUDA
    kernel's tiles are fixed for Hopper: the JAX op's tile knobs
    (``block_multiplier``, ``bk``) have no counterpart here."""
    if x.device.type == "cpu":
        return ref.wq_gemm(x, q, scale, out_dtype, q_transposed)
    if torch.is_grad_enabled() and x.requires_grad:
        raise NotImplementedError(
            "wq_gemm backward: the int8 kernel serves and has no gradient")
    return K.wq_gemm(x.contiguous(), q, scale, out_dtype=out_dtype,
                     q_transposed=q_transposed)
