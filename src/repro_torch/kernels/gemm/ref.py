"""Plain GEMM (counterpart of ``repro.kernels.gemm.ref``).  It computes in
the inputs' type: fp32 (TF32 only if the caller turned it on) or fp64."""
import torch


def gemm(a, b, out_dtype=None) -> torch.Tensor:
    out = torch.matmul(a, b)
    return out if out_dtype in (None, out.dtype) else out.to(out_dtype)
