"""Plain weight-only int8 GEMM and its quantizer (counterpart of
``repro.kernels.wq_gemm.ref``).

``quantize`` is per-output-channel symmetric int8 over the contraction
axis: ``amax / 127`` with amax floored at 1e-8, ``torch.round`` (half to
even, as ``jnp.round``), clipped to +-127 — the reference's bits.
``wq_gemm`` dequantizes in fp32 and multiplies in fp32; it computes in
fp32 whatever ``x``'s type, TF32 only if the caller turned it on.
"""
import torch


def quantize(w: torch.Tensor):
    """w: (..., K, N) -> q (..., K, N) int8, scale (..., N) fp32: one scale
    per output column (and per leading index, an MoE expert's)."""
    wf = w.float()
    scale = torch.clamp_min(wf.abs().amax(dim=-2), 1e-8) / 127.0
    q = torch.round(wf / scale.unsqueeze(-2)).clamp(-127, 127)
    return q.to(torch.int8), scale


def wq_gemm(x, q, scale, out_dtype=None, q_transposed=False):
    """y (M, N) = x (M, K) @ (q * scale[N]).  q is (K, N), or (N, K) with
    ``q_transposed`` (the tied unembed's table: its per-row scale is the
    per-output-channel scale).  Out in ``out_dtype`` (x's unless given)."""
    out_dtype = out_dtype or x.dtype
    qf = q.float()
    w = (qf.T if q_transposed else qf) * scale.float()
    return (x.float() @ w).to(out_dtype)
