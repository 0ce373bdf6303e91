"""Layer functions: norms, linear, embeddings, RoPE, the MLP (SwiGLU or
GELU).

Counterparts of ``repro.models.layers``, with its casts kept: the RMS
scale sums in fp32 and is cast to the compute dtype, RoPE angles are
fp32 in the half-split layout, and dense weights are (d_in, d_out) so
both packages compute ``x @ w``.  Parameters are nested dicts of tensors
with the same keys as the JAX parameter tree.  An int8 serving pack
(``models.quant``: ``{"q", "scale"}`` in place of a dense ``w``, or as an
embedding ``table``) goes through the int8 GEMM in ``dense`` and the
unembed, and is dequantized per gathered row in ``embed``.
"""
from __future__ import annotations

from typing import Any, Dict

import torch
import torch.nn.functional as F

from repro_torch.models.quant import is_qpack, matmul_q

Params = Dict[str, Any]

DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16,
          "float16": torch.float16}


def dtype_of(name: str) -> torch.dtype:
    return DTYPES[name]


# ---------------------------------------------------------------------------
# norms
# ---------------------------------------------------------------------------
def _rms_scale(x: torch.Tensor, eps: float) -> torch.Tensor:
    """1/rms(x), summed in fp32: fp32 (..., 1)."""
    xf = x.float()
    var = (xf * xf).sum(dim=-1, keepdim=True) / x.shape[-1]
    return torch.rsqrt(var + eps)


def rms_norm_nd(x: torch.Tensor, scale: torch.Tensor,
                eps: float = 1e-5) -> torch.Tensor:
    """RMSNorm over the last dim with an explicit scale vector."""
    if x.dtype == torch.float32:
        return x * _rms_scale(x, eps) * scale.float()
    r = _rms_scale(x, eps).to(x.dtype)
    return x * r * scale.to(x.dtype)


def rms_norm(x: torch.Tensor, params: Params,
             eps: float = 1e-5) -> torch.Tensor:
    return rms_norm_nd(x, params["scale"], eps)


# ---------------------------------------------------------------------------
# linear, embeddings
# ---------------------------------------------------------------------------
def dense(x: torch.Tensor, params: Params) -> torch.Tensor:
    if "w" not in params:               # int8 serving pack (models.quant)
        return matmul_q(x, params)
    return x @ params["w"].to(x.dtype)


def embed(tokens: torch.Tensor, params: Params,
          compute_dtype: torch.dtype) -> torch.Tensor:
    """Row gather (the reference's one-hot matmul gives the same bits);
    an int8 table gathers rows and scales each by its own scale."""
    t = params["table"]
    if is_qpack(t):
        return (t["q"][tokens].to(compute_dtype)
                * t["scale"][tokens][..., None].to(compute_dtype))
    return t.to(compute_dtype)[tokens]


def unembed(x: torch.Tensor, params: Params) -> torch.Tensor:
    """Project back to (padded) vocab logits.  An int8 (V, d) table is read
    in place as the transposed weight: its per-row scale is the
    per-output-channel scale."""
    return matmul_q(x, params["table"], transposed=True)


# ---------------------------------------------------------------------------
# RoPE
# ---------------------------------------------------------------------------
def rope_frequencies(head_dim: int, theta: float,
                     device=None) -> torch.Tensor:
    exponents = torch.arange(0, head_dim, 2, dtype=torch.float32,
                             device=device) / head_dim
    return 1.0 / (theta ** exponents)                       # (head_dim/2,)


def rope_tables(positions: torch.Tensor, head_dim: int, theta: float):
    """fp32 (cos, sin) for ``positions`` (..., seq): (..., seq, 1, hd/2)
    each — computed once per forward and shared by every layer."""
    freqs = rope_frequencies(head_dim, theta, positions.device)
    angles = positions[..., None].float() * freqs
    return torch.cos(angles)[..., None, :], torch.sin(angles)[..., None, :]


def apply_rope(x: torch.Tensor, cos: torch.Tensor,
               sin: torch.Tensor) -> torch.Tensor:
    """x: (..., seq, heads, head_dim); half-split layout, fp32 math."""
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


# ---------------------------------------------------------------------------
# MLP: SwiGLU where the params hold a gate, else GELU (whisper's)
# ---------------------------------------------------------------------------
def mlp(x: torch.Tensor, params: Params) -> torch.Tensor:
    if "gate" in params:
        h = F.silu(dense(x, params["gate"])) * dense(x, params["up"])
    else:
        # jax.nn.gelu's default is the tanh approximation
        h = F.gelu(dense(x, params["up"]), approximate="tanh")
    return dense(h, params["down"])
