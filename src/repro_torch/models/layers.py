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

The ``*_specs`` functions are the reference's logical-axis names of each
parameter (``parallel.axes``).  Under a sharding context a rank holds its
block of each sharded weight, and the layers compute on it: the
embedding is vocab-parallel (a masked lookup of the rank's rows, then a
sum over the vocab axis), the unembed gives the rank's logits, gathered
over the vocab axis, and a row-parallel product (``row_parallel``: the
MLP's down projection, attention's output projection) is summed over
its axis.  Without a context nothing changes.
"""
from __future__ import annotations

from typing import Any, Dict

import torch
import torch.nn.functional as F

from repro_torch.models.quant import is_qpack, matmul_q
from repro_torch.parallel import axes as paxes
from repro_torch.parallel import collectives

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


def rmsnorm_specs() -> Params:
    return {"scale": ("embed",)}


def rms_norm(x: torch.Tensor, params: Params,
             eps: float = 1e-5) -> torch.Tensor:
    return rms_norm_nd(x, params["scale"], eps)


# ---------------------------------------------------------------------------
# linear, embeddings
# ---------------------------------------------------------------------------
def dense_specs(in_axis, out_axis) -> Params:
    return {"w": (in_axis, out_axis)}


def in_dim(params: Params) -> int:
    """The contraction dim a rank holds of a dense weight or q-pack."""
    return (params["w"] if "w" in params else params["q"]).shape[0]


def dense(x: torch.Tensor, params: Params) -> torch.Tensor:
    if "w" not in params:               # int8 serving pack (models.quant)
        return matmul_q(x, params)
    return x @ params["w"].to(x.dtype)


def row_parallel(y: torch.Tensor, params: Params, full_in: int,
                 name: str) -> torch.Tensor:
    """``y``, the product of a rank's block of a dense weight's input
    rows: the sum over logical axis ``name``'s ranks where the weight's
    input dim is split (``full_in`` its whole size), else ``y``."""
    if paxes.active() and in_dim(params) < full_in:
        return collectives.all_reduce_sum(y, paxes.rule_axes(name))
    return y


def embedding_specs() -> Params:
    return {"table": ("vocab", "embed")}


def _rows(table) -> int:
    return (table["q"] if is_qpack(table) else table).shape[0]


def _lookup(table, tokens: torch.Tensor, dtype) -> torch.Tensor:
    if is_qpack(table):
        return (table["q"][tokens].to(dtype)
                * table["scale"][tokens][..., None].to(dtype))
    return table.to(dtype)[tokens]


def embed(tokens: torch.Tensor, params: Params,
          compute_dtype: torch.dtype, vocab: int = 0) -> torch.Tensor:
    """Row gather (the reference's one-hot matmul gives the same bits);
    an int8 table gathers rows and scales each by its own scale.  Where a
    rank holds fewer than ``vocab`` rows (vocab-parallel), it looks up
    the tokens in its block, zeros the others and sums over the vocab
    axis: each token's row comes from one rank, plus exact zeros."""
    t = params["table"]
    rows = _rows(t)
    if not vocab or rows == vocab:
        return _lookup(t, tokens, compute_dtype)
    local = tokens - paxes.rule_index("vocab") * rows
    inside = (local >= 0) & (local < rows)
    x = _lookup(t, local.clamp(0, rows - 1), compute_dtype)
    x = torch.where(inside[..., None], x, torch.zeros((), dtype=x.dtype,
                                                      device=x.device))
    return collectives.all_reduce_sum(x, paxes.rule_axes("vocab"))


def unembed(x: torch.Tensor, params: Params, vocab: int = 0) -> torch.Tensor:
    """Project back to (padded) vocab logits.  An int8 (V, d) table is read
    in place as the transposed weight: its per-row scale is the
    per-output-channel scale.  A rank holding fewer than ``vocab`` rows
    computes its block of the logits, gathered over the vocab axis."""
    y = matmul_q(x, params["table"], transposed=True)
    if vocab and _rows(params["table"]) < vocab:
        y = collectives.all_gather(y, -1, paxes.rule_axes("vocab"))
    return y


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
def mlp_specs(mlp_type: str = "swiglu") -> Params:
    p = {
        "up": dense_specs("embed", "mlp"),
        "down": dense_specs("mlp", "embed"),
    }
    if mlp_type != "gelu":
        p["gate"] = dense_specs("embed", "mlp")
    return p


def mlp(x: torch.Tensor, params: Params) -> torch.Tensor:
    if "gate" in params:
        h = F.silu(dense(x, params["gate"])) * dense(x, params["up"])
    else:
        # jax.nn.gelu's default is the tanh approximation
        h = F.gelu(dense(x, params["up"]), approximate="tanh")
    return dense(h, params["down"])
