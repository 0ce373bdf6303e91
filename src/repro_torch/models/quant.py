"""Weight-only int8 quantization for serving: the counterpart of
``repro.models.quant``.

``quantize_params`` walks the port's parameter tree (a per-layer stack)
and replaces the large matmul weights with ``{"q": int8, "scale": fp32}``
packs:
  * dense packs  {"w": (in, out)}            -> per-out-channel scales
  * MoE experts  gate/up/down (E, in, out)   -> per-(expert, out) scales
  * Mamba projections (wz, wx, wB, wC, wdt, out)
  * embedding tables (per-row scales; the gather dequantizes per token)

``layers.dense``, the Mamba projections and the tied unembed all route a
pack through the int8 GEMM (``kernels.wq_gemm``: the CUDA kernel on the
card, its plain version on the CPU), so the quantized tree drops into the
unmodified forward.  Per-output-channel symmetric scales keep (x @ q)·s
== x @ (q·s) up to rounding; the only error is the int8 rounding of the
weights (~0.4% relative).  The reference's ``quantize_specs`` waits for
the port's sharding (ROADMAP A10).
"""
from __future__ import annotations

from typing import Any, Dict

import torch

from repro_torch.kernels.wq_gemm import ops as wq_ops
from repro_torch.kernels.wq_gemm import ref as wq_ref
from repro_torch.tree import tree_leaves

_MAMBA_KEYS = ("wz", "wx", "wB", "wC", "wdt", "out")
_MOE_KEYS = ("gate", "up", "down")


def quant_dense(w: torch.Tensor) -> Dict[str, torch.Tensor]:
    """(in, out) or (E, in, out): per-out-channel scales (reduce over the
    contraction dim, keep leading expert dims).  An expert leaf is
    quantized one expert at a time, so the quantizer's fp32 temporaries
    are one expert's (a whole grok-1 leaf's would be ~6 GB each); the
    bits are the whole leaf's."""
    if w.dim() == 2:
        q, scale = wq_ref.quantize(w)
        return {"q": q, "scale": scale}
    q = torch.empty(w.shape, dtype=torch.int8, device=w.device)
    scale = torch.empty((w.shape[0], w.shape[-1]), dtype=torch.float32,
                        device=w.device)
    for e in range(w.shape[0]):
        q[e], scale[e] = wq_ref.quantize(w[e])
    return {"q": q, "scale": scale}


def dequant(w: Dict[str, torch.Tensor], dtype) -> torch.Tensor:
    return w["q"].to(dtype) * w["scale"].to(dtype).unsqueeze(-2)


def quant_table(t: torch.Tensor) -> Dict[str, torch.Tensor]:
    """(V, d) embedding: per-row scales (gather-side dequant), the
    quantizer's rule on the (d, V) view."""
    q, scale = wq_ref.quantize(t.T)
    return {"q": q.T.contiguous(), "scale": scale}


def is_qpack(p: Any) -> bool:
    return isinstance(p, dict) and set(p.keys()) == {"q", "scale"}


def matmul_q(x: torch.Tensor, w: Any, transposed: bool = False
             ) -> torch.Tensor:
    """x @ w (``transposed``: x @ w.T, for a (V, d) table) for a raw
    weight (cast to x's dtype) or an int8 q-pack: the leading dims of x
    flatten to (M, K) for the int8 GEMM, which reads a transposed pack in
    place."""
    if is_qpack(w):
        y = wq_ops.wq_gemm(x.reshape(-1, x.shape[-1]), w["q"], w["scale"],
                           q_transposed=transposed)
        return y.reshape(*x.shape[:-1], y.shape[-1])
    w = w.to(x.dtype)
    return x @ (w.T if transposed else w)


def _is_weight(v: Any, ndim: int) -> bool:
    return torch.is_tensor(v) and v.dim() == ndim


def quantize_params(params: Dict[str, Any]) -> Dict[str, Any]:
    """Quantize the large weights of the port's parameter tree.  The stack
    is per layer, so a dense pack is 2-d and an MoE expert weight 3-d
    (the reference's layer-stacked tree adds one dim to each)."""

    def walk(tree):
        if isinstance(tree, list):
            return [walk(v) for v in tree]
        if not isinstance(tree, dict):
            return tree
        if set(tree) == {"w"} and _is_weight(tree["w"], 2):
            return quant_dense(tree["w"])
        if set(tree) == {"table"}:
            return {"table": quant_table(tree["table"])}
        out = {}
        for k, v in tree.items():
            if k in _MOE_KEYS and _is_weight(v, 3):
                out[k] = quant_dense(v)
            elif k in _MAMBA_KEYS and _is_weight(v, 2) and "A_log" in tree:
                out[k] = quant_dense(v)
            else:
                out[k] = walk(v)
        return out

    return walk(params)


def param_bytes(tree: Any) -> int:
    """Bytes of every tensor in a parameter tree."""
    return sum(t.numel() * t.element_size() for t in tree_leaves(tree))
