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
weights (~0.4% relative).  ``quantize_specs`` is the spec tree of a
quantized model, which only sharding reads: a q-pack is sliced as its
weight, its ``scale`` follows the weight's out axis (whole where only the
contraction dim is split), so each rank's slice goes through the int8
GEMM on its own.
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


def has_qpack(tree: Any) -> bool:
    """Whether a parameter tree holds an int8 pack anywhere."""
    if is_qpack(tree):
        return True
    if isinstance(tree, dict):
        return any(has_qpack(v) for v in tree.values())
    if isinstance(tree, list):
        return any(has_qpack(v) for v in tree)
    return False


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


def quantize_specs(specs: Dict[str, Any], params: Dict[str, Any]
                   ) -> Dict[str, Any]:
    """Mirror ``quantize_params`` over the logical-axis spec tree (the
    port's layout: per-layer lists).  q keeps the weight's spec; scale
    takes the spec's out-dim axis.  ``params``, the float tree or the
    quantized one (anything of that structure whose leaves have
    ``ndim``), says which leaves are the weights ``quantize_params``
    packs."""

    def scale_spec(v: tuple) -> tuple:
        # scales reduce over the contraction (second-to-last) dim
        return tuple(v[:-2]) + (v[-1],)

    def ndim(x) -> int:
        return x["q"].ndim if is_qpack(x) else getattr(x, "ndim", 0)

    def walk(spec, leaf):
        if isinstance(spec, list):
            return [walk(s, t) for s, t in zip(spec, leaf)]
        if not isinstance(spec, dict):
            return spec
        if set(spec) == {"w"} and ndim(leaf.get("w", leaf)) == 2:
            return {"q": spec["w"], "scale": scale_spec(spec["w"])}
        if set(spec) == {"table"}:
            return {"table": {"q": spec["table"],
                              "scale": (spec["table"][0],)}}
        out = {}
        for k, v in spec.items():
            sv = leaf.get(k) if isinstance(leaf, dict) else None
            if k in _MOE_KEYS and ndim(sv) == 3:
                out[k] = {"q": v, "scale": scale_spec(v)}
            elif k in _MAMBA_KEYS and "A_log" in spec and ndim(sv) == 2:
                out[k] = {"q": v, "scale": scale_spec(v)}
            else:
                out[k] = walk(v, sv)
        return out

    return walk(specs, params)
