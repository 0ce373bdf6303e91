"""Int8 gradient compression with error feedback, a copy of
``repro.optim.compression`` over the port's trees.

``compress`` / ``decompress`` are per-tensor symmetric int8 quantization;
``ef_compress_tree`` applies it across a gradient tree carrying an error-
feedback residual, so the quantization error is re-injected the next
step (EF-SGD, 1-bit Adam).  The arithmetic is the reference's, op for op
in fp32 (``torch.round`` rounds half to even, as ``jnp.round`` does), so
the int8 payload is bitwise the reference's on the same fp32 input.  In
the reference the payload is what would cross the data-parallel links;
the port has no mesh yet (ROADMAP A10), so the step only applies the
quantization and its feedback.

Unlike the reference's pure function, ``ef_compress_tree`` writes the new
residual into ``err`` in place and returns it (as ``optim.adamw`` does
with the moments): no second fp32 copy of the model at full width.
"""
from __future__ import annotations

from typing import Any, Tuple

import torch

from repro_torch.tree import tree_map


def _scale(amax: torch.Tensor) -> torch.Tensor:
    return torch.clamp(amax, min=1e-12) / 127.0


def _quantize(g: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return torch.clamp(torch.round(g / scale), -127, 127).to(torch.int8)


def compress(g: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Symmetric per-tensor int8.  Returns (q, scale), scale fp32 0-d."""
    scale = _scale(g.abs().max())
    return _quantize(g, scale), scale


def decompress(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return q.to(torch.float32) * scale


def _stacked_map(fn, tree, other):
    """``fn(leaves, others) -> outs`` over the reference's leaves: a plain
    tensor is one leaf; a layer stack (a list of layer dicts) holds one
    leaf a key path, its tensors across the layers — the reference's
    (L, ...) leaf.  Returns the tree of ``fn``'s outputs."""
    if isinstance(tree, dict):
        return {k: _stacked_map(fn, tree[k], other[k]) for k in sorted(tree)}
    if isinstance(tree, list):
        return _columns(fn, tree, other)
    return fn([tree], [other])[0]


def _columns(fn, layers, others):
    if isinstance(layers[0], dict):
        cols = {k: _columns(fn, [t[k] for t in layers],
                            [o[k] for o in others]) for k in layers[0]}
        return [{k: cols[k][i] for k in cols} for i in range(len(layers))]
    return fn(layers, others)


def ef_compress_tree(grads, err) -> Tuple[Any, Any]:
    """Quantize grads + err; return (the dequantized fp32 grads, err) with
    ``err`` updated in place to the new residual ``grads + err - deq``.
    The scale is per reference leaf: a layer stack's tensors share one,
    as the reference's (L, ...) leaf has one."""
    def one(gs, es):
        gfs = [g.to(torch.float32) + e for g, e in zip(gs, es)]
        scale = _scale(torch.stack([gf.abs().max() for gf in gfs]).max())
        out = []
        for gf, e in zip(gfs, es):
            deq = decompress(_quantize(gf, scale), scale)
            e.copy_(gf - deq)
            out.append(deq)
        return out

    with torch.no_grad():
        return _stacked_map(one, grads, err), err


def init_error_state(params):
    """A zero fp32 residual for every parameter."""
    return tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                          device=p.device), params)
