"""Carry a JAX parameter tree, given as numpy arrays, into the port and
back.

``params_from_numpy(tree)`` takes the reference ``LM``'s parameter tree
with every leaf converted to numpy — ``embed.table``, ``final_norm.scale``
(``unembed.table`` when untied), ``stack.*`` with a leading layer axis
and, for the audio family, ``encoder.stack.*`` too — and returns the
port's parameters: the same dicts with each stack split into one dict
per layer.  ``params_to_numpy`` is the inverse: it
restacks the per-layer dicts into ``(L, ...)`` leaves.  Dense weights
stay (d_in, d_out), so both packages compute ``x @ w``.  A quantized tree
(``models.quant``) crosses the same way: each q-pack's int8 ``q`` (L, K,
N) and fp32 ``scale`` (L, N) split per layer and restack bit for bit.
bfloat16 leaves are carried bit for bit: in, from numpy's ``bfloat16``
extension dtype or from raw 2-byte ``V2`` bits; out, as ``V2`` bits
(``np.save`` writes them as the reference's checkpointer does), since
numpy has no bfloat16 of its own.

``params_from_numpy(..., shard=(specs, mesh, rules))`` gives a rank of a
mesh only its blocks (``parallel.axes.local_slice`` of each leaf under
its resolved spec): a block of a memory-mapped array is the only part
read.
"""
from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

from repro_torch.kernels.common import resolve_device
from repro_torch.parallel import axes as paxes
from repro_torch.tree import tree_leaves


BF16_BITS = np.dtype("V2")


def tensor_from_numpy(a, device) -> torch.Tensor:
    a = np.ascontiguousarray(a).reshape(np.shape(a))     # keeps 0-d 0-d
    if a.dtype.name == "bfloat16" or a.dtype == BF16_BITS:
        t = torch.from_numpy(a.view(np.uint16).copy()).view(torch.bfloat16)
    else:
        t = torch.from_numpy(a.copy())
    return t.to(device)


def params_from_numpy(tree: Dict[str, Any], device=None, *,
                      shard: Optional[Tuple[Any, Any, Any]] = None
                      ) -> Dict[str, Any]:
    """The reference's numpy tree as the port's parameters on ``device``.
    ``shard``: ``(specs, mesh, rules)``, the port's spec tree of these
    parameters (``LM.layout_specs``), a ``launch.mesh.Mesh`` and the rules
    (``None``: the defaults); each leaf is then cut to this rank's block
    before it is copied."""
    dev = resolve_device(device)
    specs, mesh, rules = shard if shard is not None else (None, None, None)

    def put(a, spec):
        if spec is not None:
            a = paxes.local_slice(a, paxes.resolve_spec(
                spec, np.shape(a), mesh, rules, record=False), mesh)
        return tensor_from_numpy(a, dev)

    out = {}
    for k, v in tree.items():
        spec = None if specs is None else specs[k]
        if k == "stack":
            n_layers = int(np.shape(tree_leaves(v)[0])[0])
            out[k] = [_map(lambda a, sp, i=i: put(a[i], sp), v,
                           None if spec is None else spec[i])
                      for i in range(n_layers)]
        elif k == "encoder":
            out[k] = params_from_numpy(
                v, dev, shard=None if shard is None else (spec, mesh, rules))
        else:
            out[k] = _map(put, v, spec)
    return out


def _map(fn, tree, spec):
    """``fn(leaf, its spec or None)`` over a dict tree."""
    if isinstance(tree, dict):
        return {k: _map(fn, tree[k], None if spec is None else spec[k])
                for k in sorted(tree)}
    return fn(tree, spec)


def tensor_to_numpy(t: torch.Tensor) -> np.ndarray:
    """A host copy of ``t``; bfloat16 as ``V2`` bits."""
    t = t.detach().to("cpu", copy=True).contiguous()
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(BF16_BITS)
    return t.numpy()


def params_to_numpy(tree) -> Any:
    """A tree of the port (params, moments, a train state) as the
    reference's tree of numpy arrays: every per-layer list restacked
    into ``(L, ...)`` leaves."""
    if isinstance(tree, dict):
        return {k: params_to_numpy(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return stack_layers(tree)
    return tensor_to_numpy(tree)


def stack_layers(layers):
    """A list of same-structure per-layer dicts of tensors -> one dict of
    numpy leaves with a leading layer axis."""
    if isinstance(layers[0], dict):
        return {k: stack_layers([layer[k] for layer in layers])
                for k in layers[0]}
    return np.stack([tensor_to_numpy(t) for t in layers])
