"""Carry a JAX parameter tree, given as numpy arrays, into the port.

``params_from_numpy(tree)`` takes the reference ``LM``'s parameter tree
with every leaf converted to numpy — ``embed.table``, ``final_norm.scale``
(``unembed.table`` when untied) and ``stack.*`` with a leading layer
axis — and returns the port's parameters: the same dicts with the stack
split into one dict per layer.  Dense weights stay (d_in, d_out), so both
packages compute ``x @ w``.  bfloat16 leaves (numpy's ``bfloat16``
extension dtype) are carried bit for bit.
"""
from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch

from repro_torch.kernels.common import resolve_device


def tensor_from_numpy(a, device) -> torch.Tensor:
    a = np.ascontiguousarray(a)
    if a.dtype.name == "bfloat16":
        t = torch.from_numpy(a.view(np.uint16).copy()).view(torch.bfloat16)
    else:
        t = torch.from_numpy(a.copy())
    return t.to(device)


def _map(fn, tree):
    if isinstance(tree, dict):
        return {k: _map(fn, v) for k, v in tree.items()}
    return fn(tree)


def params_from_numpy(tree: Dict[str, Any], device=None) -> Dict[str, Any]:
    dev = resolve_device(device)
    out = {k: _map(lambda a: tensor_from_numpy(a, dev), v)
           for k, v in tree.items() if k != "stack"}
    leaves = []
    _map(leaves.append, tree["stack"])
    n_layers = int(np.shape(leaves[0])[0])
    out["stack"] = [_map(lambda a, i=i: tensor_from_numpy(a[i], dev),
                         tree["stack"]) for i in range(n_layers)]
    return out
