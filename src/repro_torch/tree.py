"""Parameter trees of the port: nested dicts of tensors, with the layer
stack a list of per-layer dicts (the reference keeps one leaf with a
leading layer axis instead).  ``tree_map`` and ``tree_leaves`` walk dicts
in sorted key order and lists in order."""
from __future__ import annotations

from typing import Any, Callable, List


def tree_map(fn: Callable, tree, *rest):
    if isinstance(tree, dict):
        return {k: tree_map(fn, tree[k], *(r[k] for r in rest))
                for k in sorted(tree)}
    if isinstance(tree, list):
        return [tree_map(fn, t, *(r[i] for r in rest))
                for i, t in enumerate(tree)]
    return fn(tree, *rest)


def tree_leaves(tree) -> List[Any]:
    out: List[Any] = []
    tree_map(out.append, tree)
    return out
