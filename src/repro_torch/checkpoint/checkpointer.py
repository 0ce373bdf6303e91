"""Checkpoints in the reference's on-disk format: atomic save
(write-temp + rename), a JSON manifest, retention, and latest-step
discovery for auto-resume.  Saves are synchronous.

Counterpart of ``repro.checkpoint.checkpointer``, and readable both
ways: ``step_%010d/leaf_<i>.npy`` plus ``manifest.json`` (step, time,
treedef, per-leaf key / shape / dtype, metadata), the leaves in the
order of ``jax.tree_util.tree_flatten_with_path`` — dict keys sorted —
with the same ``key`` strings (``params/stack/attn/wq/w``, ...).  The
port's per-layer dicts are restacked into the reference's ``(L, ...)``
leaves on save and split again on restore.  bfloat16 leaves are stored
as raw 2-byte bits (``V2``, as the reference's numpy writes them) and
read back by the manifest's ``"bfloat16"`` dtype.

The manifest's ``time`` is the file system's modification time of the
step directory once its leaves are written, not a clock read.
"""
from __future__ import annotations

import json
import os
import pathlib
import shutil
from typing import Any, Dict, Iterator, List, Optional, Tuple

import numpy as np

from repro_torch.weights import BF16_BITS, params_to_numpy, tensor_from_numpy


def _flatten(tree, path=()) -> Iterator[Tuple[str, Any]]:
    """(key, leaf) of a host tree in the reference's order (keys sorted)."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _flatten(tree[k], path + (k,))
    else:
        yield "/".join(path), tree


def _treedef(tree) -> str:
    if isinstance(tree, dict):
        return "{" + ", ".join(f"'{k}': {_treedef(tree[k])}"
                               for k in sorted(tree)) + "}"
    return "*"


def _unflatten(keys, leaves) -> Dict[str, Any]:
    """The host tree whose flattened keys are ``keys``."""
    tree: Dict[str, Any] = {}
    for key, leaf in zip(keys, leaves):
        *parents, name = key.split("/")
        node = tree
        for p in parents:
            node = node.setdefault(p, {})
        node[name] = leaf
    return tree


def _layer(host, i: int, n: int):
    """Layer ``i`` of a host subtree whose leaves stack ``n`` layers."""
    if isinstance(host, dict):
        return {k: _layer(v, i, n) for k, v in host.items()}
    if host.shape[0] != n:
        raise ValueError(f"checkpoint stacks {host.shape[0]} layers, the "
                         f"tree has {n}")
    return host[i]


def _to_tree(host, like):
    """``host`` (numpy) laid out as ``like``: same structure, each leaf on
    its counterpart's device, layer lists split from the stacked leaves."""
    if isinstance(like, dict):
        if sorted(host) != sorted(like):
            raise ValueError(f"checkpoint keys {sorted(host)} != "
                             f"{sorted(like)}")
        return {k: _to_tree(host[k], like[k]) for k in like}
    if isinstance(like, list):
        return [_to_tree(_layer(host, i, len(like)), layer)
                for i, layer in enumerate(like)]
    return tensor_from_numpy(host, like.device)


class Checkpointer:
    def __init__(self, directory: str, keep_last: int = 3):
        self.dir = pathlib.Path(directory)
        self.dir.mkdir(parents=True, exist_ok=True)
        self.keep_last = keep_last

    # ------------------------------------------------------------------
    def save(self, step: int, state, metadata: Optional[Dict] = None):
        """Atomic snapshot of a state tree at ``step``."""
        host = params_to_numpy(state)
        leaves = list(_flatten(host))
        manifest = {
            "step": step,
            "time": None,
            "treedef": f"PyTreeDef({_treedef(host)})",
            "leaves": [{"key": k, "shape": list(a.shape),
                        "dtype": ("bfloat16" if a.dtype == BF16_BITS
                                  else str(a.dtype))}
                       for k, a in leaves],
            "metadata": metadata or {},
        }
        tmp = self.dir / f".tmp_step_{step}"
        if tmp.exists():
            shutil.rmtree(tmp)
        tmp.mkdir(parents=True)
        for i, (_, a) in enumerate(leaves):
            np.save(tmp / f"leaf_{i}.npy", a)
        manifest["time"] = os.stat(tmp).st_mtime
        (tmp / "manifest.json").write_text(json.dumps(manifest))
        final = self.dir / f"step_{step:010d}"
        if final.exists():
            shutil.rmtree(final)
        os.rename(tmp, final)               # atomic publish
        self._gc()

    def _gc(self):
        steps = self.all_steps()
        for s in steps[:-self.keep_last]:
            shutil.rmtree(self.dir / f"step_{s:010d}", ignore_errors=True)

    # ------------------------------------------------------------------
    def all_steps(self) -> List[int]:
        out = []
        for p in self.dir.glob("step_*"):
            try:
                out.append(int(p.name.split("_")[1]))
            except (IndexError, ValueError):
                continue
        return sorted(out)

    def latest_step(self) -> Optional[int]:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def restore(self, step: int, like=None):
        """Load the tree at ``step``; ``like`` supplies the structure and
        each leaf's device.  Without ``like``: the list of numpy leaves
        (bfloat16 as ``V2`` bits) and the manifest."""
        d = self.dir / f"step_{step:010d}"
        manifest = json.loads((d / "manifest.json").read_text())
        leaves = [np.load(d / f"leaf_{i}.npy")
                  for i in range(len(manifest["leaves"]))]
        if like is None:
            return leaves, manifest
        keys = [leaf["key"] for leaf in manifest["leaves"]]
        return _to_tree(_unflatten(keys, leaves), like), manifest

    def restore_latest(self, like=None):
        step = self.latest_step()
        if step is None:
            return None, None
        return self.restore(step, like=like)
