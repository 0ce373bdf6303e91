"""Elastic restore: move a checkpoint onto a mesh of another shape.

Counterpart of ``repro.checkpoint.elastic``.  Checkpoints store whole
arrays (the reference's format: one ``.npy`` a leaf and a manifest), so
resharding is a matter of each rank reading its blocks: the leaves are
memory-mapped and only this rank's block of each (``parallel.axes.
local_slice`` under the spec resolved from the same logical-axis specs
the serving engine uses) is read and copied to the device.  This is the
restart path when the fleet grows or shrinks.
"""
from __future__ import annotations

import json
from typing import Any, Dict, Optional, Tuple

import numpy as np

from repro_torch.checkpoint.checkpointer import Checkpointer, _unflatten
from repro_torch.parallel.axes import Rules
from repro_torch.weights import params_from_numpy


def restore_resharded(ckpt: Checkpointer, step: int, spec_tree, mesh,
                      rules: Optional[Rules] = None, *, device=None,
                      subtree: Optional[str] = None
                      ) -> Tuple[Dict[str, Any], Dict[str, Any]]:
    """Restore the parameter tree saved at ``step`` as this rank's blocks.

    ``spec_tree``: the port's spec tree of the saved parameters
    (``LM.layout_specs``); ``mesh``: a ``launch.mesh.Mesh`` (only its
    shape and this rank's coordinates are read); ``subtree``: the key of
    the parameters inside a larger saved tree (``"params"`` of a train
    state), whose other leaves are not read.  Returns (params on
    ``device``, by default the mesh's, and the manifest)."""
    d = ckpt.dir / f"step_{step:010d}"
    manifest = json.loads((d / "manifest.json").read_text())
    keys, leaves = [], []
    for i, leaf in enumerate(manifest["leaves"]):
        key = leaf["key"]
        if subtree is not None:
            if not key.startswith(subtree + "/"):
                continue
            key = key[len(subtree) + 1:]
        keys.append(key)
        leaves.append(np.load(d / f"leaf_{i}.npy", mmap_mode="r"))
    host = _unflatten(keys, leaves)
    device = mesh.device if device is None else device
    return (params_from_numpy(host, device, shard=(spec_tree, mesh, rules)),
            manifest)
