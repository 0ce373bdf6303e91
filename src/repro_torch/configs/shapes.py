"""A (batch, sequence, kind) cell the cost model prices: a copy of
``repro.configs.shapes.ShapeSpec``.

The reference's suite of TPU dry-run shapes (``SHAPES``) is not copied:
it sizes a many-chip mesh, which means nothing on one card.
"""
from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class ShapeSpec:
    name: str
    seq_len: int
    global_batch: int
    kind: str  # train | prefill | decode
