"""``matmul_q``: the matmul call site of the Mamba projections.

Counterpart of ``repro.models.quant.matmul_q`` for raw weights only:
``x @ w`` in x's dtype.  An int8 q-pack (``{"q", "scale"}``, the
reference's weight-only quantization) raises ``NotImplementedError``:
int8 serving through the ``wq_gemm`` kernel is ROADMAP B5.
"""
from __future__ import annotations

from typing import Any

import torch


def is_qpack(p: Any) -> bool:
    return isinstance(p, dict) and set(p.keys()) == {"q", "scale"}


def matmul_q(x: torch.Tensor, w: Any) -> torch.Tensor:
    """x @ w for a raw weight tensor (cast to x's dtype)."""
    if is_qpack(w):
        raise NotImplementedError(
            "int8 q-pack weights: weight-only int8 serving through the "
            "wq_gemm kernel is not ported yet (ROADMAP B5)")
    return x @ w.to(x.dtype)
