"""One train step on the card against the same step on the CPU.

``card_step_matches_cpu`` is the one home of that check: ``chip_smoke.py``
(its parity phase) and ``tests/test_torch_gpu.py`` both call it.
"""
from __future__ import annotations

from typing import Dict, Tuple

import torch

from repro_torch.data import SyntheticLMStream
from repro_torch.kernels.flash_attention import kernel as fa_kernel
from repro_torch.models.model import LM
from repro_torch.optim import AdamWConfig
from repro_torch.train.step import init_train_state, make_train_step
from repro_torch.tree import tree_map

METRICS = ("loss", "grad_norm")


def card_step_matches_cpu(cfg, params, *, batch: int, seq: int,
                          rtol: float = 1e-4, lr: float = 1e-3
                          ) -> Tuple[Dict[str, Dict[str, float]], int]:
    """One train step of ``cfg`` from copies of the CPU ``params`` on the
    synthetic stream's step-0 batch (``batch`` x ``seq``), first on the
    card, then on the CPU, with TF32 matmuls off for the step.

    Returns ``(metrics, launches)``: loss and grad norm per device type
    (``"cuda"``, ``"cpu"``) as floats, and the flash kernel's launches in
    the card's step.  Raises ``RuntimeError`` unless each metric agrees
    within ``rtol`` relative and, under ``attention_impl="pallas"``, the
    kernel launched once per forward of each layer (twice under
    ``remat="full"``)."""
    opt = AdamWConfig(lr=lr)
    tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    got: Dict[str, Dict[str, float]] = {}
    before = fa_kernel.flash_fwd.launches
    try:
        for dev in ("cuda", "cpu"):
            model = LM(cfg, device=dev)
            state = init_train_state(
                model, None, opt,
                params=tree_map(lambda t: t.to(model.device, copy=True),
                                params))
            data = SyntheticLMStream(cfg, batch, seq, device=model.device)
            _, metrics = make_train_step(model, opt)(state,
                                                     data.batch_for_step(0))
            got[dev] = {k: float(metrics[k]) for k in METRICS}
    finally:
        torch.backends.cuda.matmul.allow_tf32 = tf32
    launches = fa_kernel.flash_fwd.launches - before
    want = 0
    if cfg.attention_impl == "pallas":
        want = cfg.n_layers * (2 if cfg.remat == "full" else 1)
    if launches != want or not all(
            abs(got["cuda"][k] - got["cpu"][k]) <= rtol * abs(got["cpu"][k])
            for k in METRICS):
        raise RuntimeError(f"train step card vs CPU past rtol {rtol}: {got}; "
                           f"flash launches {launches}, expected {want}")
    return got, launches
