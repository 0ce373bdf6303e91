"""One train step on the card against the same step on the CPU.

``card_step_matches_cpu`` is the one home of that check: ``chip_smoke.py``
(its parity phase) and ``tests/test_torch_gpu.py`` both call it.
"""
from __future__ import annotations

from typing import Dict, Tuple

import torch

from repro_torch.data import SyntheticLMStream
from repro_torch.kernels.flash_attention import kernel as fa_kernel
from repro_torch.kernels.ssd_scan import kernel as ssd_kernel
from repro_torch.models.model import LM
from repro_torch.optim import AdamWConfig
from repro_torch.train.step import init_train_state, make_train_step
from repro_torch.tree import tree_map

METRICS = ("loss", "grad_norm")
WRAPPERS = {"flash_attention": fa_kernel.flash_fwd,
            "ssd_scan": ssd_kernel.ssd_scan_fwd}


def train_launches(cfg) -> Dict[str, int]:
    """The flash and SSD kernels' launches in one train step of ``cfg`` on
    the card: one a forward of each self-attention layer (the encoder's
    too) under ``attention_impl="pallas"`` and of each mamba layer, twice
    under every remat mode but ``"none"``, whose backward runs the layer's
    (or the block's) forward again.  The vlm's cross layers attend
    through the plain ``chunked_attention``."""
    kinds = [cfg.layer_kind(i) for i in range(cfg.n_layers)]
    cross = (cfg.n_layers // cfg.cross_attn_period
             if cfg.cross_attn_period else 0)
    attn = kinds.count("attn") - cross + cfg.n_encoder_layers
    times = 1 if cfg.remat == "none" else 2
    return {"flash_attention": (attn * times if cfg.attention_impl
                                == "pallas" else 0),
            "ssd_scan": kinds.count("mamba") * times}


def card_step_matches_cpu(cfg, params, *, batch: int, seq: int,
                          rtol: float = 1e-4, lr: float = 1e-3
                          ) -> Tuple[Dict[str, Dict[str, float]],
                                     Dict[str, int]]:
    """One train step of ``cfg`` from copies of the CPU ``params`` on the
    synthetic stream's step-0 batch (``batch`` x ``seq``), first on the
    card, then on the CPU, with TF32 matmuls off for the step.

    Returns ``(metrics, launches)``: loss and grad norm per device type
    (``"cuda"``, ``"cpu"``) as floats, and the flash and SSD kernels'
    launches in the card's step (``{"flash_attention", "ssd_scan"}``).
    Raises ``RuntimeError`` unless each metric agrees within ``rtol``
    relative and the launches are ``train_launches(cfg)``."""
    opt = AdamWConfig(lr=lr)
    tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    got: Dict[str, Dict[str, float]] = {}
    before = {k: w.launches for k, w in WRAPPERS.items()}
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
    launches = {k: w.launches - before[k] for k, w in WRAPPERS.items()}
    want = train_launches(cfg)
    if launches != want or not all(
            abs(got["cuda"][k] - got["cpu"][k]) <= rtol * abs(got["cpu"][k])
            for k in METRICS):
        raise RuntimeError(f"train step card vs CPU past rtol {rtol}: {got}; "
                           f"launches {launches}, expected {want}")
    return got, launches
