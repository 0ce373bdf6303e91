"""Deterministic synthetic token pipeline, a copy of
``repro.data.pipeline``.

Data for step k is a pure function of (seed, step, arch): numpy Philox
keyed on (seed, step), so the batches are bitwise those of the reference
stream, and a run resumed from a checkpoint continues the stream
exactly.  The batches come back as torch tensors on the stream's device.
Every family gets the plain batches, as in the reference; the vlm /
audio extras (image embeddings, audio frames) are not ported yet (their
training is ROADMAP A9's), and those families raise.
"""
from __future__ import annotations

import dataclasses
from typing import Dict

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels.common import resolve_device


@dataclasses.dataclass
class DataConfig:
    seed: int = 1234
    doc_len_mean: int = 512        # synthetic document packing
    mask_pad: bool = True


class SyntheticLMStream:
    """Packed-LM batches: tokens, shifted labels, positions, loss mask."""

    def __init__(self, cfg: ModelConfig, batch: int, seq_len: int,
                 data_cfg: DataConfig = DataConfig(), device=None):
        if cfg.family in ("vlm", "audio"):
            raise NotImplementedError(
                f"family {cfg.family!r}: the port's stream has no "
                f"vlm / audio extras yet (ROADMAP A9: vlm and audio "
                f"training)")
        self.cfg = cfg
        self.batch = batch
        self.seq_len = seq_len
        self.data_cfg = data_cfg
        self.device = resolve_device(device)

    def numpy_batch(self, step: int) -> Dict[str, np.ndarray]:
        rng = np.random.Generator(np.random.Philox(
            key=[self.data_cfg.seed, step]))
        B, S = self.batch, self.seq_len
        # zipf-ish marginal over the vocab (realistic unigram skew)
        z = rng.zipf(1.3, size=(B, S + 1)).astype(np.int64)
        tokens = (z % (self.cfg.vocab_size - 2)) + 1
        # synthetic doc boundaries -> positions reset, loss masked at pad
        doc_break = rng.random((B, S + 1)) < 1.0 / self.data_cfg.doc_len_mean
        doc_break[:, 0] = False
        tokens[doc_break] = 0                      # BOS/pad id 0
        inputs = tokens[:, :-1].astype(np.int32)
        labels = tokens[:, 1:].astype(np.int32)
        positions = np.arange(S, dtype=np.int32)[None].repeat(B, 0)
        mask = np.ones((B, S), np.float32)
        if self.data_cfg.mask_pad:
            mask[labels == 0] = 0.0
        return {"tokens": inputs, "labels": labels, "positions": positions,
                "loss_mask": mask}

    def batch_for_step(self, step: int) -> Dict[str, torch.Tensor]:
        return {k: torch.from_numpy(a).to(self.device)
                for k, a in self.numpy_batch(step).items()}
