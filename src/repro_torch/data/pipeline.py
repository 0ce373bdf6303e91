"""Deterministic synthetic token pipeline, a copy of
``repro.data.pipeline``.

Data for step k is a pure function of (seed, step, arch): numpy Philox
keyed on (seed, step), so the batches are bitwise those of the reference
stream, and a run resumed from a checkpoint continues the stream
exactly.  The batches come back as torch tensors on the stream's device.
Every family gets the plain batches; the vlm's also carry
``image_embeds`` (B, num_image_tokens, d) and the audio's
``audio_frames`` (B, n_audio_ctx, d), fp32, drawn from the same
generator after the loss mask, as in the reference.
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
        out = {"tokens": inputs, "labels": labels, "positions": positions,
               "loss_mask": mask}
        extra = {"vlm": ("image_embeds", self.cfg.num_image_tokens),
                 "audio": ("audio_frames", self.cfg.n_audio_ctx)}
        if self.cfg.family in extra:
            key, n = extra[self.cfg.family]
            emb = rng.standard_normal((B, n, self.cfg.d_model)) * 0.02
            out[key] = emb.astype(np.float32)
        return out

    def batch_for_step(self, step: int) -> Dict[str, torch.Tensor]:
        return {k: torch.from_numpy(a).to(self.device)
                for k, a in self.numpy_batch(step).items()}
