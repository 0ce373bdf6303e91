"""Fault-tolerant training loop, counterpart of ``repro.train.trainer``.

  * auto-resume: on start, restore the latest checkpoint if one exists;
    the synthetic data stream is a pure function of step, so a killed and
    resumed run ends bit-identical to an uninterrupted one.
  * periodic + final atomic checkpoints.
  * straggler watchdog: per-step time EWMA; a step slower than
    ``STRAGGLER_FACTOR`` x the EWMA is recorded.  Step times are CUDA-event
    times on the card; on the CPU a step records no time (``seconds`` is
    None) and the watchdog has nothing to watch.
  * optional simulated failure for the restart test (``fail_at_step``).

``ckpt_dir=None`` runs without checkpoints (no resume, no saves).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, List, Optional

import torch

from repro_torch.checkpoint import Checkpointer
from repro_torch.data import SyntheticLMStream

STRAGGLER_FACTOR = 3.0      # a step this many times the EWMA is a straggler
EWMA_ALPHA = 0.3


class SimulatedFailure(RuntimeError):
    pass


@dataclasses.dataclass
class TrainerConfig:
    total_steps: int = 100
    checkpoint_every: int = 20
    fail_at_step: Optional[int] = None      # simulate a node failure


class Trainer:
    def __init__(self, train_step: Callable, init_state_fn: Callable,
                 stream: SyntheticLMStream, ckpt_dir: Optional[str],
                 tcfg: TrainerConfig = TrainerConfig()):
        self.train_step = train_step
        self.init_state_fn = init_state_fn
        self.stream = stream
        self.tcfg = tcfg
        self.ckpt = None if ckpt_dir is None else Checkpointer(ckpt_dir)
        self.metrics_log: List[Dict] = []
        self.straggler_events: List[Dict] = []

    def _step(self, state, batch):
        """One train step; its CUDA-event seconds on the card, else None."""
        if self.stream.device.type != "cuda":
            state, metrics = self.train_step(state, batch)
            return state, metrics, None
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        state, metrics = self.train_step(state, batch)
        end.record()
        end.synchronize()
        return state, metrics, start.elapsed_time(end) / 1e3

    def run(self) -> Dict[str, Any]:
        state = self.init_state_fn()
        start = 0
        latest = None if self.ckpt is None else self.ckpt.latest_step()
        if latest is not None:
            state, manifest = self.ckpt.restore(latest, like=state)
            start = int(manifest["step"])
        ewma = None
        for step in range(start, self.tcfg.total_steps):
            if self.tcfg.fail_at_step is not None and \
                    step == self.tcfg.fail_at_step:
                raise SimulatedFailure(f"injected failure at step {step}")
            batch = self.stream.batch_for_step(step)
            state, metrics, dt = self._step(state, batch)
            if dt is not None:
                if ewma is None:
                    ewma = dt
                elif dt > STRAGGLER_FACTOR * ewma:
                    self.straggler_events.append(
                        {"step": step, "seconds": dt, "ewma": ewma})
                ewma = (1 - EWMA_ALPHA) * ewma + EWMA_ALPHA * dt
            rec = {"step": step, "seconds": dt,
                   **{k: float(v) for k, v in metrics.items()}}
            self.metrics_log.append(rec)
            done = step + 1
            if self.ckpt is not None and (
                    done % self.tcfg.checkpoint_every == 0
                    or done == self.tcfg.total_steps):
                self.ckpt.save(done, state, metadata={"loss": rec["loss"]})
        return {"state": state, "log": self.metrics_log,
                "stragglers": self.straggler_events}
