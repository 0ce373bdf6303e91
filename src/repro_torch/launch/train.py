"""Training launcher, counterpart of ``repro.launch.train``.

  PYTHONPATH=src python -m repro_torch.launch.train --arch qwen3-1.7b \\
      --steps 6                       # full width, on the card

  PYTHONPATH=src python -m repro_torch.launch.train --arch qwen3-1.7b \\
      --reduced --device cpu --steps 4 --batch 2 --seq 32

Every family trains: the vlm and audio on the stream's image embeddings
and audio frames; a mamba layer's scan runs in the SSD kernel on the
card, its gradient the plain scan's.  The flags are the JAX launcher's,
and ``--device`` (``cuda`` unless it names another).  ``run(cfg, ...)``
is what ``main()`` calls; it takes a config, so a caller can pick
``attention_impl="pallas"`` (the CUDA flash kernel) with
``get_config(arch, attention_impl="pallas")``.  ``--mesh`` raises
``NotImplementedError`` (ROADMAP A10).  Checkpoints go to
``checkpoints/launch_train`` under the repository root unless
``--ckpt-dir`` names another directory.
"""
from __future__ import annotations

import argparse
from typing import Any, Dict, Optional

import torch

from repro_torch.configs import ARCH_IDS, get_config, reduced_config
from repro_torch.configs.base import ModelConfig
from repro_torch.data import SyntheticLMStream
from repro_torch.kernels.common import REPO_ROOT
from repro_torch.models.model import build_model
from repro_torch.optim import AdamWConfig, warmup_cosine
from repro_torch.train import init_train_state, make_train_step
from repro_torch.train.trainer import Trainer, TrainerConfig

DEFAULT_CKPT_DIR = str(REPO_ROOT / "checkpoints" / "launch_train")


def run(cfg: ModelConfig, *, steps: int = 50, batch: int = 8,
        seq: int = 128, lr: float = 3e-4, microbatches: int = 1,
        ckpt_dir: Optional[str] = DEFAULT_CKPT_DIR,
        checkpoint_every: Optional[int] = None,
        device=None) -> Dict[str, Any]:
    """Train ``cfg`` on the synthetic stream with AdamW and warmup-cosine
    (10 warmup steps over ``steps``), auto-resuming from ``ckpt_dir``
    (``None``: no checkpoints; ``checkpoint_every`` defaults to half the
    steps).  Params come from a generator seeded with 0 on the model's
    device.  Returns the trainer's ``{"state", "log", "stragglers"}``."""
    model = build_model(cfg, device=device)
    opt = AdamWConfig(lr=warmup_cosine(lr, 10, steps))
    step_fn = make_train_step(model, opt, microbatches=microbatches)
    stream = SyntheticLMStream(cfg, batch, seq, device=model.device)

    def init_state():
        gen = torch.Generator(device=model.device).manual_seed(0)
        return init_train_state(model, gen, opt)

    trainer = Trainer(step_fn, init_state, stream, ckpt_dir, TrainerConfig(
        total_steps=steps,
        checkpoint_every=checkpoint_every or max(steps // 2, 1)))
    return trainer.run()


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen3-1.7b", choices=ARCH_IDS)
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--reduced", action="store_true",
                    help="reduced config (CPU-sized)")
    ap.add_argument("--mesh", default=None,
                    help="DxM mesh (not ported: raises)")
    ap.add_argument("--device", default=None,
                    help="torch device (default cuda)")
    ap.add_argument("--ckpt-dir", default=DEFAULT_CKPT_DIR)
    args = ap.parse_args(argv)
    if args.mesh:
        raise NotImplementedError("--mesh is not ported yet (ROADMAP A10)")
    cfg = (reduced_config(args.arch) if args.reduced
           else get_config(args.arch))
    out = run(cfg, steps=args.steps, batch=args.batch, seq=args.seq,
              lr=args.lr, microbatches=args.microbatches,
              ckpt_dir=args.ckpt_dir, device=args.device)
    losses = [r["loss"] for r in out["log"]]
    if not losses:
        print(f"[train] {args.arch}: the checkpoint in {args.ckpt_dir} is "
              f"already at step {args.steps}; nothing to do")
        return out
    print(f"[train] {args.arch}: loss {losses[0]:.4f} -> {losses[-1]:.4f} "
          f"over {len(losses)} steps; stragglers={len(out['stragglers'])}")
    return out


if __name__ == "__main__":
    main()
