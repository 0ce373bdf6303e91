"""End-to-end example: train a ~100M-parameter dense LM with the port's
whole train stack: the train step, the fault-tolerant trainer
(checkpoints, auto-resume, the straggler watchdog), the synthetic data
stream, the warmup-cosine schedule, and the metrics log.  The
counterpart of ``examples/train_100m.py``.

    python -m repro_torch.examples.train_100m --steps 300
    python -m repro_torch.examples.train_100m --device cpu --steps 2

The model is the reference's scaled-down qwen3-family config (12 layers
x d512, GQA 8/4, 50k vocab, fp32: ~100M params).  The device is
``cuda`` unless ``--device`` names another.  Checkpoints and ``metrics.json`` go to
``checkpoints/train_100m`` under the repository root unless
``--ckpt-dir`` names another directory; a run there resumes from its
latest checkpoint.
"""
import argparse
import json
import pathlib

import torch

from repro_torch.configs import get_config
from repro_torch.data import SyntheticLMStream
from repro_torch.kernels.common import REPO_ROOT
from repro_torch.models.model import build_model
from repro_torch.optim import AdamWConfig, warmup_cosine
from repro_torch.train import init_train_state, make_train_step
from repro_torch.train.trainer import Trainer, TrainerConfig


def config():
    """The ~100M qwen3-family config: 12 layers x d512 (GQA 8/4) + 50k
    vocab."""
    return get_config(
        "qwen3-1.7b",
        n_layers=12, d_model=512, n_heads=8, n_kv_heads=4, head_dim=64,
        d_ff=2048, vocab_size=50_304, param_dtype="float32",
        compute_dtype="float32", remat="none")


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=256)
    ap.add_argument("--ckpt-dir",
                    default=str(REPO_ROOT / "checkpoints" / "train_100m"))
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--device", default=None,
                    help="torch device (default cuda)")
    args = ap.parse_args(argv)

    cfg = config()
    total, _ = cfg.param_counts()
    print(f"training {total / 1e6:.1f}M-param {cfg.arch_id}-family model "
          f"for {args.steps} steps")

    model = build_model(cfg, device=args.device)
    opt = AdamWConfig(
        lr=warmup_cosine(3e-4, warmup_steps=50, total_steps=args.steps),
        weight_decay=0.1, grad_clip_norm=1.0)
    step = make_train_step(model, opt, microbatches=args.microbatches)
    stream = SyntheticLMStream(cfg, args.batch, args.seq,
                               device=model.device)

    def init_state():
        gen = torch.Generator(device=model.device).manual_seed(0)
        return init_train_state(model, gen, opt)

    trainer = Trainer(step, init_state, stream, args.ckpt_dir,
                      TrainerConfig(total_steps=args.steps,
                                    checkpoint_every=50))
    out = trainer.run()
    losses = [r["loss"] for r in out["log"]]
    if losses:
        print(f"loss: first10={sum(losses[:10]) / len(losses[:10]):.4f} "
              f"last10={sum(losses[-10:]) / len(losses[-10:]):.4f}")
    print(f"stragglers flagged: {len(out['stragglers'])}")
    log_path = pathlib.Path(args.ckpt_dir) / "metrics.json"
    log_path.write_text(json.dumps(out["log"]))
    print(f"metrics -> {log_path}")
    return out


if __name__ == "__main__":
    main()
