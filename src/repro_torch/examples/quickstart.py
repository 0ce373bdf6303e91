"""Quickstart: build an architecture at its reduced config, take a few
train steps, and serve a batch through the continuous-batching engine.
The counterpart of ``examples/quickstart.py``.

    python -m repro_torch.examples.quickstart --arch qwen3-1.7b
    python -m repro_torch.examples.quickstart --device cpu

On the card the reduced config takes head_dim 64 (the paged kernel takes
64 or 128).  The cross-attention families (vlm, audio) do not train in
the port yet (ROADMAP A9): for them the example serves only.
"""
import argparse

import numpy as np
import torch

from repro_torch.configs import ARCH_IDS, reduced_config
from repro_torch.data import SyntheticLMStream
from repro_torch.kernels.common import resolve_device
from repro_torch.models.decode_state import stub_context
from repro_torch.models.model import LM
from repro_torch.optim import AdamWConfig
from repro_torch.serve import ContinuousBatchingEngine
from repro_torch.train import init_train_state, make_train_step


def example_config(arch: str, device: torch.device):
    """The reduced config, at head_dim 64 on the card."""
    return (reduced_config(arch, head_dim=64) if device.type == "cuda"
            else reduced_config(arch))


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", default="qwen3-1.7b", choices=ARCH_IDS)
    ap.add_argument("--device", default=None)
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    cfg = example_config(args.arch, dev)
    model = LM(cfg, device=dev)
    print(f"arch={cfg.arch_id} family={cfg.family} on {dev} "
          f"(reduced: d_model={cfg.d_model}, layers={cfg.n_layers})")
    total, active = cfg.param_counts()
    print(f"reduced params ~{total / 1e6:.2f}M (active {active / 1e6:.2f}M)")

    opt = AdamWConfig(lr=1e-3)
    state = init_train_state(
        model, torch.Generator(device=dev).manual_seed(0), opt)
    losses = []
    if cfg.family in ("vlm", "audio"):
        print(f"train: family {cfg.family!r} does not train in the port "
              f"yet (ROADMAP A9)")
    else:
        step = make_train_step(model, opt)
        stream = SyntheticLMStream(cfg, batch=2, seq_len=32, device=dev)
        for i in range(3):
            state, metrics = step(state, stream.batch_for_step(i))
            losses.append(float(metrics["loss"]))
            print(f"step {i}: loss={losses[-1]:.4f} "
                  f"grad_norm={float(metrics['grad_norm']):.3f}")

    # prefill + a few greedy decode steps through the continuous engine;
    # the cross-context families bring their stub frontend context
    rng = np.random.default_rng(0)
    prompt = rng.integers(1, cfg.vocab_size, size=(2, 16))
    extra = stub_context(cfg, rng, batch=2)
    engine = ContinuousBatchingEngine(model, state["params"], n_slots=2,
                                      max_len=64, page_size=8)
    tokens = engine.generate(prompt, n_steps=8, extra=extra)
    print("generated:", tokens.tolist())
    return {"losses": losses, "tokens": tokens.cpu().numpy(),
            "paged_meta": engine.paged_meta}


if __name__ == "__main__":
    main()
