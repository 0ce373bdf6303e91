"""Train-step builder: loss -> grad -> (optional microbatch accumulation)
-> AdamW update.

Counterpart of ``repro.train.step``.  ``state`` is a plain dict:
``{"params", "opt": {m, v, count}, "step"}``.  The gradient is
``torch.autograd`` where the reference takes ``jax.value_and_grad``; the
params and moments are updated in place (``optim.adamw``).  Not ported:
the sharding specs (``train_state_specs``, ``batch_specs``: ROADMAP A10),
``fused_xent`` and ``grad_compression="int8_ef"`` (ROADMAP A9); they
raise ``NotImplementedError``.
"""
from __future__ import annotations

from typing import Any, Callable, Dict, Optional

import torch

from repro_torch.models.model import LM
from repro_torch.optim import AdamWConfig, adamw_update, init_opt_state
from repro_torch.train import losses
from repro_torch.tree import tree_leaves, tree_map


def _not_ported(what: str, item: str):
    return NotImplementedError(f"{what} is not ported yet (ROADMAP {item})")


def make_loss_fn(model: LM, *, z_loss: float = 0.0,
                 fused_xent: bool = False) -> Callable:
    if fused_xent:
        raise _not_ported("fused_xent", "A9")
    cfg = model.cfg

    def loss_fn(params, batch):
        logits, _, aux = model.forward(params, batch["tokens"],
                                       batch["positions"], mode="train")
        loss, metrics = losses.cross_entropy(
            logits, batch["labels"], cfg.vocab_size,
            mask=batch.get("loss_mask"), z_loss=z_loss)
        if cfg.moe is not None:
            loss = loss + cfg.moe.aux_loss_weight * aux
            metrics["moe_aux"] = aux
        metrics["loss"] = loss
        return loss, metrics

    return loss_fn


def value_and_grad(loss_fn: Callable) -> Callable:
    """``jax.value_and_grad(loss_fn, has_aux=True)`` for the port's trees:
    returns ``fn(params, batch) -> ((loss, metrics), grads)`` with grads
    in the params' structure and dtypes; the params are not touched."""
    def fn(params, batch):
        live = tree_map(lambda p: p.detach().requires_grad_(True), params)
        with torch.enable_grad():
            loss, metrics = loss_fn(live, batch)
        grads = iter(torch.autograd.grad(loss, tree_leaves(live)))
        metrics = {k: v.detach() for k, v in metrics.items()}
        return (loss.detach(), metrics), tree_map(lambda _: next(grads),
                                                  params)
    return fn


def init_train_state(model: LM, generator: Optional[torch.Generator],
                     opt_cfg: AdamWConfig,
                     grad_compression: Optional[str] = None, *,
                     params=None) -> Dict[str, Any]:
    """Fresh state from ``model.init_params(generator)``, or around the
    given ``params`` (e.g. the reference's, through
    ``weights.params_from_numpy``)."""
    if grad_compression is not None:
        raise _not_ported(f"grad_compression={grad_compression!r}", "A9")
    if params is None:
        params = model.init_params(generator)
    return {
        "params": params,
        "opt": init_opt_state(params),
        "step": torch.zeros((), dtype=torch.int32, device=model.device),
    }


def train_state_specs(model: LM, grad_compression: Optional[str] = None):
    raise _not_ported("sharding specs", "A10")


def batch_specs(cfg, kind: str = "train"):
    raise _not_ported("sharding specs", "A10")


def make_train_step(model: LM, opt_cfg: AdamWConfig, *,
                    microbatches: int = 1,
                    grad_compression: Optional[str] = None,
                    z_loss: float = 0.0,
                    fused_xent: bool = False) -> Callable:
    if grad_compression is not None:
        raise _not_ported(f"grad_compression={grad_compression!r}", "A9")
    grad_fn = value_and_grad(make_loss_fn(model, z_loss=z_loss,
                                          fused_xent=fused_xent))

    def train_step(state, batch):
        params = state["params"]
        if microbatches > 1:
            def split(x):
                b = x.shape[0]
                return x.reshape(microbatches, b // microbatches,
                                 *x.shape[1:])

            mb = {k: split(v) for k, v in batch.items()}
            grads = tree_map(lambda p: torch.zeros(
                p.shape, dtype=torch.float32, device=p.device), params)
            loss_sum = torch.zeros((), dtype=torch.float32,
                                   device=state["step"].device)
            for i in range(microbatches):
                (loss, metrics), g = grad_fn(
                    params, {k: v[i] for k, v in mb.items()})
                tree_map(lambda acc, gi: acc.add_(gi), grads, g)
                loss_sum = loss_sum + loss
            grads = tree_map(lambda g: g / microbatches, grads)
            metrics["loss"] = loss_sum / microbatches
        else:
            (_, metrics), grads = grad_fn(params, batch)
        new_params, new_opt, opt_metrics = adamw_update(
            grads, state["opt"], params, opt_cfg)
        metrics.update(opt_metrics)
        new_state = dict(state, params=new_params, opt=new_opt,
                         step=state["step"] + 1)
        return new_state, metrics

    return train_step
