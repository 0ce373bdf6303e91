"""The train step: loss -> grad -> (optional microbatch accumulation,
optional int8-EF gradient compression) -> AdamW update.

Counterpart of ``repro.train.step``.  ``state`` is a plain dict:
``{"params", "opt": {m, v, count}, "step", ["grad_err"]}``.  The
gradient is ``torch.autograd`` where the reference takes
``jax.value_and_grad``; the params, the moments and the error-feedback
residual are updated in place (``optim.adamw``, ``optim.compression``).
A batch's ``image_embeds`` / ``audio_frames`` reach the forward as its
``extra``.  Not ported: the sharding specs (``train_state_specs``,
``batch_specs``: ROADMAP A10); they raise ``NotImplementedError``.
"""
from __future__ import annotations

from typing import Any, Callable, Dict, Optional

import torch

from repro_torch.models.model import LM
from repro_torch.optim import AdamWConfig, adamw_update, init_opt_state
from repro_torch.optim import compression as comp
from repro_torch.train import losses
from repro_torch.tree import tree_leaves, tree_map


def _not_ported(what: str, item: str):
    return NotImplementedError(f"{what} is not ported yet (ROADMAP {item})")


EXTRA_KEYS = ("image_embeds", "audio_frames")


def make_loss_fn(model: LM, *, z_loss: float = 0.0,
                 fused_xent: bool = False) -> Callable:
    """``loss_fn(params, batch) -> (loss, metrics)``.  ``fused_xent``: the
    loss is ``losses.fused_cross_entropy`` over the final hidden states
    (no logits, no ``z_loss``, no accuracy), as in the reference."""
    cfg = model.cfg

    def loss_fn(params, batch):
        extra = {k: batch[k] for k in EXTRA_KEYS if k in batch}
        if fused_xent:
            x, aux = _backbone_hidden(model, params, batch, extra)
            emb = params["embed"] if cfg.tie_embeddings else params["unembed"]
            loss, metrics = losses.fused_cross_entropy(
                x, emb["table"], batch["labels"], cfg.vocab_size,
                mask=batch.get("loss_mask"))
        else:
            logits, _, aux = model.forward(
                params, batch["tokens"], batch["positions"], mode="train",
                extra=extra)
            loss, metrics = losses.cross_entropy(
                logits, batch["labels"], cfg.vocab_size,
                mask=batch.get("loss_mask"), z_loss=z_loss)
        if cfg.moe is not None:
            loss = loss + cfg.moe.aux_loss_weight * aux
            metrics["moe_aux"] = aux
        metrics["loss"] = loss
        return loss, metrics

    return loss_fn


def _backbone_hidden(model: LM, params, batch, extra):
    """The forward up to the final hidden states (for fused xent); the
    vlm's context is its image embeddings.  The enc-dec raises, as in
    the reference."""
    if model.cfg.family == "audio":
        raise NotImplementedError("fused xent for enc-dec not wired")
    return model.hidden_train(params, batch["tokens"], batch["positions"],
                              extra)


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
    ``weights.params_from_numpy``).  ``grad_compression="int8_ef"`` adds
    the zero fp32 residual ``grad_err``."""
    if params is None:
        params = model.init_params(generator)
    state = {
        "params": params,
        "opt": init_opt_state(params),
        "step": torch.zeros((), dtype=torch.int32, device=model.device),
    }
    if grad_compression == "int8_ef":
        state["grad_err"] = comp.init_error_state(params)
    return state


def train_state_specs(model: LM, grad_compression: Optional[str] = None):
    raise _not_ported("sharding specs", "A10")


def batch_specs(cfg, kind: str = "train"):
    raise _not_ported("sharding specs", "A10")


def make_train_step(model: LM, opt_cfg: AdamWConfig, *,
                    microbatches: int = 1,
                    grad_compression: Optional[str] = None,
                    z_loss: float = 0.0,
                    fused_xent: bool = False) -> Callable:
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
        new_state = dict(state)
        if grad_compression == "int8_ef":
            grads, new_state["grad_err"] = comp.ef_compress_tree(
                grads, state["grad_err"])
        new_params, new_opt, opt_metrics = adamw_update(
            grads, state["opt"], params, opt_cfg)
        metrics.update(opt_metrics)
        new_state.update(params=new_params, opt=new_opt,
                         step=state["step"] + 1)
        return new_state, metrics

    return train_step
