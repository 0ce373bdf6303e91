"""AdamW with decoupled weight decay and global-norm clipping.

Counterpart of ``repro.optim.adamw``: moments in fp32 whatever the param
dtype, the update computed in fp32 and cast back, bias correction and
the schedule evaluated in fp32 on the step count.  Unlike the reference's
pure function, ``adamw_update`` updates the params and the moments in
place — no second copy of the model and of its fp32 moments at full
width — and returns the same objects.

Weight decay follows the reference's rule ``p.ndim >= 2`` on the
reference's tree: there every leaf of the layer stack carries a leading
layer axis, so all of them — norm scales included — are decayed, while a
top-level 1-D leaf (``final_norm.scale``) is not.  The port's per-layer
leaves are one rank lower, so the rule is applied to the rank they have
in the reference's tree.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, Tuple, Union

import torch

from repro_torch.tree import tree_leaves, tree_map


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: Union[Callable[[torch.Tensor], torch.Tensor], float] = 1e-3
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip_norm: float = 1.0


def init_opt_state(params) -> Dict[str, Any]:
    zeros = lambda p: torch.zeros(p.shape, dtype=torch.float32,  # noqa: E731
                                  device=p.device)
    leaf = tree_leaves(params)[0]
    return {
        "m": tree_map(zeros, params),
        "v": tree_map(zeros, params),
        "count": torch.zeros((), dtype=torch.int32, device=leaf.device),
    }


def global_norm(tree) -> torch.Tensor:
    return torch.sqrt(sum(torch.sum(torch.square(t.float()))
                          for t in tree_leaves(tree)))


def decay_mask(params) -> Dict[str, Any]:
    """True where the reference's leaf has rank >= 2: every layer leaf,
    and the top-level matrices."""
    return {k: (tree_map(lambda p: True, v) if k == "stack"
                else tree_map(lambda p: p.dim() >= 2, v))
            for k, v in params.items()}


def adamw_update(grads, opt_state, params, cfg: AdamWConfig
                 ) -> Tuple[Any, Dict[str, Any], Dict[str, torch.Tensor]]:
    """One AdamW step on ``params`` (updated in place) from ``grads``;
    returns (params, opt_state, {"grad_norm", "lr"})."""
    count = opt_state["count"] + 1
    gnorm = global_norm(grads)
    f32 = dict(dtype=torch.float32, device=gnorm.device)
    if cfg.grad_clip_norm > 0:
        scale = torch.clamp(cfg.grad_clip_norm / gnorm.clamp_min(1e-9),
                            max=1.0)
    else:
        scale = torch.ones((), **f32)
    lr = cfg.lr(count) if callable(cfg.lr) else torch.tensor(cfg.lr, **f32)
    cf = count.to(torch.float32)
    bc1 = 1 - torch.tensor(cfg.b1, **f32) ** cf
    bc2 = 1 - torch.tensor(cfg.b2, **f32) ** cf

    def upd(g, m, v, p, decay):
        g = g.float() * scale
        m.mul_(cfg.b1).add_((1 - cfg.b1) * g)
        v.mul_(cfg.b2).add_((1 - cfg.b2) * torch.square(g))
        step = (m / bc1) / (torch.sqrt(v / bc2) + cfg.eps)
        pf = p.float()
        if cfg.weight_decay > 0 and decay:
            step = step + cfg.weight_decay * pf
        p.copy_(pf - lr * step)

    with torch.no_grad():
        tree_map(upd, grads, opt_state["m"], opt_state["v"], params,
                 decay_mask(params))
    new_state = {"m": opt_state["m"], "v": opt_state["v"], "count": count}
    return params, new_state, {"grad_norm": gnorm, "lr": lr}
