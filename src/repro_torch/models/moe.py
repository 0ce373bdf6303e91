"""Top-k MoE with group-local sort-based dispatch: the counterpart of
``repro.models.moe``.

Tokens are grouped by batch row (G = B, Sg = S), so rows never compete
for capacity: a decode step's idle slots cannot change another slot's
output.  Each group sorts its (token, choice) pairs by expert id (a
stable sort: within an expert the earlier token wins), keeps the first
``capacity`` of each expert and drops the rest, runs the expert SwiGLU
and gathers back, weighting each choice by its renormalised top-k gate.

The port scatters every group's kept tokens into one (E, G·C, d) buffer,
expert-major, so each expert's rows are contiguous: bf16/fp32 experts
run as stacked products over it, and an int8 q-pack (E, K, N) as one
int8 GEMM (``kernels.wq_gemm``: the CUDA kernel on the card) an expert
and projection on ``q[e]``, ``scale[e]``.  All E experts are computed,
empty capacity slots included, as the reference's einsum does.

Under a sharding context a rank reads what is split from the shapes of
its expert blocks.  Expert-parallel (``gate`` holds fewer than E
experts, the ``expert`` rule): the routing, the capacity and the sort
stay those of every token, and the rank computes only its experts' rows
of the buffer, so a choice routed to another rank's expert contributes
an exact zero.  Tensor-parallel within an expert (``gate``'s last dim
under ``expert_d_ff``, the ``expert_mlp`` rule): gate and up are
column-parallel, down row-parallel.  Either way ``y`` is summed once a
layer, after the gates are applied, over the split axes (``_combine``):
with top-2 the expert-parallel sum adds only exact zeros to each
token's two contributions.
"""
from __future__ import annotations

import math
from typing import Any, Dict, Tuple

import torch
import torch.nn.functional as F

from repro_torch.kernels.wq_gemm import ops as wq_ops
from repro_torch.models.layers import dtype_of
from repro_torch.models.quant import is_qpack
from repro_torch.parallel import axes as paxes
from repro_torch.parallel import collectives

Params = Dict[str, Any]


def moe_specs(cfg) -> Dict:
    """The reference's logical axes of an MoE layer's parameters."""
    return {
        "router": ("embed", None),
        "gate": ("expert", "embed", "expert_mlp"),
        "up": ("expert", "embed", "expert_mlp"),
        "down": ("expert", "expert_mlp", "embed"),
    }


def init_moe(generator: torch.Generator, cfg, device) -> Params:
    """Router fp32 (d, E), gate/up (E, d, f), down (E, f, d) with the
    reference's scales, drawn from ``generator`` in that order.  The
    router is drawn in the param dtype and kept in fp32, as the
    reference's."""
    m = cfg.moe
    d, f, e = cfg.d_model, m.expert_d_ff, m.num_experts
    dtype = dtype_of(cfg.param_dtype)

    def w(shape, scale):
        return torch.randn(shape, generator=generator, dtype=torch.float32,
                           device=device).mul_(scale).to(dtype)

    scale_in, scale_out = d ** -0.5, f ** -0.5
    return {
        "router": w((d, e), scale_in).float(),
        "gate": w((e, d, f), scale_in),
        "up": w((e, d, f), scale_in),
        "down": w((e, f, d), scale_out),
    }


def _capacity(tokens_per_group: int, cfg) -> int:
    m = cfg.moe
    c = math.ceil(m.top_k * tokens_per_group / m.num_experts
                  * m.capacity_factor)
    return max(1, c)


def route(x_f32: torch.Tensor, router: torch.Tensor, top_k: int):
    """x_f32: (G, Sg, d).  Returns (gates (G,Sg,k), ids (G,Sg,k), probs)."""
    logits = x_f32 @ router                                 # (G,Sg,E) f32
    probs = torch.softmax(logits, dim=-1)
    gates, ids = torch.topk(probs, top_k, dim=-1)
    gates = gates / torch.clamp_min(gates.sum(-1, keepdim=True), 1e-9)
    return gates, ids, probs


def aux_load_balance_loss(probs: torch.Tensor, ids: torch.Tensor,
                          num_experts: int) -> torch.Tensor:
    """Switch-style load-balance loss: E * sum_e f_e * p_e."""
    onehot = F.one_hot(ids, num_experts).float()            # (G,Sg,k,E)
    frac = onehot.sum(dim=(0, 1, 2)) / torch.clamp_min(onehot.sum(), 1.0)
    mean_prob = probs.mean(dim=(0, 1))
    return num_experts * torch.sum(frac * mean_prob)


def _dispatch_indices(ids: torch.Tensor, num_experts: int, capacity: int):
    """ids: (G, Sg, k).  Group-local sort dispatch bookkeeping: the sort
    order, each sorted choice's slot ``dest`` in its group's (E*C) buffer
    (E*C: dropped), its source token and top-k slot, and whether it was
    kept."""
    G, Sg, k = ids.shape
    T = Sg * k
    flat = ids.reshape(G, T)
    order = torch.argsort(flat, dim=-1, stable=True)        # (G,T)
    sorted_e = torch.gather(flat, -1, order)
    experts = torch.arange(num_experts, device=ids.device)
    starts = torch.searchsorted(sorted_e,
                                experts.expand(G, num_experts).contiguous())
    pos = (torch.arange(T, device=ids.device)[None]
           - torch.gather(starts, -1, sorted_e))
    keep = pos < capacity
    dest = torch.where(keep, sorted_e * capacity + pos,
                       num_experts * capacity)
    token = order // k                                      # source token
    choice = order % k                                      # top-k slot
    return order, dest, token, choice, keep


def _experts(params: Params, buf: torch.Tensor) -> torch.Tensor:
    """The expert SwiGLU over buf (E, M, d) -> (E, M, d): stacked
    products for raw weights, one int8 GEMM an expert and projection for
    q-packs."""
    def proj(key, h):
        w = params[key]
        if not is_qpack(w):
            return torch.bmm(h, w.to(h.dtype))
        return torch.stack([wq_ops.wq_gemm(h[e], w["q"][e], w["scale"][e])
                            for e in range(h.shape[0])])

    h = F.silu(proj("gate", buf)) * proj("up", buf)
    return proj("down", h)


def _held(params: Params, cfg) -> Tuple[int, int, Tuple[str, ...]]:
    """(first expert, experts held, the mesh axes a partial ``y`` is
    summed over) of this rank's expert blocks: (0, E, ()) where it holds
    every expert whole."""
    w = params["gate"]
    shape = (w["q"] if is_qpack(w) else w).shape
    m = cfg.moe
    axes: Tuple[str, ...] = ()
    first = 0
    if shape[0] < m.num_experts:
        axes += paxes.rule_axes("expert")
        first = paxes.rule_index("expert") * shape[0]
    if shape[-1] < m.expert_d_ff:
        axes += paxes.rule_axes("expert_mlp")
    return first, shape[0], axes


def _combine(y: torch.Tensor, axes: Tuple[str, ...]) -> torch.Tensor:
    """A rank's partial MoE output summed over ``axes``."""
    return collectives.all_reduce_sum(y, axes)


def moe_apply(params: Params, x: torch.Tensor, cfg, *,
              with_aux: bool = True) -> Tuple[torch.Tensor, torch.Tensor]:
    """x: (G, Sg, d) grouped tokens.  Returns (y, aux_loss); without
    ``with_aux`` (serving) the aux loss is not computed and comes back
    ``None``.  A rank holding a block of the experts (or of each
    expert's d_ff) computes on it and sums ``y`` over the split axes."""
    G, Sg, d = x.shape
    m = cfg.moe
    E, k = m.num_experts, m.top_k
    C = _capacity(Sg, cfg)
    first, n_held, axes = _held(params, cfg)

    gates, ids, probs = route(x.float(), params["router"], k)
    aux = aux_load_balance_loss(probs, ids, E) if with_aux else None
    order, dest, token, _, keep = _dispatch_indices(ids, E, C)

    # every group's buffer of the held experts in one (n_held, G*C, d)
    # tensor, expert-major: group g's slot e*C + p is row (e - first)*G*C
    # + g*C + p; the row past the end takes the dropped choices and those
    # of the experts another rank holds
    rows = G * C
    grp = torch.arange(G, device=x.device)[:, None]
    expert = dest // C
    held = keep & (expert >= first) & (expert < first + n_held)
    slot = torch.where(held, (expert - first) * rows + grp * C + dest % C,
                       n_held * rows)                       # (G, T)
    src = (grp * Sg + token).reshape(-1)
    buf = x.new_zeros((n_held * rows + 1, d))
    buf[slot.reshape(-1)] = x.reshape(G * Sg, d)[src]
    out = _experts(params, buf[:-1].view(n_held, rows, d)).reshape(
        n_held * rows, d)

    routed = out[torch.where(held, slot, 0)]                # (G, T, d) sorted
    routed = torch.where(held[..., None], routed, 0.0)
    gate_sorted = torch.gather(gates.reshape(G, Sg * k), -1, order)
    contrib = routed * gate_sorted[..., None].to(routed.dtype)
    # un-sort back to (token, choice) layout and sum the choices
    y = torch.zeros_like(contrib).scatter(
        1, order[..., None].expand(G, Sg * k, d), contrib)
    y = y.view(G, Sg, k, d).sum(dim=2)
    return (_combine(y, axes) if axes else y), aux
