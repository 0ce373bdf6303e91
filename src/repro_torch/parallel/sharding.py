"""Per-architecture sharding rule selection: the counterpart of
``repro.parallel.sharding``, verbatim.

``rules_for(cfg, mesh)`` starts from ``DEFAULT_RULES`` and adapts to the
architecture × mesh combination:

  * MoE whose expert count divides the ``model`` axis -> pure EP
    (``expert -> model``); otherwise TP-within-expert
    (``expert_mlp -> model``), e.g. grok-1's 8 experts on a 16-way axis.
  * Tiny models (whisper-base) replicate attention projections rather than
    splitting 64-wide head fragments across 16 devices.

Divisibility of individual tensor dims is still enforced downstream by
``resolve_spec`` — these rules set intent; the resolver records any forced
replication for the layout report.
"""
from __future__ import annotations

from typing import Any, Dict, List, Optional

from repro_torch.configs.base import ModelConfig
from repro_torch.parallel.axes import DEFAULT_RULES, Rules


def model_axis_size(mesh) -> int:
    return mesh.shape.get("model", 1)


def rules_for(cfg: ModelConfig, mesh, *, sp_kv: bool = False) -> Rules:
    rules: Rules = dict(DEFAULT_RULES)
    tp = model_axis_size(mesh)

    if cfg.moe is not None:
        if cfg.moe.num_experts % tp == 0:
            rules["expert"] = "model"
            rules["expert_mlp"] = None
        else:
            rules["expert"] = None
            rules["expert_mlp"] = "model"

    # tiny attention (whisper-base: 8 heads x 64 dims): replicate attention
    # instead of splitting sub-head fragments across the model axis.
    if cfg.n_heads and cfg.n_heads * cfg.resolved_head_dim < 128 * tp:
        rules["heads"] = None
        rules["kv_heads"] = None

    # sequence-sharded KV cache for long-context decode: the cache length
    # shards over "model" (flash-decoding partial-softmax combine in
    # attention.attn_decode).  Projection weights KEEP their head
    # sharding — the boundary all-gathers only the per-token q/k/v
    # activations, not the weights.  Attention-free archs skip the rule
    # (no KV cache).
    if sp_kv and cfg.n_heads > 0:
        rules["kv_seq"] = "model"

    return rules


def layout_report(mesh, rules: Rules, decisions: List[str], *,
                  n_shards: Optional[int] = None,
                  sp_kv: bool = False) -> Dict[str, Any]:
    """JSONable record of a resolved sharding layout for Report metadata.

    ``decisions`` is the forced-replication log collected by
    ``axes.resolve_spec`` while a sharding context was active (e.g.
    "replicated logical axis 'kv_heads' (dim 10) — not divisible by mesh
    axes ('model',) (size 16)").  Surfacing it next to the rule set means
    a sharded artifact records the layout that *actually ran*, not just
    the one that was requested."""
    return {
        "mesh": {name: int(size) for name, size in mesh.shape.items()},
        "rules": {k: (list(v) if isinstance(v, tuple) else v)
                  for k, v in rules.items()},
        "forced_replication": list(decisions),
        **({} if n_shards is None else {"slot_shards": int(n_shards)}),
        "sp_kv": bool(sp_kv),
    }
