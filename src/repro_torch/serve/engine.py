"""Serving engines over the port's LM: continuous batching, plus the
fixed-batch baseline.

``ContinuousBatchingEngine`` is the counterpart of
``repro.serve.engine.ContinuousBatchingEngine``, with the same host
loop: the scheduler (a copy of the reference's) composes sarathi-style
mixed steps, and each step runs one batched (n_slots, 1) decode forward
plus one batch-1 (1, prefill_chunk) forward per prefilling slot, both in
decode mode.  It never branches on a family: the model's DecodeState
adapter says what the state is.  For a family that attends through the
paged cache (dense, moe, hybrid), the decode step walks the cache's pool
view with the engine's identity page map
(``PagedKVCache.page_index_array``, uploaded once) and a prefill row
uses the row-local identity map (``page_idx=None``); with ``paged_kernel=False`` (the reference's
bitwise-parity baseline) there is no page map, and both attend over the
dense cache (the flash-decode kernel on the card).  A family without
attention (ssm) gets no page map.  A recurrent prompt prefill (the ssm's
layers, the hybrid's mamba layers) runs token by token through the
masked recurrence.  A request of a cross-attention family (vlm, audio)
brings its context in ``submit(extra=…)``; at every (re-)admission the
engine installs it into the slot's cache row
(``LM.install_slot_context``: the cross K/V, for audio after the
encoder), and every forward after that reads it.

``StaticBatchEngine`` is the reference's run-to-completion baseline: one
``mode="prefill"`` forward over the whole batch of prompts (attention
layers: causal attention filling the K/V cache; mamba layers: the SSD
kernel; cross layers: attention to the batched context, whose K/V they
write into the cache), then a decode loop, which enters no paged
context: attention layers, cross layers too, decode through the
dense-cache attention.  ``make_prefill_step`` / ``make_serve_step`` are
its two steps, as in the reference.

Sampled tokens stay on the device between steps: ``prev_sampled``
(n_slots,) feeds the next step's decode rows and ``out_buf``
(3*n_slots, max_len) collects every committed token.  Both are allocated
once and updated in place — what donation does in the reference.  The
host reads ``out_buf`` only at a flush point, so without EOS detection a
plain step has no device sync; a verify step has one (the drafter needs
the accepted tokens), and a fast-path step leaves the drafter's
histories stale until the request next proposes.

The prefix cache (``prefix_cache=True``, families whose state is a
token prefix: dense, moe, vlm, audio) keeps released requests'
page-aligned prompt prefixes pooled; a matching admission copies the
donor slot's K/V in place (``LM.install_cache_prefix``) instead of
prefilling them.  Speculative decoding (``spec_decode=True``) drafts up
to ``spec_k`` tokens a greedy row with the n-gram drafter
(``serve/draft.py``), scores them in one (n_slots, spec_k + 1) verify
forward and keeps the longest prefix the argmax chain agrees with, plus
one token: the token-addressable families rewind their position
counters (``LM.adjust_cache_counters``); the recurrent ones (ssm,
hybrid) restore a snapshot of their state taken before the verify
forward and run it again with ``n_valid`` the accepted counts.
``check=True`` attaches the shadow-state checker
(``repro_torch.analysis.schedcheck``) to the cache and the scheduler.

Step time on the card comes from CUDA events recorded around each step
and read when the stats are summarized; on the CPU no step time is
recorded.  ``StepCostModel`` (the reference's, over the copied analytic
``core.costmodel``) adds each step's modeled flops and bytes to
``EngineStats``; ``modeled_step_time`` prices a step's composition
against the card's ``HWSpec`` (``self.hw``), the clock of the open-loop
front end's ``clock="model"`` (``serve/frontend.py``).

The stall-free chunk policy (``chunk_policy="stall_free"``,
``tbt_target_s``) is the copied scheduler's: it sizes each step's
prefill chunks from an estimate of seconds a token that each executed
step feeds (``Scheduler.note_step_wall``).  Under ``step_feedback =
"wall"`` (the default) the engine feeds its own step's CUDA-event time,
one sync a step, and only with that policy on; the CPU cannot time a
step, so there a stall-free step raises and the policy runs under the
front end's ``clock="model"``, which sets ``step_feedback =
"external"`` and feeds modeled times itself.

The paged kernel's KV split count is tuned at construction, as the
reference tunes its ``block_pages`` (``_tune_paged_kernel``): on the
card ``core.autotune.tune_paged_attention`` times every split count at
the engine's pure-decode shape, its rows at ragged lengths, or reads the
sweep from the on-disk cache (``retune=True`` measures again).  It keeps
``split_plan``'s count unless another beats it in most of the sweep's
paired rounds (a sign test) and by 15% of its median; ``paged_meta``
holds the sweep, the count chosen and why, and the pure-decode forward
launches B1 at that count.  The chunk rows (``page_idx=None``) and the
verify forward keep ``split_plan``'s count: the sweep did not time their
shapes.  On the CPU no sweep can be timed:
``paged_meta`` says so and ``retune=True`` raises.  An ssm has nothing to
tune, and ``paged_kernel=False`` tunes nothing (``paged_meta`` is
``None``).

Sharded serving (``mesh``, ``rules``, ``sp_kv``; the dense, moe, ssm
and hybrid families): one engine a rank of a ``launch.mesh.Mesh``, every
rank with the same host scheduler and cache bookkeeping, each holding
only its block of every parameter and of the cache (``mesh_layout``: the
reference's logical-axis rules resolved over the mesh, ``sharding_meta``
its ``layout_report``).  The slots split over the ``batch`` axes
(``n_shards``, the cache's slot shards): a rank runs the decode forward
over its slots and the prefill rows of its slots, and the sampled tokens
are combined over those axes before the host commits them, so every
rank makes the same host decisions (EOS, admissions, prefix donors) and
returns the same results.  The model axis splits heads, the MLP, the
vocabulary, the experts (``expert``, or each expert's d_ff where their
count does not divide it: ``expert_mlp``) and the mamba mixer's
``d_inner``; ``sp_kv=True`` splits the attention cache's length over it
instead of the KV heads (the hybrid's too, while its mamba sub-layers
split heads), unless the cache length does not divide or the family has
no attention (the reference's honesty rule: the rule is stripped, and
where it named axes the decision recorded).  One part of the cache is
laid out otherwise than ``sharding_meta`` records
(``MeshLayout.rank_state``): where the mixer's ``d_inner`` is split, a
rank's recurrent ``h`` holds its heads and its conv window ``conv`` its
x channels, then B and C whole, where the resolved spec would cut one
block of the whole window.  A mesh of one position is the unsharded
engine.  Under a mesh, speculative decoding, the stall-free policy, the
open-loop front end and the vlm and audio families raise
``NotImplementedError`` (ROADMAP A10).

Not ported yet (raises ``NotImplementedError`` if asked for):
build-time trace analysis (``analyze``).  For a family
whose state cannot be cut to a token prefix (ssm, hybrid)
``prefix_cache=True`` warns and serves with the pool off, as the
reference does.
"""
from __future__ import annotations

import contextlib
import dataclasses
import math
import warnings
from typing import Any, Callable, Dict, List, Optional, Sequence

import numpy as np
import torch

from repro_torch.analysis.findings import Finding
from repro_torch.analysis.schedcheck import SchedChecker
from repro_torch.configs.shapes import ShapeSpec
from repro_torch.core import costmodel
from repro_torch.launch.mesh import Mesh
from repro_torch.models import blocks, decode_state, mamba2
from repro_torch.models.attention import PagedDecodeState
from repro_torch.models.layers import dtype_of
from repro_torch.models.model import LM, MESH_FAMILIES
from repro_torch.models.quant import has_qpack
from repro_torch.parallel import axes as paxes
from repro_torch.parallel import collectives
from repro_torch.parallel.sharding import layout_report, rules_for
from repro_torch.serve import sampling
from repro_torch.serve.cache import PagedKVCache
from repro_torch.serve.draft import NGramDrafter
from repro_torch.serve.scheduler import (Request, RequestState, Scheduler,
                                         StepPlan)

# reference engine options this port does not have yet, with the value
# that means "off"; anything else raises NotImplementedError
_NOT_PORTED = {"analyze": False}


def make_prefill_step(model: LM) -> Callable:
    """``(params, cache, tokens, positions, extra) -> (next_tok (B,) int32,
    cache)``: one ``mode="prefill"`` forward, greedy on the last column;
    ``extra``: the batched (B, T, d) context of a cross-attention family,
    else ``None``."""
    def prefill_step(params, cache, tokens, positions, extra=None):
        logits, cache = model.forward(params, tokens, positions,
                                      mode="prefill", cache=cache,
                                      extra=extra)
        return torch.argmax(logits[:, -1], dim=-1).to(torch.int32), cache

    return prefill_step


def make_serve_step(model: LM, *, sample_temperature: float = 0.0,
                    generator: Optional[torch.Generator] = None
                    ) -> Callable:
    """One decode step: ``(params, cache, tokens (B, 1), positions,
    extra=None) -> (next_tok (B,) int32, cache)``; decode mode reads no
    ``extra`` (the cross K/V are in the cache).  Temperature > 0 draws
    from ``generator`` (the reference keys its draw on the position)."""
    def serve_step(params, cache, tokens, positions, extra=None):
        logits, cache = model.forward(params, tokens, positions,
                                      mode="decode", cache=cache)
        last = logits[:, -1]
        temps = torch.full((last.shape[0],), sample_temperature,
                           dtype=torch.float32, device=last.device)
        return sampling.sample_tokens(last, temps, generator,
                                      any_temp=sample_temperature > 0), cache

    return serve_step


def _events(device: torch.device):
    """A started (start, end) pair of CUDA events on the card; None on
    the CPU, where no step time is recorded."""
    if device.type != "cuda":
        return None
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    return start, end


def _record(stats, events, **counts) -> None:
    rec = StepRecord(**counts)
    if events is not None:
        events[1].record()
        rec.start, rec.end = events
    stats.steps.append(rec)


# ---------------------------------------------------------------------------
# mesh layout
# ---------------------------------------------------------------------------
@dataclasses.dataclass
class MeshLayout:
    """What ``mesh_layout`` resolves: the rules that run (``kv_seq``
    stripped where SP-KV cannot), the slot shards and their mesh axes,
    the resolved spec of every cache leaf and parameter, and the
    forced-replication decisions, in the reference's order.

    ``rank_state``: the recurrent state's leaves (``blocks.ssm_state``)
    that a rank lays out otherwise than their resolved spec, with their
    shapes on this rank, where the mixer's ``d_inner`` is split.  ``h``
    holds the rank's heads (its block of ``d_inner``; the resolved spec
    gives the same shape unless the rules leave ``heads`` whole); the
    conv window ``conv`` holds the rank's x channels, then B and C whole
    (the resolved spec cuts one contiguous block of ``[x | B | C]``,
    which is not the rank's heads).  ``sharding_meta`` records the
    resolved layout, the reference's."""
    rules: Dict[str, Any]
    sp_kv: bool
    n_shards: int
    batch_axes: tuple
    cache_specs: Any
    param_specs: Any
    decisions: List[str]
    rank_state: Dict[str, tuple] = dataclasses.field(default_factory=dict)


def mesh_layout(model: LM, params, *, n_slots: int, max_len: int,
                spec_k: int, mesh, rules, sp_kv: bool) -> MeshLayout:
    """The reference engine's ``_init_mesh_layout`` without the device
    puts: reads only ``mesh.shape``.  ``params``: the whole tree, or
    anything of its structure with whole shapes (the meta device's)."""
    extra_decisions: List[str] = []
    if sp_kv:
        # honesty over intent: sp_kv only runs when the kv_seq rule
        # resolves to axes this mesh has and their size divides the cache
        # length; otherwise the rule is stripped and, if it named axes,
        # the decision recorded
        kv_rule = rules.get("kv_seq")
        kv_axes = tuple(a for a in (kv_rule if isinstance(kv_rule, tuple)
                                    else (kv_rule,) if kv_rule else ())
                        if a in mesh.shape)
        size = (math.prod(mesh.shape[a] for a in kv_axes)
                if kv_axes else 0)
        if not kv_axes or max_len % size:
            sp_kv = False
            rules = dict(rules, kv_seq=None)
            if kv_axes:
                extra_decisions.append(
                    f"sp_kv disabled: cache length {max_len} not "
                    f"divisible by mesh axes {kv_axes} (size {size})")
    with paxes.sharding_ctx(mesh, rules):
        spec = paxes.resolve_spec(("batch",), (n_slots,))
        axs = paxes.entry_axes(spec[0] if len(spec) else None)
        n_shards = math.prod(mesh.shape[a] for a in axs) if axs else 1
        meta = LM(model.cfg, device="meta")
        cache = paxes.tree_shardings(model.cache_specs(),
                                     meta.init_cache(n_slots, max_len),
                                     mesh, rules)
        # the slot, output-row and draft buffers (whole on every rank
        # here), resolved as the reference resolves them
        for shape in ((n_slots,), (3 * n_slots, max_len),
                      (n_slots, spec_k + 1)):
            paxes.resolve_spec(("batch", None)[:len(shape)], shape)
        pspecs = paxes.tree_shardings(model.layout_specs(params), params,
                                      mesh, rules)
        decisions = extra_decisions + paxes.decisions()
        rank_state = _rank_state(model.cfg, meta, pspecs, cache, mesh,
                                 n_slots, max_len)
    return MeshLayout(dict(rules), sp_kv, n_shards, axs, cache, pspecs,
                      decisions, rank_state)


def _split(entry, mesh) -> int:
    return paxes.axes_size(mesh, paxes.entry_axes(entry))


def _spec_at(spec, dim: int):
    return spec[dim] if dim < len(spec) else None


def _weight_spec(spec):
    """A dense weight's resolved spec: its own, or its q-pack's ``q``."""
    if isinstance(spec, dict):
        return spec.get("w", spec.get("q"))
    return spec


def _sublayer_specs(cfg, pspecs) -> Dict[str, Any]:
    """The resolved specs of the first stack entry's sub-layers by kind
    (``"attn"``, ``"mamba"``)."""
    return {kind: p for p, kind, _ in blocks.sublayers(pspecs["stack"][:1],
                                                       cfg)}


def _rank_state(cfg, meta: LM, pspecs, cache_specs, mesh, n_slots: int,
                max_len: int) -> Dict[str, tuple]:
    """``MeshLayout.rank_state``: the shapes of a rank's ``h`` and conv
    window where the mixer's ``d_inner`` (``wx``'s columns) is split, as
    ``mamba2.init_state(d_inner=)`` lays them out."""
    mixer = _sublayer_specs(cfg, pspecs).get("mamba")
    if mixer is None:
        return {}
    d_inner, _, _ = mamba2.dims(cfg)
    split = _split(_spec_at(_weight_spec(mixer["mamba"]["wx"]), 1), mesh)
    if split == 1:
        return {}
    whole = blocks.ssm_state(cfg, meta.init_cache(n_slots, max_len))
    n_layers, batch = paxes.local_shape(
        whole["h"].shape, blocks.ssm_state(cfg, cache_specs)["h"], mesh)[:2]
    state = mamba2.init_state(cfg, n_layers, batch, whole["conv"].dtype,
                              "meta", d_inner=d_inner // split)
    return {k: tuple(v.shape) for k, v in state.items()}


def check_layout(cfg, lay: MeshLayout, mesh) -> None:
    """Raise ``NotImplementedError`` where a rank's blocks are not what
    the rank-local layers compute on (ROADMAP A10): an attention
    sub-layer's whole heads and (without SP-KV) its query heads' whole
    GQA groups (``_check_attention``); a mamba mixer's block of
    ``d_inner`` whole heads, with its ``heads`` leaves whole or split as
    that block (``_check_mixer``); an MoE's experts and each expert's
    d_ff not both split, and neither they nor the mixer's ``d_inner``
    split over the slot shards' axes (``_check_sums``)."""
    sub = _sublayer_specs(cfg, lay.param_specs)
    if "attn" in sub:
        _check_attention(cfg, sub["attn"]["attn"],
                         blocks.kv_cache(cfg, lay.cache_specs), lay.sp_kv,
                         mesh)
    if "mamba" in sub:
        _check_mixer(cfg, sub["mamba"]["mamba"], mesh)
    _check_sums(cfg, lay)


def _check_sums(cfg, lay: MeshLayout) -> None:
    """The rank-local MoE sums ``y`` over the axes that split its experts
    (or each expert's d_ff), the mixer over those of its ``d_inner``:
    ranks on those axes must hold the same tokens, and the MoE splits
    one of the two."""
    split = {}
    for p, kind, _ in blocks.sublayers(lay.param_specs["stack"][:1], cfg):
        if "moe" in p:
            gate = _weight_spec(p["moe"]["gate"])
            split["expert"] = paxes.entry_axes(_spec_at(gate, 0))
            split["expert_mlp"] = paxes.entry_axes(_spec_at(gate, 2))
        if kind == "mamba":
            split["mlp"] = paxes.entry_axes(
                _spec_at(_weight_spec(p["mamba"]["wx"]), 1))
    if split.get("expert") and split.get("expert_mlp"):
        raise NotImplementedError(
            f"the experts split over {split['expert']} and each expert's "
            f"d_ff over {split['expert_mlp']}: the rank-local MoE splits "
            f"one of the two; serve with rules that replicate the other "
            f"(ROADMAP A10)")
    for name, axes in split.items():
        shared = set(axes) & set(lay.batch_axes)
        if shared:
            raise NotImplementedError(
                f"{name!r} split over {axes}, which also cut the slots "
                f"({lay.batch_axes}): a rank's sum over them would add "
                f"other slots' tokens; serve with rules that keep {name!r} "
                f"off the batch axes (ROADMAP A10)")


def _check_mixer(cfg, mixer, mesh) -> None:
    s = cfg.ssm
    d_inner, _, _ = mamba2.dims(cfg)
    x_entry = _spec_at(_weight_spec(mixer["wx"]), 1)
    dt_entry = _spec_at(_weight_spec(mixer["wdt"]), 1)
    held = d_inner // _split(x_entry, mesh)
    if held % s.head_dim:
        raise NotImplementedError(
            f"a rank's block of the mixer's d_inner ({held} of {d_inner} "
            f"channels) is not whole heads of {s.head_dim}: serve on "
            f"another mesh (ROADMAP A10)")
    if paxes.entry_axes(dt_entry) not in ((), paxes.entry_axes(x_entry)):
        raise NotImplementedError(
            "the mixer's 'heads' leaves split apart from its 'mlp' block: "
            "serve with rules that map both alike (ROADMAP A10)")


def _check_attention(cfg, attn, kv_specs, sp_kv: bool, mesh) -> None:
    out_dim = 1
    q_split = _split(_spec_at(_weight_spec(attn["wq"]), out_dim), mesh)
    kv_split = _split(_spec_at(_weight_spec(attn["wk"]), out_dim), mesh)
    cache_heads = _split(_spec_at(kv_specs["k"], 3), mesh)
    if cfg.n_heads % q_split or cfg.n_kv_heads % kv_split:
        raise NotImplementedError(
            f"{cfg.n_heads} query / {cfg.n_kv_heads} KV heads of "
            f"{cfg.resolved_head_dim} split {q_split} / {kv_split} ways: "
            f"the resolved blocks cut a head (the rules resolve on the "
            f"flattened heads x head_dim dim); serve with rules that "
            f"replicate 'heads' / 'kv_heads' or on another mesh")
    if sp_kv:
        return
    if not q_split == kv_split == cache_heads:
        raise NotImplementedError(
            f"query heads split {q_split} ways, KV projections {kv_split}, "
            f"cached KV heads {cache_heads}: a rank would hold query heads "
            f"whose GQA group's KV heads live on another rank (n_kv_heads "
            f"% model != 0); serve with sp_kv=True or rules that replicate "
            f"'heads'")


def _local_tree(tree, whole, specs, mesh):
    """``tree`` as this rank's blocks: each leaf whose shape is the whole
    leaf's is cut (a copy); one already of its block's shape is kept."""
    if isinstance(tree, dict):
        return {k: _local_tree(tree[k], whole[k], specs[k], mesh)
                for k in tree}
    if isinstance(tree, list):
        return [_local_tree(*a, mesh) for a in zip(tree, whole, specs)]
    full = tuple(whole.shape)
    block = paxes.local_shape(full, specs, mesh)
    if tuple(tree.shape) == full:
        if block == full:
            return tree
        return paxes.local_slice(tree, specs, mesh).clone(
            memory_format=torch.contiguous_format)
    if tuple(tree.shape) == block:
        return tree
    raise ValueError(f"a parameter of shape {tuple(tree.shape)} is neither "
                     f"the whole {full} nor this rank's block {block}")


def _local_zeros(whole, specs, mesh, device):
    """Zeros of this rank's block of every leaf of a (meta) tree."""
    if isinstance(whole, dict):
        return {k: _local_zeros(whole[k], specs[k], mesh, device)
                for k in whole}
    return torch.zeros(paxes.local_shape(whole.shape, specs, mesh),
                       dtype=whole.dtype, device=device)


def _rank_cache(cfg, lay: MeshLayout, mesh, n_slots: int, max_len: int,
                device):
    """Zeros of this rank's cache: each leaf's block under its resolved
    spec, the recurrent state's leaves of ``lay.rank_state`` at the
    rank's own layout."""
    cache = _local_zeros(LM(cfg, device="meta").init_cache(n_slots,
                                                           max_len),
                         lay.cache_specs, mesh, device)
    state = blocks.ssm_state(cfg, cache)
    for name, shape in lay.rank_state.items():
        state[name] = torch.zeros(shape, dtype=state[name].dtype,
                                  device=device)
    return cache


# ---------------------------------------------------------------------------
# metrics
# ---------------------------------------------------------------------------
class StepCostModel:
    """Analytic per-step FLOPs/bytes (core/costmodel) for engine stats: a
    copy of the reference's.

    Decode rows are costed at a representative mid-stream cache length
    (``max_len // 2``); prefill tokens at the per-token average of a full
    ``max_len`` prefill.  These are *model* numbers (the analytic
    implementation cost, not a counter): the modeled bound time of a step
    over its measured time is the served step's share of its roofline.
    """

    def __init__(self, cfg, max_len: int):
        kv = max(1, max_len // 2)
        # per-token decode cost excludes the enc-dec audio encoder: the
        # engines run it once per request at admission (install_context),
        # so it is amortized into the prefill per-token average instead
        self.decode_flops_tok = costmodel.forward_flops(
            cfg, 1, 1, kv_len=kv, decode=True,
            include_encoder=False)["total"]
        dec = costmodel.step_hbm_bytes(
            cfg, ShapeSpec("serve_decode", kv, 1, "decode"))
        self.decode_param_bytes = dec.get("params", 0.0)
        self.decode_cache_bytes_row = dec.get("cache", 0.0)
        S = max(1, max_len)
        self.prefill_flops_tok = costmodel.forward_flops(cfg, 1, S)["total"] / S
        self.prefill_bytes_tok = costmodel.step_hbm_bytes(
            cfg, ShapeSpec("serve_prefill", S, 1, "prefill"))["total"] / S

    def step_cost(self, n_decode: int, n_prefill_tokens: int
                  ) -> tuple[float, float]:
        flops = (n_decode * self.decode_flops_tok
                 + n_prefill_tokens * self.prefill_flops_tok)
        # params stream through HBM once per batched decode step, not once
        # per row; per-row traffic is the row's own cache read
        bytes_ = ((self.decode_param_bytes if n_decode else 0.0)
                  + n_decode * self.decode_cache_bytes_row
                  + n_prefill_tokens * self.prefill_bytes_tok)
        return flops, bytes_


@dataclasses.dataclass
class StepRecord:
    n_decode: int
    n_prefill_tokens: int
    # the paged cache's slot occupancy and page utilization after the
    # step (0.0 for the static engine, which has no paged cache)
    occupancy: float = 0.0
    page_utilization: float = 0.0
    # the step ran the speculative verify forward (not the plain step)
    verify: bool = False
    # CUDA events bracketing the step on the card (None on the CPU)
    start: Optional[torch.cuda.Event] = None
    end: Optional[torch.cuda.Event] = None

    def device_ms(self) -> Optional[float]:
        """Milliseconds between the step's events (waits for the end
        event); ``None`` on the CPU, where nothing is recorded."""
        if self.start is None:
            return None
        self.end.synchronize()
        return self.start.elapsed_time(self.end)


@dataclasses.dataclass
class EngineStats:
    steps: List[StepRecord] = dataclasses.field(default_factory=list)
    generated_tokens: int = 0
    # model forward passes run (batched decode steps, verify passes and
    # prefill rows)
    forwards: int = 0
    # prompt tokens whose prefill the prefix cache skipped (mirrors
    # Scheduler.prefix_hit_tokens)
    prefix_hit_tokens: int = 0
    # speculative decoding: draft tokens fed to verify steps, and how
    # many of them greedy acceptance kept (the token after them is a
    # normal sample, counted in generated_tokens only)
    drafted_tokens: int = 0
    accepted_draft_tokens: int = 0
    # the analytic (StepCostModel) work of the steps run
    model_flops: float = 0.0
    model_bytes: float = 0.0

    def summary(self) -> Dict[str, Optional[float]]:
        """The reference's keys plus ``forwards``.  Times (``tok_per_s``
        and ``model_tflops_per_s``: tokens and modeled flops over the
        summed step events; ``step_ms_p50``, ``step_ms_p95``) are
        CUDA-event times on the card and ``None`` on the CPU.  With no
        step, every rate is 0.0 and ``note`` says why."""
        accept_rate = (self.accepted_draft_tokens / self.drafted_tokens
                       if self.drafted_tokens else 0.0)
        counts = {"prefix_hit_tokens": self.prefix_hit_tokens,
                  "drafted_tokens": self.drafted_tokens,
                  "accepted_draft_tokens": self.accepted_draft_tokens,
                  "accept_rate": accept_rate,
                  "model_flops": self.model_flops,
                  "model_bytes": self.model_bytes}
        if not self.steps:
            return {"steps": 0, "generated_tokens": 0, "forwards": 0,
                    "tok_per_s": 0.0, "step_ms_p50": 0.0,
                    "step_ms_p95": 0.0, "mean_occupancy": 0.0,
                    "mean_page_utilization": 0.0, "prefix_hit_rate": 0.0,
                    "model_tflops_per_s": 0.0,
                    **counts, "note": "zero steps executed"}
        prefill_tokens = sum(s.n_prefill_tokens for s in self.steps)
        prompt_total = prefill_tokens + self.prefix_hit_tokens
        out: Dict[str, Optional[float]] = {
            "steps": len(self.steps),
            "generated_tokens": self.generated_tokens,
            "forwards": self.forwards,
            "tok_per_s": None, "step_ms_p50": None, "step_ms_p95": None,
            "model_tflops_per_s": None,
            "mean_occupancy": float(np.mean(
                [s.occupancy for s in self.steps])),
            "mean_page_utilization": float(np.mean(
                [s.page_utilization for s in self.steps])),
            # the share of all prompt tokens the prefix cache served
            "prefix_hit_rate": (self.prefix_hit_tokens / prompt_total
                                if prompt_total else 0.0),
            **counts,
        }
        ms = sorted(s.device_ms() for s in self.steps
                    if s.start is not None)
        if ms:
            total = sum(ms)
            out.update(
                tok_per_s=(self.generated_tokens / (total / 1e3)
                           if total else 0.0),
                model_tflops_per_s=(self.model_flops / (total / 1e3) / 1e12
                                    if total else 0.0),
                step_ms_p50=ms[len(ms) // 2],
                step_ms_p95=ms[min(len(ms) - 1, int(0.95 * len(ms)))])
        return out


# ---------------------------------------------------------------------------
# continuous batching
# ---------------------------------------------------------------------------
class ContinuousBatchingEngine:
    """Paged continuous-batching engine (every family the port serves).

    Usage::

        eng = ContinuousBatchingEngine(model, params, n_slots=4, max_len=64)
        rid = eng.submit(prompt_tokens, max_new_tokens=16)        # queued
        results = eng.run()          # drain; {rid: np.ndarray of tokens}

    The engine runs on the model's device.  ``chunk_policy`` /
    ``tbt_target_s``, ``prefix_cache`` / ``prefix_pool``, ``spec_decode``
    / ``spec_k`` and ``check`` are the reference's options (see the
    module docstring); ``check=None`` takes the class attribute
    ``_DEFAULT_CHECK``, which a test module may set to shadow-check every
    engine it builds.  ``hw`` (the card's ``HWSpec``; the SXM part's on
    the CPU) prices ``modeled_step_time``, and ``step_feedback`` says
    what feeds the stall-free policy: both are plain attributes.
    """

    #: class-level default for ``check``
    _DEFAULT_CHECK = False

    def __init__(self, model: LM, params, *, n_slots: int, max_len: int,
                 page_size: int = 16, prefill_chunk: int = 8,
                 chunk_policy: str = "fixed",
                 tbt_target_s: Optional[float] = None,
                 page_budget: Optional[int] = None,
                 eos_id: Optional[int] = None, seed: int = 0,
                 prefix_cache: bool = False, prefix_pool: int = 8,
                 mesh: Optional[Mesh] = None, rules=None,
                 sp_kv: bool = False,
                 paged_kernel: Optional[bool] = None, retune: bool = False,
                 spec_decode: bool = False, spec_k: int = 4,
                 check: Optional[bool] = None, **kwargs):
        for name, value in kwargs.items():
            if name not in _NOT_PORTED:
                raise TypeError(f"unexpected keyword argument {name!r}")
            if value != _NOT_PORTED[name]:
                raise NotImplementedError(
                    f"{name}={value!r} is not ported yet")
        if mesh is not None:
            _check_meshable(model, mesh, spec_decode, chunk_policy)
        elif sp_kv:
            raise NotImplementedError(
                "sp_kv=True splits the cache length over a mesh's model "
                "axis: pass mesh= (a launch.mesh.Mesh with a model axis)")
        if spec_decode and spec_k < 1:
            raise ValueError(
                f"spec_decode=True needs spec_k >= 1, got {spec_k}")
        self.spec_decode = bool(spec_decode)
        self.spec_k = int(spec_k) if self.spec_decode else 0
        if prefix_cache and not model.decode_state.prefix_cachable:
            warnings.warn(
                f"prefix_cache=True ignored: family {model.cfg.family!r} "
                "has non-token-addressable (recurrent) decode state that "
                "cannot be truncated to a prompt prefix; serving with the "
                "prefix cache off", UserWarning, stacklevel=2)
        self.prefix_cache = bool(prefix_cache
                                 and model.decode_state.prefix_cachable)
        self.model = model
        self.params = params
        self.device = model.device
        self.n_slots = n_slots
        self.max_len = max_len
        # the mesh layout: this rank's slots [_slot_lo, _slot_lo +
        # _n_local), its first cache position (SP-KV) and its blocks of
        # the parameters; without a mesh, every slot and whole tensors
        self.mesh = mesh
        self.sp_kv = bool(sp_kv)
        self.rules = None
        self.n_shards = 1
        self.sharding_meta: Optional[Dict[str, Any]] = None
        self._slot_lo, self._n_local, self._kv_offset = 0, n_slots, 0
        self._batch_axes: tuple = ()
        self._layout: Optional[MeshLayout] = None
        if mesh is not None:
            self.rules = (dict(rules) if rules is not None
                          else rules_for(model.cfg, mesh, sp_kv=sp_kv))
            self._init_mesh_layout(prefill_chunk)
        self.kv = PagedKVCache(
            n_slots, max_len, page_size, page_budget=page_budget,
            slot_aux_tokens=model.decode_state.context_tokens(model.cfg),
            prefix_pool=prefix_pool if self.prefix_cache else 0,
            n_shards=self.n_shards)
        self.sched = Scheduler(self.kv, prefill_chunk=prefill_chunk,
                               eos_id=eos_id, chunk_policy=chunk_policy,
                               tbt_target_s=tbt_target_s,
                               spec_k=self.spec_k)
        # what feeds the stall-free chunk policy's per-token estimate:
        # "wall" (default) notes each step's CUDA-event time; the open-loop
        # front end switches this to "external" under its model clock and
        # feeds modeled step times itself
        self.step_feedback = "wall"
        self.hw = costmodel.hw_of(self.device)
        self._cost = StepCostModel(model.cfg, max_len)
        self.drafter: Optional[NGramDrafter] = None
        # rids whose drafter history misses tokens committed by no-draft
        # fast-path steps (which read nothing back); resynced from
        # out_buf right before the rid next proposes
        self._draft_stale: set = set()
        if self.spec_decode:
            self.drafter = NGramDrafter(self.spec_k,
                                        **self._drafter_throttle())
        self.check = bool(self._DEFAULT_CHECK if check is None else check)
        self.checker: Optional[SchedChecker] = None
        if self.check:
            self.checker = SchedChecker.attach(self.kv, self.sched)
        # the paged flash-decode is on by default; paged_kernel=False
        # attends over the dense cache instead (the reference's
        # bitwise-parity baseline).  The identity page map of the decode
        # step's pool view exists for families that attend through the
        # paged cache, with the paged kernel on.
        self.paged_kernel = (bool(paged_kernel) if paged_kernel is not None
                             else True)
        self._paged = model.decode_state.paged and self.paged_kernel
        self._page_idx = None
        if self._paged:
            # this rank's slots' rows of the page map, over its own pool
            lo, n = self._slot_lo, self._n_local
            pages = self.kv.page_index_array()[lo:lo + n]
            self._page_idx = torch.as_tensor(
                pages - lo * self.kv.pages_per_slot, device=self.device)
        # the pure-decode forward's KV split count (None: split_plan's)
        self._paged_splits: Optional[int] = None
        self.paged_meta: Optional[Dict] = None
        if self.paged_kernel:
            self.paged_meta = self._tune_paged_kernel(retune)
        self._n_out_rows = 3 * n_slots
        if self._layout is None:
            self.cache = self.model.init_cache(self.n_slots, self.max_len)
        else:
            self.cache = _rank_cache(model.cfg, self._layout, mesh, n_slots,
                                     max_len, self.device)
        # a recurrent family's verify runs twice: its state (every leaf
        # that is not a K/V entry: conv windows, SSD h, position counters)
        # is copied here before the first pass and back before the second
        # (buffers allocated once)
        self._snapshot: List[tuple] = []
        if self.spec_decode and not model.decode_state.token_addressable:
            self._snapshot = [
                (leaf, torch.empty_like(leaf))
                for leaf, spec in decode_state.state_leaves(
                    self.cache, model.cache_specs())
                if "kv_seq" not in spec]
        self._out_buf = torch.zeros((self._n_out_rows, self.max_len),
                                    dtype=torch.int32, device=self.device)
        self._prev_sampled = torch.zeros((self.n_slots,), dtype=torch.int32,
                                         device=self.device)
        # each slot shard draws its own temperature noise (the ranks of one
        # shard alike); shard 0's seed is the unsharded engine's
        self._seed = seed + self._slot_lo // max(self._n_local, 1)
        self._gen = torch.Generator(device=self.device)
        self._gen.manual_seed(self._seed)
        self._free_rows = list(range(self._n_out_rows))
        self._slot_row = np.full((self.n_slots,), -1, np.int32)
        self._pending: List[Request] = []        # finished, tokens unread
        self._pending_rows: Dict[int, int] = {}  # rid -> out row
        self._step_idx = 0
        self._seen_discarded = 0
        self.stats = EngineStats()
        self._results: Dict[int, np.ndarray] = {}
        # the last executed step's composition (set before its commit;
        # None when the last iteration had no plan), its sampled
        # [(slot, rid)] and the rids admitted into a reset slot
        self.last_plan: Optional[StepPlan] = None
        self.last_sampled_rids: List[tuple] = []
        self.last_admitted_rids: List[int] = []

    # -- mesh -----------------------------------------------------------
    def _init_mesh_layout(self, prefill_chunk: int) -> None:
        """Resolve the layout over ``self.mesh`` (``mesh_layout``), check
        that the rank-local layers can run it, and keep this rank's
        blocks of the parameters (a whole leaf is cut; a leaf already of
        its block's shape is kept)."""
        model, mesh = self.model, self.mesh
        whole = LM(model.cfg, device="meta").init_params(
            None, int8=has_qpack(self.params))
        lay = mesh_layout(model, whole, n_slots=self.n_slots,
                          max_len=self.max_len, spec_k=0, mesh=mesh,
                          rules=self.rules, sp_kv=self.sp_kv)
        check_layout(model.cfg, lay, mesh)
        self._layout = lay
        self.rules, self.sp_kv, self.n_shards = (lay.rules, lay.sp_kv,
                                                 lay.n_shards)
        self._batch_axes = lay.batch_axes
        self._n_local = self.n_slots // self.n_shards
        self._slot_lo = paxes.axes_index(mesh, lay.batch_axes) * self._n_local
        if self.sp_kv:
            kv_axes = paxes.entry_axes(_spec_at(
                blocks.kv_cache(model.cfg, lay.cache_specs)["k"], 2))
            s_shard = self.max_len // paxes.axes_size(mesh, kv_axes)
            if prefill_chunk > s_shard:
                raise ValueError(
                    f"prefill_chunk {prefill_chunk} is wider than a rank's "
                    f"slice of the cache ({s_shard} positions): a step's "
                    f"K/V write needs a distinct target a column")
            self._kv_offset = paxes.axes_index(mesh, kv_axes) * s_shard
        self.params = _local_tree(self.params, whole, lay.param_specs, mesh)
        # the mixers' rank leaves (heads, conv taps), gathered once here
        # rather than in every decode step
        with self._ctx():
            for p, kind, _ in blocks.sublayers(self.params["stack"],
                                               model.cfg):
                if kind == "mamba":
                    p["mamba"] = mamba2.rank_mixer(p["mamba"], model.cfg)
        self.sharding_meta = layout_report(mesh, lay.rules, lay.decisions,
                                           n_shards=self.n_shards,
                                           sp_kv=self.sp_kv)

    def _ctx(self):
        """The sharding context a forward runs in (none without a mesh)."""
        if self.mesh is None:
            return contextlib.nullcontext()
        return paxes.sharding_ctx(self.mesh, self.rules)

    def _owns(self, slot: int) -> bool:
        return self._slot_lo <= slot < self._slot_lo + self._n_local

    def _gather_slots(self, t: torch.Tensor) -> torch.Tensor:
        """This rank's slots' values (dim 0) -> every slot's, over the
        slot shards' axes (a no-op without a mesh)."""
        if self.mesh is None:
            return t
        return collectives.all_gather(t, 0, self._batch_axes, self.mesh)

    @property
    def snapshot_bytes(self) -> int:
        """Bytes of the recurrent state the two-pass verify snapshots (0
        for a token-addressable family or with ``spec_decode`` off)."""
        return sum(b.numel() * b.element_size() for _, b in self._snapshot)

    def _dev(self, a, dtype=None) -> torch.Tensor:
        return torch.as_tensor(np.asarray(a), dtype=dtype,
                               device=self.device)

    def _tune_paged_kernel(self, retune: bool) -> Dict:
        """Pick the paged kernel's KV split count for the pure-decode
        forward via the persistent ``core.autotune`` sweep cache
        (interleaved CUDA-event medians and quartiles; ``retune=True``
        forces re-measurement): ``paged_meta["splits"]``, with
        ``paged_meta["why"]``."""
        cfg = self.model.cfg
        if not self.model.decode_state.paged:
            # no attention KV on the decode path: nothing to tune
            return {"skipped": f"family {cfg.family!r} has no attention "
                               f"KV cache"}
        if self.mesh is not None:
            return {"skipped": "under a mesh: each rank launches at "
                               "split_plan's count (the sweep times the "
                               "unsharded shape)"}
        if self.device.type != "cuda":
            if retune:
                raise RuntimeError(
                    f"retune=True times the paged kernel's split sweep "
                    f"with CUDA events on a CUDA card; this engine is on "
                    f"{self.device}")
            return {"skipped": "no sweep on the CPU: the split sweep "
                               "times the CUDA kernel with CUDA events on "
                               "the card"}
        from repro_torch.core import autotune
        info = autotune.tune_paged_attention(
            n_slots=self.n_slots, max_len=self.max_len,
            page_size=self.kv.page_size, n_kv_heads=cfg.n_kv_heads,
            n_q_heads=cfg.n_heads, head_dim=cfg.resolved_head_dim,
            dtype=cfg.compute_dtype, retune=retune, device=self.device)
        self._paged_splits = int(info["splits"])
        return info

    def _paged_state(self, page_idx, splits: Optional[int] = None
                     ) -> Optional[PagedDecodeState]:
        return (PagedDecodeState(page_idx, self.kv.page_size, splits)
                if self._paged else None)

    # -- steps ----------------------------------------------------------
    def _commit_samples(self, nxt: torch.Tensor, slots: Sequence[int],
                        src: Sequence[int], out_idx: Sequence[int]) -> None:
        """Write the samples ``nxt[src]`` of sample rows into their slots'
        output rows at ``out_idx`` and carry them forward in
        ``prev_sampled``.  Only rows that sample are passed, so nothing
        needs dropping on the device (the reference's ``mode="drop"``)."""
        if not slots:
            return
        rows = self._dev(self._slot_row[list(slots)], torch.long)
        cols = self._dev(list(out_idx), torch.long)
        vals = nxt[self._dev(list(src), torch.long)]
        self._out_buf.index_put_((rows, cols), vals)
        self._prev_sampled.index_put_((self._dev(list(slots), torch.long),),
                                      vals)

    def _decode_inputs(self, plan: StepPlan, width: int):
        """The decode rows' (tokens, positions), the first ``width``
        columns of the plan's: each row's input token is the previous
        step's on-device sample (``token_src``), drafts ride behind it."""
        rows = slice(self._slot_lo, self._slot_lo + self._n_local)
        tokens = self._dev(plan.tokens[rows, :width], torch.long)
        token_src = self._dev(plan.token_src[rows], torch.bool)
        tokens[:, 0] = torch.where(token_src,
                                   self._prev_sampled[rows].long(),
                                   tokens[:, 0])
        return tokens, self._dev(plan.positions[rows, :width], torch.long)

    def _forward_decode(self, tokens, positions, n_valid,
                        splits: Optional[int] = None) -> torch.Tensor:
        with self._ctx():
            logits, self.cache = self.model.forward(
                self.params, tokens, positions, mode="decode",
                cache=self.cache, n_valid=n_valid,
                paged=self._paged_state(self._page_idx, splits))
        self.stats.forwards += 1
        return logits

    def _decode_step(self, plan: StepPlan) -> None:
        """The plain single-column step (with ``spec_decode`` on, a step
        where no row carries a draft: the no-draft fast path).  Under a
        mesh, over this rank's slots; the samples are then gathered."""
        rows = slice(self._slot_lo, self._slot_lo + self._n_local)
        tokens, positions = self._decode_inputs(plan, 1)
        logits = self._forward_decode(
            tokens, positions, self._dev(plan.n_valid[rows], torch.int32),
            splits=self._paged_splits)
        temps = self._dev(plan.temperatures[rows], torch.float32)
        nxt = self._gather_slots(sampling.sample_tokens(
            logits[:, 0], temps, self._gen,
            any_temp=bool((plan.temperatures > 0).any())))
        sample = [s for s in range(self.n_slots)
                  if plan.out_idx[s] < self.max_len]
        self._commit_samples(nxt, sample, sample,
                             [int(plan.out_idx[s]) for s in sample])

    def _verify_step(self, plan: StepPlan):
        """The draft-verify step: one forward over (n_slots, spec_k + 1)
        columns; column i's argmax is the model's token after the fed
        tokens 0..i (column 0 through the sampler, as the plain step;
        rows at temperature > 0 never carry drafts).  Greedy acceptance
        keeps the longest draft prefix equal to that chain, plus the
        token at its end.  A token-addressable family rewinds its
        position counters to the accepted frontier; a recurrent one
        restores the state snapshot taken before the pass and runs the
        forward again with ``n_valid`` the accepted counts (the masked
        recurrence then commits exactly the accepted prefix).  The
        accepted tokens of the sampled rows are written into their
        output rows and the last of them carried forward, all on the
        device.  Returns the device tensors (n_accept (n_slots,), acc
        (n_slots, spec_k + 1))."""
        S = self.spec_k + 1
        tokens, positions = self._decode_inputs(plan, S)
        n_valid = self._dev(plan.n_valid, torch.int32)
        for leaf, buf in self._snapshot:
            buf.copy_(leaf)
        logits = self._forward_decode(tokens, positions, n_valid)
        acc = torch.argmax(logits, dim=-1).to(torch.int32)       # (n, S)
        acc[:, 0] = sampling.sample_tokens(
            logits[:, 0], self._dev(plan.temperatures, torch.float32),
            self._gen, any_temp=bool((plan.temperatures > 0).any()))
        cols = torch.arange(S, device=self.device)
        # draft i + 1 is accepted iff it was fed and equals committed
        # token i
        match = ((acc[:, :-1].long() == tokens[:, 1:])
                 & (cols[None, :-1] + 1 < n_valid[:, None]))
        n_match = torch.cumprod(match.to(torch.int32), dim=1).sum(dim=1)
        n_accept = torch.where(n_valid > 0, n_match + 1,
                               torch.zeros_like(n_match)).to(torch.int32)
        if self._snapshot:
            for leaf, buf in self._snapshot:
                leaf.copy_(buf)
            self._forward_decode(tokens, positions, n_accept)
        else:
            self.model.adjust_cache_counters(self.cache, n_valid - n_accept)
        slots = [s for s in range(self.n_slots)
                 if plan.token_src[s] and plan.out_idx[s] < self.max_len]
        if slots:
            sl = self._dev(slots, torch.long)
            cols_h = plan.out_idx[slots][:, None] + np.arange(S)[None]
            rows = self._dev(self._slot_row[slots], torch.long)[:, None]
            rows = rows.expand(-1, S)
            # a dropped column's target is (out_idx + c) % max_len, distinct
            # from the row's other columns, and gets its old value back
            wcols = self._dev(cols_h % self.max_len, torch.long)
            keep = ((cols[None] < n_accept[sl][:, None])
                    & self._dev(cols_h < self.max_len, torch.bool))
            old = self._out_buf[rows, wcols]
            self._out_buf.index_put_((rows, wcols),
                                     torch.where(keep, acc[sl], old))
            last = (n_accept[sl] - 1).clamp_min(0).long()[:, None]
            self._prev_sampled.index_put_((sl,),
                                          acc[sl].gather(1, last)[:, 0])
        return n_accept, acc

    def _prefill_row(self, pf) -> torch.Tensor:
        """One prefill chunk's batch-1 forward on its slot's row; returns
        the (1,) sample of its last valid column (it only commits when
        the chunk completes the prompt)."""
        slot = pf.slot - self._slot_lo
        row = self.model.cache_row(self.cache, slot)
        with self._ctx():
            logits, row = self.model.forward(
                self.params, self._dev(pf.tokens, torch.long),
                self._dev(pf.positions, torch.long), mode="decode",
                cache=row, n_valid=self._dev(pf.n_valid, torch.int32),
                paged=self._paged_state(None))
        self.model.set_cache_row(self.cache, slot, row)
        last_col = max(int(pf.n_valid[0]) - 1, 0)
        return sampling.sample_tokens(
            logits[:, last_col],
            torch.full((1,), pf.temperature, dtype=torch.float32,
                       device=self.device),
            self._gen, any_temp=pf.temperature > 0)

    def _prefill_rows(self, plan: StepPlan) -> None:
        """The plan's prefill rows.  Under a mesh each runs on the ranks
        of its slot's shard, and the samples are summed over the slot
        shards (every other rank adds 0) before they are committed."""
        if not plan.prefills:
            return
        nxt = torch.zeros((len(plan.prefills),), dtype=torch.int32,
                          device=self.device)
        for i, pf in enumerate(plan.prefills):
            if self._owns(pf.slot):
                nxt[i:i + 1] = self._prefill_row(pf)
            self.stats.forwards += 1
        if self.mesh is not None:
            nxt = collectives.all_reduce_sum(nxt, self._batch_axes,
                                             self.mesh)
        for i, pf in enumerate(plan.prefills):
            if pf.out_idx < self.max_len:
                self._commit_samples(nxt, [pf.slot], [i], [int(pf.out_idx)])

    def _admit(self, plan: StepPlan) -> None:
        """Three-phase (re-)admission of the plan's reset slots: zero the
        cold slots, copy each prefix hit's K/V from its donor slot (a hit
        slot is not zeroed first: the copy writes or zeros every K/V
        entry itself, and the donor may be the same slot), then install
        each request's read-only context (the cross K/V; audio runs its
        encoder here), after the copy.  The scheduler never lets a plan
        claim a donor row, so zeroing before copying destroys none."""
        zero_mask = plan.reset_mask.copy()
        prefix_installs = []
        for slot in np.nonzero(plan.reset_mask)[0]:
            req = self.sched.active.get(int(slot))
            if req is not None and req.prefix_len > 0:
                zero_mask[slot] = False
                prefix_installs.append((int(req.prefix_src), int(slot),
                                        int(req.prefix_len)))
        lo, n = self._slot_lo, self._n_local
        local_zero = zero_mask[lo:lo + n]
        if local_zero.any():
            self.model.reset_cache_slots(
                self.cache, self._dev(local_zero, torch.bool))
        for src, dst, n_tok in prefix_installs:
            # a donor and its admitted slot share a slot shard
            if self._owns(dst):
                self.model.install_cache_prefix(self.cache, src - lo,
                                                dst - lo, n_tok,
                                                kv_offset=self._kv_offset)
        for slot in np.nonzero(plan.reset_mask)[0]:
            req = self.sched.active.get(int(slot))
            if req is not None and req.extra:
                self.model.install_slot_context(
                    self.params, self.cache, int(slot), req.extra)

    def step(self) -> bool:
        """Run one engine iteration; False when no work remains."""
        wall_feedback = (self.sched.chunk_policy == "stall_free"
                         and self.step_feedback == "wall")
        if wall_feedback and self.device.type != "cuda":
            raise RuntimeError(
                "chunk_policy='stall_free' sizes its chunks from each "
                "step's time, and nothing is timed off the card: on "
                f"{self.device} serve through OpenLoopFrontend(engine, "
                "clock=\"model\"), which feeds modeled step times")
        plan = (self.sched.next_plan(self._step_idx,
                                     drafts=self._propose_drafts())
                if self.spec_decode
                else self.sched.next_plan(self._step_idx))
        if plan is None:
            self.last_plan = None
            self.last_sampled_rids = []
            self.last_admitted_rids = []
            return self.sched.has_work()
        events = _events(self.device)
        for slot in np.nonzero(plan.reset_mask)[0]:
            # a request enters this slot: give it a fresh output row (a
            # still-mapped old row can only be a preemption orphan)
            old = int(self._slot_row[slot])
            if old >= 0:
                self._free_rows.append(old)
            if not self._free_rows:
                self._flush_results()
            self._slot_row[slot] = self._free_rows.pop()
        if plan.reset_mask.any():
            self._admit(plan)
        verify = None
        if plan.n_decode:
            if self.spec_decode and (plan.n_valid > 1).any():
                verify = self._verify_step(plan)
            else:
                self._decode_step(plan)
        self._prefill_rows(plan)
        # which requests sampled a token this step and which were first
        # scheduled, recorded before the commit while the slot -> rid map
        # is live (a slot admitted and preempted within this same plan is
        # in reset_mask but no longer active)
        self.last_plan = plan
        self.last_sampled_rids = [
            (slot, self.sched.active[slot].rid)
            for slot in plan.sample_slots if slot in self.sched.active]
        self.last_admitted_rids = [
            self.sched.active[int(s)].rid
            for s in np.nonzero(plan.reset_mask)[0]
            if int(s) in self.sched.active]
        row_reqs = {slot: self.sched.active[slot]
                    for slot in plan.sample_slots}
        if verify is not None:
            done = self._commit_verify(plan, row_reqs, *verify)
        else:
            # EOS detection is the only per-step host sync of a plain step
            sampled = (self._prev_sampled.cpu().numpy()
                       if self.sched.eos_id is not None else None)
            done = self.sched.commit(plan, sampled, self._step_idx)
            if self.spec_decode:
                self._mark_stale(row_reqs)
        for req in done:
            # tokens stay on device until the next flush point; the row
            # moves from the slot to the pending map
            self._pending.append(req)
            self._pending_rows[req.rid] = int(self._slot_row[req.finish_slot])
            self._slot_row[req.finish_slot] = -1
        fl, by = self._cost.step_cost(plan.n_decode, plan.n_prefill_tokens)
        self.stats.model_flops += fl
        self.stats.model_bytes += by
        _record(self.stats, events, n_decode=plan.n_decode,
                n_prefill_tokens=plan.n_prefill_tokens,
                occupancy=self.kv.occupancy(),
                page_utilization=self.kv.page_utilization(),
                verify=verify is not None)
        if wall_feedback:
            # the stall-free policy's per-token estimate: this step's
            # events, read now (one sync a step)
            self.sched.note_step_wall(
                self.stats.steps[-1].device_ms() / 1e3,
                plan.n_decode + plan.n_prefill_tokens)
        # count only useful tokens: samples a preemption throws away
        # come back off the total
        discarded = self.sched.discarded_tokens - self._seen_discarded
        self._seen_discarded = self.sched.discarded_tokens
        committed = (sum(self.sched.last_commit_counts.values())
                     if self.spec_decode else len(plan.sample_slots))
        self.stats.generated_tokens += committed - discarded
        self.stats.prefix_hit_tokens = self.sched.prefix_hit_tokens
        self._step_idx += 1
        if self.checker is not None:
            self.checker.check_step()
        return self.sched.has_work()

    # -- speculative decoding ------------------------------------------
    def _drafter_throttle(self) -> Dict[str, object]:
        """The drafter's throttle, by family: a recurrent family (ssm,
        hybrid) runs a verify forward twice, so a rejected draft costs it
        about twice what it costs a token-addressable one; it gets a
        higher acceptance floor and sparser probes."""
        if self.model.decode_state.token_addressable:
            return {}
        return dict(accept_floor=0.6, probe_every=32, min_trials=2)

    def _propose_drafts(self) -> Dict[int, np.ndarray]:
        """Drafts for every greedy decoding slot whose request the
        throttle lets propose; a rid left stale by fast-path steps is
        first resynced from ``out_buf`` (a host read of its row)."""
        drafts: Dict[int, np.ndarray] = {}
        for slot, req in self.sched.active.items():
            if (req.state is RequestState.DECODING
                    and req.temperature == 0):
                if self.drafter.throttled(req.rid, self._step_idx):
                    continue
                if req.rid in self._draft_stale:
                    row = int(self._slot_row[slot])
                    toks = self._out_buf[row, :req.n_generated].cpu().numpy()
                    self.drafter.commit(req.rid, req.n_generated, toks)
                    self._draft_stale.discard(req.rid)
                d = self.drafter.propose(req.rid)
                if len(d):
                    drafts[slot] = d
        return drafts

    def _mark_stale(self, row_reqs: Dict[int, Request]) -> None:
        """After a step that read nothing back (the no-draft fast path,
        a prefill-only step; one token a sampled row): drop finished
        requests from the drafter, mark the others' histories stale."""
        for req in row_reqs.values():
            if req.finish_reason:
                self.drafter.drop(req.rid)
                self._draft_stale.discard(req.rid)
            else:
                self._draft_stale.add(req.rid)

    def _commit_verify(self, plan: StepPlan, row_reqs: Dict[int, Request],
                       n_accept: torch.Tensor,
                       acc: torch.Tensor) -> List[Request]:
        """Commit a verify step: one host read of the accepted counts,
        the accepted tokens and ``prev_sampled`` (the drafter needs the
        values; a prefill-completing row's one sample is in
        ``prev_sampled``), the scheduler's variable commit, then the
        drafter's bookkeeping and the draft counters."""
        host = torch.cat([n_accept[:, None], acc,
                          self._prev_sampled[:, None]], dim=1).cpu().numpy()
        n_acc, acc_h, prev = host[:, 0], host[:, 1:-1], host[:, -1]
        accepted = {
            slot: (acc_h[slot, :max(1, int(n_acc[slot]))].copy()
                   if plan.token_src[slot] else prev[slot:slot + 1].copy())
            for slot in plan.sample_slots}
        done = self.sched.commit(
            plan, prev if self.sched.eos_id is not None else None,
            self._step_idx, accepted=accepted)
        drafted = accepted_draft = 0
        for slot in plan.sample_slots:
            req = row_reqs[slot]
            if plan.token_src[slot]:
                d = int(plan.n_valid[slot]) - 1
                a = self.sched.last_commit_counts[slot] - 1
                drafted += d
                accepted_draft += a
                # acceptance feedback drives the drafter's throttle
                self.drafter.feedback(req.rid, d, a)
            if req.finish_reason:
                self.drafter.drop(req.rid)
                self._draft_stale.discard(req.rid)
            elif req.rid not in self._draft_stale:
                # a stale history would get a gap: it stays stale and
                # resyncs in full from out_buf when it next proposes
                self.drafter.commit(req.rid, req.n_generated,
                                    accepted[slot])
        self.stats.drafted_tokens += drafted
        self.stats.accepted_draft_tokens += accepted_draft
        return done

    # -- API ------------------------------------------------------------
    def reset(self) -> None:
        """Clear every piece of serving state (queue, slots, cache,
        output rows, stats, results) but keep the built model, its
        weights and the kernels' call tables, e.g. to run a workload
        again.  The cache and the buffers are zeroed in place and the
        sampler reseeded."""
        self.kv = PagedKVCache(self.n_slots, self.max_len,
                               self.kv.page_size,
                               page_budget=self.kv.page_budget,
                               slot_aux_tokens=self.kv.slot_aux_tokens,
                               prefix_pool=self.kv.prefix_pool,
                               n_shards=self.n_shards)
        self.sched = Scheduler(self.kv,
                               prefill_chunk=self.sched.prefill_chunk,
                               eos_id=self.sched.eos_id,
                               chunk_policy=self.sched.chunk_policy,
                               tbt_target_s=self.sched.tbt_target_s,
                               spec_k=self.spec_k)
        if self.drafter is not None:
            self.drafter = NGramDrafter(self.spec_k,
                                        **self._drafter_throttle())
            self._draft_stale = set()
        if self.check:
            self.checker = SchedChecker.attach(self.kv, self.sched)
        self.model.reset_cache_slots(
            self.cache, torch.ones((self._n_local,), dtype=torch.bool,
                                   device=self.device))
        self._out_buf.zero_()
        self._prev_sampled.zero_()
        self._gen.manual_seed(self._seed)
        self._free_rows = list(range(self._n_out_rows))
        self._slot_row = np.full((self.n_slots,), -1, np.int32)
        self._pending = []
        self._pending_rows = {}
        self._step_idx = 0
        self._seen_discarded = 0
        self.stats = EngineStats()
        self._results = {}
        self.last_plan = None
        self.last_sampled_rids = []
        self.last_admitted_rids = []

    def submit(self, prompt: Sequence[int], max_new_tokens: int, *,
               temperature: float = 0.0,
               extra: Optional[Dict[str, np.ndarray]] = None) -> int:
        """Queue a request; returns its rid.  ``extra`` carries the
        request's read-only context — (T, d) or (1, T, d) arrays:
        ``image_embeds`` (vlm), ``audio_frames`` (audio) — which the
        cross-attention families require and the others refuse."""
        need = self.model.decode_state.requires_extra
        missing = [k for k in need if extra is None or k not in extra]
        if missing:
            raise ValueError(
                f"family {self.model.cfg.family!r} requires extra "
                f"context {missing} at submit()")
        unknown = [k for k in (extra or {}) if k not in need]
        if unknown:
            raise ValueError(
                f"family {self.model.cfg.family!r} takes no extra "
                f"context {unknown}; it requires exactly {list(need)}")
        if extra is not None:
            # batch-1 host arrays, the shape rule the install shares
            extra = {k: decode_state.ensure_request_context(np.asarray(v))
                     for k, v in extra.items()}
        req = self.sched.submit(np.asarray(prompt), max_new_tokens,
                                temperature=temperature, extra=extra,
                                step=self._step_idx)
        if self.drafter is not None:
            self.drafter.add_request(req.rid, req.prompt)
        return req.rid

    def _flush_results(self) -> None:
        """Materialize finished requests' tokens (one buffer transfer)
        and recycle their output rows."""
        if not self._pending:
            return
        buf = self._out_buf.cpu().numpy()
        for req in self._pending:
            row = self._pending_rows.pop(req.rid)
            toks = buf[row, :req.n_generated].copy()
            req.generated = toks.tolist()
            self._results[req.rid] = toks
            self._free_rows.append(row)
        self._pending = []

    def run(self, max_steps: Optional[int] = None) -> Dict[int, np.ndarray]:
        """Drain the queue; returns {rid: generated tokens}."""
        n, stalled = 0, 0
        while True:
            before = self._step_idx
            if not self.step():
                break
            n += 1
            if max_steps is not None and n >= max_steps:
                break
            # a planless iteration with work remaining means nothing can
            # proceed (e.g. a page budget too small for one request)
            stalled = stalled + 1 if self._step_idx == before else 0
            if stalled > self.n_slots + 2:
                raise RuntimeError(
                    "scheduler stalled: work queued but no step can run "
                    "(page budget too small for an in-flight request?)")
        self._flush_results()
        if self.checker is not None:
            self.checker.check_drain()
        return dict(self._results)

    def results(self) -> Dict[int, np.ndarray]:
        """Flush and return every finished request's tokens so far
        ({rid: np.ndarray}) without a full drain."""
        self._flush_results()
        return dict(self._results)

    def modeled_step_time(self, n_decode: int,
                          n_prefill_tokens: int) -> float:
        """Analytic seconds for one step of this composition: the cost
        model's flops and bytes against ``self.hw``, the larger of
        flops over the peak rate of the model's compute dtype and bytes
        over the memory rate (the roofline bound time).  The open-loop
        front end's ``clock="model"`` advances by it; it is a model
        number, never a measured time."""
        flops, bytes_ = self._cost.step_cost(n_decode, n_prefill_tokens)
        peak = self.hw.peak_flops(dtype_of(self.model.cfg.compute_dtype))
        return max(flops / peak, bytes_ / self.hw.hbm_bw)

    @property
    def check_findings(self) -> List[Finding]:
        """The shadow checker's findings so far ([] when ``check`` is
        off)."""
        return [] if self.checker is None else list(self.checker.findings)

    def requests(self) -> List[Request]:
        return list(self.sched.finished)

    def generate(self, prompt_tokens, n_steps: int,
                 extra: Optional[Dict[str, object]] = None) -> torch.Tensor:
        """Submit a (B, S) batch of prompts greedily, ``n_steps`` new
        tokens each, and drain: the fixed-batch calling convention served
        by the continuous engine.  ``extra`` is the static engine's
        batched (B, T, d) context, split here into one a request.
        Returns (B, n_steps) int32 tokens on the model's device."""
        prompts = _host(prompt_tokens)
        ctx = None if extra is None else {k: _host(v)
                                          for k, v in extra.items()}
        rids = [self.submit(
            p, n_steps,
            extra=None if ctx is None else {k: v[i] for k, v in ctx.items()})
            for i, p in enumerate(prompts)]
        results = self.run()
        return torch.as_tensor(np.stack([results[r] for r in rids]),
                               device=self.device)


def _check_meshable(model: LM, mesh, spec_decode: bool,
                    chunk_policy: str) -> None:
    """Raise ``NotImplementedError`` for what is not served under a mesh
    yet (ROADMAP A10)."""
    if not isinstance(mesh, Mesh):
        raise NotImplementedError(
            f"mesh={mesh!r}: the port serves over a repro_torch.launch.mesh."
            f"Mesh of torch.distributed ranks (launch.mesh.parse_mesh / "
            f"make_mesh), not another kind of mesh")
    what = []
    if model.cfg.family not in MESH_FAMILIES:
        what.append(f"the {model.cfg.family} family (ROADMAP A10, item 6 "
                    f"left 1: the vlm and audio families, their cross K/V "
                    f"on the slot's shard)")
    if spec_decode:
        what.append("speculative decoding")
    if chunk_policy != "fixed":
        what.append(f"chunk_policy={chunk_policy!r}")
    if what:
        raise NotImplementedError(
            f"{', '.join(what)} under a mesh: not ported yet (ROADMAP A10: "
            f"sharded serving covers the closed-loop engine of the "
            f"{', '.join(MESH_FAMILIES)} families)")


def _host(a) -> np.ndarray:
    """A host array of ``a`` (a tensor on any device, or array-like)."""
    if isinstance(a, torch.Tensor):
        return a.detach().cpu().numpy()
    return np.asarray(a)


# ---------------------------------------------------------------------------
# fixed-batch baseline
# ---------------------------------------------------------------------------
class StaticBatchEngine:
    """Run-to-completion fixed-batch engine: one prefill + a decode loop.

    The reference's baseline, kept for correctness (temperature-0 parity
    with the continuous engine) and throughput comparison.  The prefill
    is ``LM.forward(mode="prefill")`` over every prompt at once: in an
    attention layer causal attention that fills the layer's K/V cache, in
    a mamba layer the SSD kernel, one launch a layer.  The decode steps
    run in no paged context: attention layers attend over the cache
    through the flash-decode kernel, one launch a layer.  ``stats.steps``
    holds the prefill as its first record and then one record a decode
    step, timed by CUDA events on the card.
    """

    def __init__(self, model: LM, params, max_len: int, batch: int, *,
                 sample_temperature: float = 0.0):
        self.model = model
        self.params = params
        self.max_len = max_len
        self.batch = batch
        self.device = model.device
        gen = torch.Generator(device=self.device)
        gen.manual_seed(0)
        self.prefill_fn = make_prefill_step(model)
        self.decode_fn = make_serve_step(
            model, sample_temperature=sample_temperature, generator=gen)
        self._cost = StepCostModel(model.cfg, max_len)
        self.stats = EngineStats()

    def generate(self, prompt_tokens, n_steps: int,
                 extra: Optional[Dict[str, object]] = None) -> torch.Tensor:
        """prompt_tokens (B, S) -> (B, n_steps) int32 tokens, on the
        model's device.  ``extra``: a cross-attention family's batched
        (B, T, d) context (arrays or tensors)."""
        toks = torch.as_tensor(np.asarray(prompt_tokens), dtype=torch.long,
                               device=self.device)
        B, S = toks.shape
        if B != self.batch:
            raise ValueError(f"batch {B} != the engine's {self.batch}")
        if extra is not None:
            extra = {k: torch.as_tensor(v, device=self.device)
                     for k, v in extra.items()}
        cache = self.model.init_cache(B, self.max_len)
        positions = torch.arange(S, device=self.device)[None].expand(B, S)
        events = _events(self.device)
        nxt, cache = self.prefill_fn(self.params, cache, toks, positions,
                                     extra)
        _record(self.stats, events, n_decode=0, n_prefill_tokens=B * S)
        out = [nxt]
        for t in range(n_steps - 1):
            events = _events(self.device)
            pos = torch.full((B, 1), S + t, dtype=torch.long,
                             device=self.device)
            nxt, cache = self.decode_fn(self.params, cache,
                                        nxt[:, None].long(), pos)
            _record(self.stats, events, n_decode=B, n_prefill_tokens=0)
            out.append(nxt)
        fl, by = self._cost.step_cost(0, B * S)              # prefill
        dfl, dby = self._cost.step_cost(B, 0)                # one decode step
        self.stats.model_flops += fl + (n_steps - 1) * dfl
        self.stats.model_bytes += by + (n_steps - 1) * dby
        self.stats.forwards += n_steps
        self.stats.generated_tokens += B * n_steps
        return torch.stack(out, dim=1)
