"""The card's ceilings and the analytic cost model: the counterpart of
``repro.core.costmodel``.

``HWSpec`` describes the card: its rates, and the on-chip budget a
block is held to (SMs, shared memory and registers, CUDA's occupancy
limits for compute capability 9.0), which ``core.autotune`` prices a
tile against.  Every rate is NVIDIA's published figure for the part
(the H100 data sheet, dense rates without sparsity) at the card's full
power limit; a card set below its limit runs slower under
load, so a result that uses these rates names the card and its power
limit beside them.

The analytic half (``ImplOpts``, the per-component FLOPs,
``forward_flops``, ``step_flops``, ``model_flops``, ``param_bytes``,
``step_hbm_bytes``, ``_cache_bytes``) is a verbatim copy of the
reference's: it counts what the reference's implementation does, from
the config's shapes and ``ModelConfig.param_counts``, so a step priced
here costs what it costs there.  The serving engine prices its steps
with it (``serve.engine.StepCostModel``).  Two known gaps, both the
reference's: the parameter count's miscounts (ROADMAP R7: the vlm
+3.4%, whisper -6.5%), and a prefill priced per token as a share of one
whole ``max_len`` prefill, where the port's continuous engine runs each
chunk as its own batch-1 forward that reads every weight again.
``roofline_terms`` prices collectives over TPU links and waits for the
device mesh (ROADMAP A10).
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.configs.shapes import ShapeSpec


@dataclasses.dataclass(frozen=True)
class HWSpec:
    name: str
    hbm_bw: float                  # device memory, bytes/s
    l2_bytes: float
    peak_flops_bf16: float         # tensor cores, dense
    peak_flops_tf32: float         # tensor cores, dense
    peak_flops_fp32: float         # CUDA cores (no tensor-core fp32 path)
    peak_flops_fp64: float         # fp64 tensor cores
    # the on-chip budget (CUDA's occupancy limits for compute capability
    # 9.0): what ``core.autotune.predict`` prices a tile against, in
    # place of the TPU's VMEM
    sm_count: int = 132
    smem_per_sm: int = 233472      # 228 KiB of shared memory an SM
    smem_per_block: int = 232448   # 227 KiB a block may take (opt-in)
    smem_reserved_per_block: int = 1024   # what the card keeps a block
    regs_per_sm: int = 65536       # 32-bit registers
    regs_per_thread: int = 255     # past this the compiler spills
    threads_per_sm: int = 2048
    blocks_per_sm: int = 32

    def peak_flops(self, dtype: torch.dtype) -> float:
        """The dense peak for arithmetic done in ``dtype`` without TF32:
        fp32 is the CUDA-core rate, fp64 the fp64 tensor-core rate."""
        if dtype in (torch.bfloat16, torch.float16):
            return self.peak_flops_bf16
        if dtype == torch.float32:
            return self.peak_flops_fp32
        if dtype == torch.float64:
            return self.peak_flops_fp64
        raise ValueError(f"no peak rate for {dtype}")

    def bound_s(self, flops: float, nbytes: float,
                dtype: torch.dtype) -> Tuple[float, str]:
        """Least time for work of ``flops`` operations in ``dtype`` that
        must move ``nbytes`` through device memory: the larger of the two
        times, and which of them it is ("bytes" or "operations")."""
        t_bytes = nbytes / self.hbm_bw
        t_ops = flops / self.peak_flops(dtype)
        return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                     else "operations")


H100_SXM = HWSpec(name="h100_sxm", hbm_bw=3.35e12, l2_bytes=50e6,
                  peak_flops_bf16=989e12, peak_flops_tf32=495e12,
                  peak_flops_fp32=67e12, peak_flops_fp64=67e12)
H100_PCIE = HWSpec(name="h100_pcie", hbm_bw=2.0e12, l2_bytes=50e6,
                   peak_flops_bf16=756e12, peak_flops_tf32=378e12,
                   peak_flops_fp32=51e12, peak_flops_fp64=51e12,
                   sm_count=114)
H100_NVL = HWSpec(name="h100_nvl", hbm_bw=3.9e12, l2_bytes=50e6,
                  peak_flops_bf16=835e12, peak_flops_tf32=418e12,
                  peak_flops_fp32=60e12, peak_flops_fp64=60e12)


def hw_for(card_name: str) -> HWSpec:
    """The variant a card's name describes (``torch.cuda.get_device_name``
    or nvidia-smi's name): PCIe and NVL say so in their names; the SXM
    part ("NVIDIA H100 80GB HBM3") does not."""
    if "PCIe" in card_name:
        return H100_PCIE
    if "NVL" in card_name:
        return H100_NVL
    return H100_SXM


def hw_of(device: torch.device, hw: Optional[HWSpec] = None) -> HWSpec:
    """``hw`` if given, else the spec of the card ``device`` is on; a CPU
    device (where only the tests run, and nothing is timed) gets the SXM
    part's spec."""
    if hw is not None:
        return hw
    if device.type == "cuda":
        return hw_for(torch.cuda.get_device_name(device))
    return H100_SXM


@dataclasses.dataclass(frozen=True)
class ImplOpts:
    block_causal: bool = True      # skip non-causal attention chunks
    remat: str = "full"            # none | full | dots
    fused_xent: bool = False
    microbatches: int = 1


# ---------------------------------------------------------------------------
# per-component forward FLOPs (for T tokens, batch folded in)
# ---------------------------------------------------------------------------
def _attn_proj_flops(cfg: ModelConfig, T: int) -> float:
    d, h = cfg.d_model, cfg.resolved_head_dim
    return 2.0 * T * d * (cfg.n_heads * h * 2 + cfg.n_kv_heads * h * 2)


def _attn_score_flops(cfg: ModelConfig, T: int, S_kv: float,
                      causal_frac: float) -> float:
    h = cfg.resolved_head_dim
    # scores (QK^T) + AV, both 2*T*S*nq*h
    return 2.0 * (2.0 * T * S_kv * cfg.n_heads * h) * causal_frac


def _mlp_flops(cfg: ModelConfig, T: int) -> float:
    n_mats = 2 if cfg.mlp_type == "gelu" else 3
    return 2.0 * T * cfg.d_model * cfg.d_ff * n_mats


def _moe_flops(cfg: ModelConfig, T: int) -> float:
    m = cfg.moe
    router = 2.0 * T * cfg.d_model * m.num_experts
    # capacity-padded expert compute (cf > 1 is wasted-but-executed work)
    t_eff = T * m.top_k * m.capacity_factor
    experts = 2.0 * t_eff * cfg.d_model * m.expert_d_ff * 3
    return router + experts


def _mamba_flops(cfg: ModelConfig, T: int) -> float:
    s = cfg.ssm
    d = cfg.d_model
    di = s.expand * d
    nh = di // s.head_dim
    gn = s.ngroups * s.d_state
    proj = 2.0 * T * d * (2 * di + 2 * gn + nh) + 2.0 * T * di * d
    conv = 2.0 * T * (di + 2 * gn) * s.conv_kernel
    L = s.chunk_size
    # SSD: intra-chunk (C B^T: T*L*n; W·x: T*L*di) + states/y_inter (4*T*n*di)
    ssd = 2.0 * T * L * gn + 2.0 * T * L * di + 4.0 * T * gn * di
    return proj + conv + ssd


def _cross_attn_flops(cfg: ModelConfig, T: int, T_ctx: int) -> float:
    d, h = cfg.d_model, cfg.resolved_head_dim
    proj = 2.0 * T * d * cfg.n_heads * h * 2 + 2.0 * T_ctx * d * cfg.n_kv_heads * h * 2
    scores = 2.0 * (2.0 * T * T_ctx * cfg.n_heads * h)
    return proj + scores


def forward_flops(cfg: ModelConfig, batch: int, seq: int,
                  opts: ImplOpts = ImplOpts(),
                  kv_len: Optional[int] = None,
                  decode: bool = False,
                  include_encoder: bool = True) -> Dict[str, float]:
    """FLOPs of one forward pass over (batch, seq) tokens.

    decode=True: attention reads a KV cache of ``kv_len`` (no S^2 term).
    include_encoder=False drops the enc-dec audio-encoder stack — for
    *per-decoded-token* costing, where the encoder runs once per request
    at admission (serve install_context), not once per token; the decode
    cross-attention reads of the cached encoder K/V are still counted.
    """
    T = float(batch * seq)
    comp: Dict[str, float] = {"attn_proj": 0, "attn_score": 0, "mlp": 0,
                              "moe": 0, "mamba": 0, "cross": 0, "unembed": 0}
    causal_frac = 0.55 if opts.block_causal else 1.0   # block-granular skip

    for i in range(cfg.n_layers):
        kind = cfg.layer_kind(i)
        if kind == "attn":
            comp["attn_proj"] += _attn_proj_flops(cfg, T)
            if decode:
                comp["attn_score"] += _attn_score_flops(
                    cfg, T, float(kv_len), 1.0)
            else:
                comp["attn_score"] += _attn_score_flops(
                    cfg, T, float(seq), causal_frac)
        else:
            comp["mamba"] += _mamba_flops(cfg, T)
        if cfg.cross_attn_period and (i % cfg.cross_attn_period) == (
                cfg.cross_attn_period - 1):
            comp["cross"] += _cross_attn_flops(cfg, T, cfg.num_image_tokens)
        if kind == "attn" or cfg.d_ff > 0 or cfg.layer_uses_moe(i):
            if cfg.layer_uses_moe(i):
                comp["moe"] += _moe_flops(cfg, T)
            elif cfg.d_ff > 0:
                comp["mlp"] += _mlp_flops(cfg, T)

    if cfg.is_encdec:
        if include_encoder:
            T_enc = float(batch * cfg.n_audio_ctx)
            for _ in range(cfg.n_encoder_layers):
                comp["attn_proj"] += _attn_proj_flops(cfg, T_enc)
                comp["attn_score"] += _attn_score_flops(
                    cfg, T_enc, float(cfg.n_audio_ctx), 1.0)
                comp["mlp"] += _mlp_flops(cfg, T_enc)
        if not decode:
            for i in range(cfg.n_layers):
                comp["cross"] += _cross_attn_flops(cfg, T, cfg.n_audio_ctx)
        else:
            # decode cross-attn reads cached enc K/V
            d, h = cfg.d_model, cfg.resolved_head_dim
            comp["cross"] += cfg.n_layers * (
                2.0 * T * d * cfg.n_heads * h * 2
                + 4.0 * T * cfg.n_audio_ctx * cfg.n_heads * h)

    comp["unembed"] = 2.0 * T * cfg.d_model * cfg.padded_vocab
    comp["total"] = sum(v for k, v in comp.items() if k != "total")
    return comp


def step_flops(cfg: ModelConfig, shape: ShapeSpec,
               opts: ImplOpts = ImplOpts()) -> Dict[str, float]:
    """FLOPs of the actual lowered step for an (arch, shape) cell."""
    if shape.kind == "train":
        fwd = forward_flops(cfg, shape.global_batch, shape.seq_len, opts)
        # bwd ≈ 2x fwd; full remat recomputes the stack fwd once more
        # (save_blocks recomputes the same matmuls — only collectives skip)
        mult = 3.0 + (1.0 if opts.remat in ("full", "save_blocks") else 0.0)
        out = {k: v * mult for k, v in fwd.items()}
        out["fwd_only"] = fwd["total"]
        return out
    if shape.kind == "prefill":
        return forward_flops(cfg, shape.global_batch, shape.seq_len, opts)
    # decode: one token against a cache of seq_len
    return forward_flops(cfg, shape.global_batch, 1, opts,
                         kv_len=shape.seq_len, decode=True)


def model_flops(cfg: ModelConfig, shape: ShapeSpec) -> float:
    """The 6·N·D (train) / 2·N·D (inference) reference."""
    total, active = cfg.param_counts()
    if shape.kind == "train":
        return 6.0 * active * shape.global_batch * shape.seq_len
    if shape.kind == "prefill":
        return 2.0 * active * shape.global_batch * shape.seq_len
    return 2.0 * active * shape.global_batch  # one token per sequence


# ---------------------------------------------------------------------------
# analytic HBM traffic (per step, global bytes)
# ---------------------------------------------------------------------------
def param_bytes(cfg: ModelConfig) -> float:
    total, _ = cfg.param_counts()
    return float(total) * {"float32": 4, "bfloat16": 2}[cfg.param_dtype]


def step_hbm_bytes(cfg: ModelConfig, shape: ShapeSpec,
                   opts: ImplOpts = ImplOpts()) -> Dict[str, float]:
    total, _ = cfg.param_counts()
    p_bytes = param_bytes(cfg)
    T = float(shape.global_batch * shape.seq_len)
    d = cfg.d_model
    act_unit = T * d * 2.0   # one (T, d) activation in bf16

    if shape.kind == "train":
        # params read fwd+bwd (+remat) + write; fp32 m/v read+write; f32 grads
        remat_extra = 1 if opts.remat == "full" else 0
        params_traffic = p_bytes * (2 + remat_extra + 1)
        opt_traffic = total * 4.0 * 4     # m,v read+write
        grad_traffic = total * 4.0 * 2
        # activations: ~per layer a handful of (T,d)-sized tensors both ways
        act_traffic = act_unit * cfg.n_layers * 8
        tot = params_traffic + opt_traffic + grad_traffic + act_traffic
        return {"params": params_traffic, "opt": opt_traffic,
                "grads": grad_traffic, "activations": act_traffic,
                "total": tot}

    if shape.kind == "prefill":
        act_traffic = act_unit * cfg.n_layers * 6
        cache_w = _cache_bytes(cfg, shape.global_batch, shape.seq_len)
        return {"params": p_bytes, "activations": act_traffic,
                "cache": cache_w, "total": p_bytes + act_traffic + cache_w}

    # decode: read all (active) params once + read the whole cache + tiny acts
    cache_rw = _cache_bytes(cfg, shape.global_batch, shape.seq_len)
    _, active = cfg.param_counts()
    active_bytes = float(active) * {"float32": 4, "bfloat16": 2}[cfg.param_dtype]
    return {"params": active_bytes, "cache": cache_rw,
            "total": active_bytes + cache_rw}


def _cache_bytes(cfg: ModelConfig, batch: int, seq: int) -> float:
    h = cfg.resolved_head_dim
    per_layer_attn = 2.0 * batch * seq * cfg.n_kv_heads * h * 2  # bf16 k+v
    n_attn = sum(1 for i in range(cfg.n_layers) if cfg.layer_kind(i) == "attn")
    n_mamba = cfg.n_layers - n_attn
    ssm_bytes = 0.0
    if cfg.ssm is not None and n_mamba:
        s = cfg.ssm
        di = s.expand * cfg.d_model
        nh = di // s.head_dim
        ssm_bytes = n_mamba * batch * (
            nh * s.head_dim * s.ngroups * s.d_state * 4.0
            + (s.conv_kernel - 1) * (di + 2 * s.ngroups * s.d_state) * 2.0)
    cross = 0.0
    if cfg.cross_attn_period:
        n_cross = cfg.n_layers // cfg.cross_attn_period
        cross = n_cross * 2.0 * batch * cfg.num_image_tokens * cfg.n_kv_heads * h * 2
    if cfg.is_encdec:
        cross = cfg.n_layers * 2.0 * batch * cfg.n_audio_ctx * cfg.n_kv_heads * h * 2
    return n_attn * per_layer_attn + ssm_bytes + cross
