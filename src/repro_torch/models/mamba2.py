"""Mamba-2 block with SSD (state-space duality) [arXiv:2405.21060].

Counterpart of ``repro.models.mamba2``.  Train and prefill run the
chunked SSD (``kernels.ssd_scan.ops.ssd_chunked``: the CUDA kernel on
the card, its plain version on the CPU); decode runs the O(1) recurrent
update, a Python loop over the step's columns with the row-masked
commit of the DecodeState protocol.  Projection weights are split per
component (z, x, B, C, dt) as in the reference, (d_in, d_out) each.
"""
from __future__ import annotations

import math
from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.kernels.ssd_scan import ops as ssd_ops
from repro_torch.models.layers import Params, _rms_scale, dtype_of
from repro_torch.models.quant import matmul_q


def dims(cfg):
    s = cfg.ssm
    d_inner = s.expand * cfg.d_model
    nheads = d_inner // s.head_dim
    conv_dim = d_inner + 2 * s.ngroups * s.d_state
    return d_inner, nheads, conv_dim


def mamba_specs(cfg) -> Dict:
    """The reference's logical axes of a Mamba-2 mixer's parameters."""
    return {
        "wz": ("embed", "mlp"),
        "wx": ("embed", "mlp"),
        "wB": ("embed", None),
        "wC": ("embed", None),
        "wdt": ("embed", "heads"),
        "out": ("mlp", "embed"),
        "conv_w": (None, None),   # tiny depthwise taps: replicated
        "conv_b": (None,),
        "A_log": ("heads",),
        "D": ("heads",),
        "dt_bias": ("heads",),
        "norm_scale": ("mlp",),
    }


def init_mamba(generator: torch.Generator, cfg, device) -> Params:
    """Random parameters with the reference's initializer scales, drawn
    from ``generator`` (on ``device``).  ``A_log``, ``D`` and ``dt_bias``
    are fp32 whatever the param dtype."""
    s = cfg.ssm
    d = cfg.d_model
    d_inner, nheads, conv_dim = dims(cfg)
    gn = s.ngroups * s.d_state
    dtype = dtype_of(cfg.param_dtype)
    f32 = dict(dtype=torch.float32, device=device)

    def w(shape, scale):
        return (torch.randn(shape, generator=generator, **f32)
                * scale).to(dtype)

    sc = d ** -0.5
    # dt bias initialized so softplus(dt_bias) spans [dt_min, dt_max]
    u = torch.rand((nheads,), generator=generator, **f32)
    dt_init = torch.exp(u * (math.log(s.dt_max) - math.log(s.dt_min))
                        + math.log(s.dt_min))
    dt_bias = dt_init + torch.log(-torch.expm1(-dt_init))  # inverse softplus
    return {
        "wz": w((d, d_inner), sc),
        "wx": w((d, d_inner), sc),
        "wB": w((d, gn), sc),
        "wC": w((d, gn), sc),
        "wdt": w((d, nheads), sc),
        "out": w((d_inner, d), d_inner ** -0.5),
        "conv_w": w((s.conv_kernel, conv_dim), conv_dim ** -0.5),
        "conv_b": torch.zeros((conv_dim,), dtype=dtype, device=device),
        "A_log": torch.log(torch.arange(1, nheads + 1, **f32)),
        "D": torch.ones((nheads,), **f32),
        "dt_bias": dt_bias,
        "norm_scale": torch.ones((d_inner,), dtype=dtype, device=device),
    }


def _causal_depthwise_conv(x: torch.Tensor, w: torch.Tensor,
                           b: torch.Tensor) -> torch.Tensor:
    """x: (B, S, C); w: (k, C) depthwise causal conv + SiLU."""
    k = w.shape[0]
    S = x.shape[1]
    xp = F.pad(x, (0, 0, k - 1, 0))
    out = torch.zeros_like(x)
    for i in range(k):                        # k is tiny (4)
        out = out + xp[:, i:i + S, :] * w[i][None, None, :]
    return F.silu(out + b[None, None, :].to(out.dtype))


def _masked_recurrence(params, xbc, dt, A, state, n_valid, cfg):
    """Decode-mode recurrence over the S step columns with a per-row
    validity mask.  xbc: (B, S, conv_dim) pre-conv; dt: (B, S, h)
    post-softplus; ``state`` {"h": (B, h, p, n) fp32, "conv": (B, k-1,
    conv_dim)}, updated in place.

    Step t rolls the conv window, applies the depthwise taps and takes
    one ``h' = h * exp(dt A) + dt B x`` step, then commits (window, h)
    only for rows with ``t < n_valid[row]``: the other rows keep their
    state bit for bit.  An invalid step still produces a y column (from
    the uncommitted candidate state), which the engine never reads.
    Returns y: (B, S, h, p) fp32."""
    s = cfg.ssm
    Bsz, S, _ = xbc.shape
    d_inner, nheads, _ = dims(cfg)
    n = s.ngroups * s.d_state
    cdt = xbc.dtype
    w = params["conv_w"].to(cdt)                          # (k, conv_dim)
    b = params["conv_b"].to(cdt)
    D = params["D"]
    h, win = state["h"], state["conv"]
    steps = torch.arange(S, device=xbc.device)
    valid = (torch.ones((Bsz, S), dtype=torch.bool, device=xbc.device)
             if n_valid is None else steps[None, :] < n_valid[:, None])
    ys = []
    for t in range(S):
        v_t = valid[:, t]
        window = torch.cat([win, xbc[:, t, None]], dim=1)  # (B, k, c)
        conv = F.silu((window * w[None]).sum(dim=1) + b[None])
        xh_t = conv[:, :d_inner].reshape(Bsz, nheads, s.head_dim).float()
        B_t = conv[:, d_inner:d_inner + n].float()
        C_t = conv[:, d_inner + n:].float()
        dt_t = dt[:, t]
        decay = torch.exp(dt_t * A[None, :])              # (B, h)
        xb = xh_t[..., None] * B_t[:, None, None, :]      # (B, h, p, n)
        h_new = h * decay[:, :, None, None] + dt_t[:, :, None, None] * xb
        y_t = torch.einsum("bn,bhpn->bhp", C_t, h_new)
        ys.append(y_t + xh_t * D[None, :, None])
        # row-masked ragged write: rows past their valid length keep state
        h.copy_(torch.where(v_t[:, None, None, None], h_new, h))
        win.copy_(torch.where(v_t[:, None, None], window[:, 1:], win))
    if not ys:
        return xbc.new_zeros((Bsz, 0, nheads, s.head_dim), dtype=torch.float32)
    return torch.stack(ys, dim=1)


def mamba_forward(params: Params, x: torch.Tensor, cfg,
                  state: Optional[Dict[str, torch.Tensor]] = None,
                  mode: str = "train",
                  n_valid: Optional[torch.Tensor] = None
                  ) -> Tuple[torch.Tensor, Optional[Dict[str, torch.Tensor]]]:
    """x: (B, S, d_model).

    Modes: ``train`` (no state), ``prefill`` (returns the final recurrent
    and conv state for the decode steps that follow), ``decode`` (``state``
    updated in place over the S step columns; ``n_valid`` (B,) the real,
    left-aligned tokens of each row, ``None`` meaning all S).  On the card
    train mode's gradient runs the plain scan again
    (``ssd_ops.SSDChunked``)."""
    s = cfg.ssm
    Bsz, S, _ = x.shape
    d_inner, nheads, _ = dims(cfg)
    n = s.ngroups * s.d_state
    cdt = x.dtype

    z = matmul_q(x, params["wz"])
    xs = matmul_q(x, params["wx"])
    Bp = matmul_q(x, params["wB"])
    Cp = matmul_q(x, params["wC"])
    dt = matmul_q(x, params["wdt"])

    xbc = torch.cat([xs, Bp, Cp], dim=-1)                 # (B, S, conv_dim)
    A = -torch.exp(params["A_log"])                       # (h,) < 0
    dt = F.softplus(dt.float() + params["dt_bias"][None, None, :])

    new_state = None
    if mode != "decode":
        if n_valid is not None:
            raise ValueError("n_valid is a decode-mode (ragged) feature")
        k = s.conv_kernel
        conv_tail = F.pad(xbc, (0, 0, max(k - 1 - S, 0), 0))[:, -(k - 1):]
        xbc = _causal_depthwise_conv(xbc, params["conv_w"].to(cdt),
                                     params["conv_b"])
        xs = xbc[..., :d_inner]
        Bp = xbc[..., d_inner:d_inner + n]
        Cp = xbc[..., d_inner + n:]
        xh = xs.reshape(Bsz, S, nheads, s.head_dim)
        y, h_final = ssd_ops.ssd_chunked(
            xh.float(), dt, A, Bp.float(), Cp.float(), params["D"],
            s.chunk_size)
        if mode == "prefill":
            new_state = {"h": h_final, "conv": conv_tail}
    else:
        y = _masked_recurrence(params, xbc, dt, A, state, n_valid, cfg)
        new_state = state

    y = y.reshape(Bsz, S, d_inner).to(cdt)
    # gated RMSNorm, then the out-projection
    g = y * F.silu(z)
    r = _rms_scale(g, cfg.norm_eps)
    g = g * r.to(cdt) * params["norm_scale"].to(cdt)
    return matmul_q(g, params["out"]), new_state


def init_state(cfg, n_layers: int, batch: int, dtype,
               device) -> Dict[str, torch.Tensor]:
    """Layer-stacked recurrent state: ``h`` (L, B, h, p, n) fp32 and the
    conv window ``conv`` (L, B, k-1, conv_dim) in the compute dtype."""
    s = cfg.ssm
    _, nheads, conv_dim = dims(cfg)
    return {
        "h": torch.zeros((n_layers, batch, nheads, s.head_dim,
                          s.ngroups * s.d_state), dtype=torch.float32,
                         device=device),
        "conv": torch.zeros((n_layers, batch, s.conv_kernel - 1, conv_dim),
                            dtype=dtype, device=device),
    }


def state_specs() -> Dict[str, tuple]:
    return {
        "h": (None, "batch", "heads", None, None),
        "conv": (None, "batch", None, "mlp"),
    }
