"""Mamba-2 block with SSD (state-space duality) [arXiv:2405.21060].

Counterpart of ``repro.models.mamba2``.  Train and prefill run the
chunked SSD (``kernels.ssd_scan.ops.ssd_chunked``: the CUDA kernel on
the card, its plain version on the CPU); decode runs the O(1) recurrent
update, a Python loop over the step's columns with the row-masked
commit of the DecodeState protocol.  Projection weights are split per
component (z, x, B, C, dt) as in the reference, (d_in, d_out) each.

Under a sharding context the decode-mode mixer is rank-local over the
rank's block of ``d_inner`` (``wx``'s columns: ``wz``, ``wx``,
``norm_scale`` and ``out`` are split on the ``mlp`` axis), whose heads
are ``wx.shape[1] // head_dim`` consecutive heads (``_held_heads``).
``wdt``, ``A_log``, ``D`` and ``dt_bias`` (the ``heads`` axis) are the
rank's heads, cut where the rules left them whole; ``wB``, ``wC`` and
the conv taps are whole on every rank.  The rank's conv window holds its
x channels and then B and C whole (``init_state(d_inner=)``), so the
taps of those channels are gathered.  ``rank_mixer`` makes both cuts;
the engine runs it once when it takes its blocks.  The gated RMSNorm
sums each row's squares over the ``mlp`` axes before its scale
(``_norm_sumsq``), and ``out`` is row-parallel, summed over them.
"""
from __future__ import annotations

import math
from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.kernels.ssd_scan import ops as ssd_ops
from repro_torch.models.layers import Params, _rms_scale, dtype_of
from repro_torch.models.quant import is_qpack, matmul_q
from repro_torch.parallel import axes as paxes
from repro_torch.parallel import collectives


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


def _cols(w) -> int:
    """The output columns a rank holds of a projection (or its q-pack)."""
    return (w["q"] if is_qpack(w) else w).shape[-1]


def _held_heads(params: Params, cfg) -> Tuple[int, int]:
    """(first head, heads) of the mixer's heads this rank computes: those
    of its block of ``d_inner`` (``wx``'s columns), every head where it
    holds ``wx`` whole.  The engine checks that the block is whole heads
    and that the ``heads`` leaves are whole or split as it is
    (``serve.engine.check_layout``)."""
    d_inner, nheads, _ = dims(cfg)
    cols = _cols(params["wx"])
    if cols == d_inner:
        return 0, nheads
    held = cols // cfg.ssm.head_dim
    return paxes.rule_index("mlp") * held, held


def _heads_of(t: torch.Tensor, first: int, held: int) -> torch.Tensor:
    """The held heads of a per-head tensor (last dim): a view where it
    is whole, ``t`` where it is already the rank's block."""
    return t if t.shape[-1] == held else t.narrow(-1, first, held)


def rank_mixer(params: Params, cfg) -> Params:
    """The mixer's leaves as a rank's decode step reads them where it
    holds a block of ``d_inner`` (under the sharding context): ``wdt``,
    ``A_log``, ``D`` and ``dt_bias`` of its heads, and the conv taps of
    its window's channels, its x channels then B and C whole.  ``params``
    itself where it holds ``d_inner`` whole or the taps are already the
    window's."""
    s = cfg.ssm
    d_whole, _, conv_dim = dims(cfg)
    first, held = _held_heads(params, cfg)
    n_x = held * s.head_dim
    if n_x == d_whole or params["conv_w"].shape[1] < conv_dim:
        return params
    x0 = first * s.head_dim
    idx = torch.cat([torch.arange(x0, x0 + n_x),
                     torch.arange(d_whole, conv_dim)]).to(
                         params["conv_w"].device)

    def heads(t):
        return _heads_of(t, first, held).contiguous()

    wdt = params["wdt"]
    return dict(params,
                conv_w=params["conv_w"].index_select(1, idx),
                conv_b=params["conv_b"].index_select(0, idx),
                wdt=({k: heads(v) for k, v in wdt.items()} if is_qpack(wdt)
                     else heads(wdt)),
                A_log=heads(params["A_log"]), D=heads(params["D"]),
                dt_bias=heads(params["dt_bias"]))


def _norm_sumsq(ss: torch.Tensor) -> torch.Tensor:
    """A rank's fp32 sums of squares of the gated norm's input, summed
    over the ``mlp`` axes (the rest of ``d_inner``)."""
    return collectives.all_reduce_sum(ss, paxes.rule_axes("mlp"))


def _masked_recurrence(params, xbc, dt, A, state, n_valid, cfg):
    """Decode-mode recurrence over the S step columns with a per-row
    validity mask.  xbc: (B, S, c) pre-conv, c the window's channels (x,
    then B and C); dt: (B, S, h) post-softplus; ``state`` {"h": (B, h,
    p, n) fp32, "conv": (B, k-1, c)}, updated in place.  ``params``:
    ``conv_w`` / ``conv_b`` the window's taps and ``D`` its heads' (a
    rank's, under a mesh).

    Step t rolls the conv window, applies the depthwise taps and takes
    one ``h' = h * exp(dt A) + dt B x`` step, then commits (window, h)
    only for rows with ``t < n_valid[row]``: the other rows keep their
    state bit for bit.  An invalid step still produces a y column (from
    the uncommitted candidate state), which the engine never reads.
    Returns y: (B, S, h, p) fp32."""
    s = cfg.ssm
    Bsz, S, _ = xbc.shape
    n = s.ngroups * s.d_state
    d_inner = xbc.shape[-1] - 2 * n                       # the x channels
    nheads = d_inner // s.head_dim
    cdt = xbc.dtype
    w = params["conv_w"].to(cdt)                          # (k, c)
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
    (``ssd_ops.SSDChunked``).  Under a sharding context (decode mode)
    the mixer runs on the rank's heads and ``state`` is the rank's (see
    the module docstring)."""
    s = cfg.ssm
    Bsz, S, _ = x.shape
    d_whole = dims(cfg)[0]
    _, nheads = _held_heads(params, cfg)
    d_inner = nheads * s.head_dim                         # the held channels
    n = s.ngroups * s.d_state
    cdt = x.dtype
    if d_inner < d_whole:
        if mode != "decode":
            raise NotImplementedError(
                f"a rank's block of the mixer in mode {mode!r}: the port "
                f"shards the decode mode only (ROADMAP A10)")
        params = rank_mixer(params, cfg)

    z = matmul_q(x, params["wz"])
    xs = matmul_q(x, params["wx"])
    Bp = matmul_q(x, params["wB"])
    Cp = matmul_q(x, params["wC"])
    dt = matmul_q(x, params["wdt"])

    xbc = torch.cat([xs, Bp, Cp], dim=-1)                 # (B, S, conv_dim)
    A = -torch.exp(params["A_log"])                       # (nheads,) < 0
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
    # gated RMSNorm (its mean of squares over all of d_inner), then the
    # out-projection (row-parallel over the held channels)
    g = y * F.silu(z)
    if d_inner < d_whole:
        gf = g.float()
        ss = _norm_sumsq((gf * gf).sum(dim=-1, keepdim=True))
        r = torch.rsqrt(ss / d_whole + cfg.norm_eps)
    else:
        r = _rms_scale(g, cfg.norm_eps)
    g = g * r.to(cdt) * params["norm_scale"].to(cdt)
    out = matmul_q(g, params["out"])
    if d_inner < d_whole:
        out = collectives.all_reduce_sum(out, paxes.rule_axes("mlp"))
    return out, new_state


def init_state(cfg, n_layers: int, batch: int, dtype, device,
               d_inner: Optional[int] = None) -> Dict[str, torch.Tensor]:
    """Layer-stacked recurrent state: ``h`` (L, B, h, p, n) fp32 and the
    conv window ``conv`` (L, B, k-1, conv_dim) in the compute dtype.
    ``d_inner``: a rank's block of the mixer's channels; ``h`` then holds
    its heads and ``conv`` its x channels, then B and C whole."""
    s = cfg.ssm
    _, nheads, conv_dim = dims(cfg)
    if d_inner is not None:
        nheads = d_inner // s.head_dim
        conv_dim = d_inner + 2 * s.ngroups * s.d_state
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
