"""Plain PyTorch versions of the chunked SSD scan (Mamba-2's state-space
duality): the CPU path of ``ops`` and the on-card oracle of the kernel.

- ``ssd_naive`` — the token-by-token recurrence over the stream layout
  (the port of ``repro.kernels.ssd_scan.ref.ssd_naive``).
- ``ssd_chunked`` — the port of ``repro.models.mamba2._ssd_chunked`` in
  the model's layout, returning the output and the final state.  Every
  einsum runs in fp32 (a caller on the card keeps TF32 off).  It is the
  composition of the CUDA kernel's passes, each a function here and the
  kernel's oracle on the card: ``chunk_states`` (each chunk's own state
  contribution), ``state_pass`` (the state before each chunk, and the
  final one) and ``chunk_outputs``.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F


def ssd_naive(x, dt, B, C, A, D):
    """x: (BH, S, P); dt: (BH, S, 1); B/C: (BH, S, N); A/D: (BH,).
    ``h <- exp(dt A) h + dt B x^T``, ``y = C h + D x`` token by token, in
    fp32; y (BH, S, P) in x's dtype."""
    BH, S, P = x.shape
    N = B.shape[-1]
    xf, dtf, Bf, Cf = x.float(), dt.float(), B.float(), C.float()
    Af, Df = A.float(), D.float()
    h = torch.zeros((BH, N, P), dtype=torch.float32, device=x.device)
    ys = []
    for t in range(S):
        decay = torch.exp(dtf[:, t, 0] * Af)                     # (BH,)
        h = decay[:, None, None] * h + dtf[:, t, 0, None, None] * (
            Bf[:, t, :, None] * xf[:, t, None, :])
        ys.append(torch.einsum("bn,bnp->bp", Cf[:, t], h)
                  + Df[:, None] * xf[:, t])
    y = torch.stack(ys, dim=1) if ys else xf.new_zeros((BH, 0, P))
    return y.to(x.dtype)


def _per_head(v, b):
    """A or D, (h,) or (b, h), as (b or 1, h)."""
    return v[None] if v.dim() == 1 else v.reshape(b, -1)


def _chunked(x, dt, A, B, C, chunk: int):
    """Pad S to whole chunks with dt = 0 and cut into chunks: xc (b, nc,
    L, h, p), dtc (b, nc, L, h), Bc / Cc (b, nc, L, n), and cum, the
    within-chunk cumsum of dt * A (b, nc, L, h)."""
    b, s, h, p = x.shape
    n = B.shape[-1]
    A_ = _per_head(A, b)
    nc = -(-s // chunk)
    pad = nc * chunk - s
    if pad:
        x = F.pad(x, (0, 0, 0, 0, 0, pad))
        dt = F.pad(dt, (0, 0, 0, pad))
        B = F.pad(B, (0, 0, 0, pad))
        C = F.pad(C, (0, 0, 0, pad))
    L = chunk
    xc = x.reshape(b, nc, L, h, p)
    dtc = dt.reshape(b, nc, L, h)
    Bc = B.reshape(b, nc, L, n)
    Cc = C.reshape(b, nc, L, n)
    dA = dtc * A_[:, None, None, :]                       # (b,nc,L,h)
    cum = torch.cumsum(dA, dim=2)                         # within-chunk
    return xc, dtc, Bc, Cc, cum


def chunk_states(x, dt, A, B, C, chunk: int):
    """The kernel's pass (b): each chunk's own contribution to the state,
    ``s_c = sum_m exp(cum_L - cum_m) dt_m x_m B_m^T``, (b, nc, h, p, n)
    fp32.  Arguments as ``ssd_chunked`` (C is not read)."""
    xc, dtc, Bc, _, cum = _chunked(x, dt, A, B, C, chunk)
    decay_end = torch.exp(cum[:, :, -1:, :] - cum)        # (b,nc,L,h)
    return torch.einsum("bclh,bcln,bclhp->bchpn", decay_end * dtc, Bc, xc)


def state_pass(states, dt, A, chunk: int):
    """The kernel's pass (c): ``h_c = exp(cum_L,c) h_{c-1} + s_c`` in
    chunk order from h = 0.  ``states``: ``chunk_states``' output; dt and
    A as ``ssd_chunked``.  Returns ``(h_prev (b, nc, h, p, n), h_final
    (b, h, p, n))``: the state before each chunk, and after the last."""
    b, nc, h, p, n = states.shape
    A_ = _per_head(A, b)
    pad = nc * chunk - dt.shape[1]
    dtp = F.pad(dt, (0, 0, 0, pad)) if pad else dt
    dA = dtp.reshape(b, nc, chunk, h) * A_[:, None, None, :]
    cum = torch.cumsum(dA, dim=2)
    chunk_decay = torch.exp(cum[:, :, -1, :])             # (b,nc,h)
    hstate = torch.zeros((b, h, p, n), dtype=states.dtype,
                         device=states.device)
    h_prevs = []
    for c in range(nc):
        h_prevs.append(hstate)
        hstate = hstate * chunk_decay[:, c, :, None, None] + states[:, c]
    h_prev = (torch.stack(h_prevs, dim=1) if h_prevs
              else states.new_zeros((b, 0, h, p, n)))
    return h_prev, hstate


def chunk_outputs(x, dt, A, B, C, D, h_prev, chunk: int):
    """The kernel's pass (d): every chunk's outputs from the state before
    it, ``y_l = sum_{m <= l} (C_l . B_m) exp(cum_l - cum_m) dt_m x_m +
    exp(cum_l) C_l . h_prev + D x_l``.  ``h_prev``: ``state_pass``' first
    output; the rest as ``ssd_chunked``.  Returns y (b, s, h, p) in x's
    dtype."""
    b, s, h, p = x.shape
    D_ = _per_head(D, b)
    xc, dtc, Bc, Cc, cum = _chunked(x, dt, A, B, C, chunk)
    nc, L = xc.shape[1], chunk

    # --- intra-chunk ---
    S_lm = torch.einsum("bcln,bcmn->bclm", Cc, Bc)         # (b,nc,L,L)
    seg = cum[:, :, :, None, :] - cum[:, :, None, :, :]   # (b,nc,L,M,h)
    causal = torch.ones((L, L), dtype=torch.bool, device=x.device).tril()
    # masked before the exp: above the diagonal seg > 0 and exp overflows
    # (0 * inf would turn the gradient NaN)
    decay = torch.exp(torch.where(causal[None, None, :, :, None], seg,
                                  float("-inf")))
    W = S_lm[..., None] * decay                           # (b,nc,L,M,h)
    xdt = xc * dtc[..., None]                             # (b,nc,M,h,p)
    y_intra = torch.einsum("bclmh,bcmhp->bclhp", W, xdt)

    # --- inter-chunk term ---
    y_inter = torch.einsum("bcln,bchpn,bclh->bclhp", Cc, h_prev,
                           torch.exp(cum))

    y = (y_intra + y_inter).reshape(b, nc * L, h, p)[:, :s]
    y = y + x * D_[:, None, :, None]
    return y.to(x.dtype)


def ssd_chunked(x, dt, A, B, C, D, chunk: int):
    """x: (b, s, h, p); dt: (b, s, h) (post-softplus); A: (h,) < 0; B/C:
    (b, s, n); D: (h,).  A and D may also be (b, h): one value per
    stream, as the stream layout of ``ops.ssd_scan`` needs.

    Returns ``(y (b, s, h, p) in x's dtype, h_final (b, h, p, n) fp32)``.
    A sequence that is not a multiple of ``chunk`` is padded with dt = 0,
    so the padding neither decays nor feeds the state: ``h_final`` is the
    state after the last real token.  The composition of the kernel's
    passes: ``chunk_states``, ``state_pass``, ``chunk_outputs``."""
    b, s, h, p = x.shape
    n = B.shape[-1]
    if s == 0:
        return x.clone(), torch.zeros((b, h, p, n), dtype=torch.float32,
                                      device=x.device)
    states = chunk_states(x, dt, A, B, C, chunk)
    h_prev, h_final = state_pass(states, dt, A, chunk)
    return chunk_outputs(x, dt, A, B, C, D, h_prev, chunk), h_final
