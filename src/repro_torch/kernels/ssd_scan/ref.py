"""Plain PyTorch versions of the chunked SSD scan (Mamba-2's state-space
duality): the CPU path of ``ops`` and the on-card oracle of the kernel.

- ``ssd_naive`` — the token-by-token recurrence over the stream layout
  (the port of ``repro.kernels.ssd_scan.ref.ssd_naive``).
- ``ssd_chunked`` — the port of ``repro.models.mamba2._ssd_chunked`` in
  the model's layout, returning the output and the final state.  Every
  einsum runs in fp32 (a caller on the card keeps TF32 off).
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


def ssd_chunked(x, dt, A, B, C, D, chunk: int):
    """x: (b, s, h, p); dt: (b, s, h) (post-softplus); A: (h,) < 0; B/C:
    (b, s, n); D: (h,).  A and D may also be (b, h): one value per
    stream, as the stream layout of ``ops.ssd_scan`` needs.

    Returns ``(y (b, s, h, p) in x's dtype, h_final (b, h, p, n) fp32)``.
    A sequence that is not a multiple of ``chunk`` is padded with dt = 0,
    so the padding neither decays nor feeds the state: ``h_final`` is the
    state after the last real token."""
    b, s, h, p = x.shape
    n = B.shape[-1]
    A_, D_ = _per_head(A, b), _per_head(D, b)
    if s == 0:
        return x.clone(), torch.zeros((b, h, p, n), dtype=torch.float32,
                                      device=x.device)
    nc = -(-s // chunk)
    pad = nc * chunk - s
    xp, dtp, Bp, Cp = x, dt, B, C
    if pad:
        xp = F.pad(x, (0, 0, 0, 0, 0, pad))
        dtp = F.pad(dt, (0, 0, 0, pad))
        Bp = F.pad(B, (0, 0, 0, pad))
        Cp = F.pad(C, (0, 0, 0, pad))
    L = chunk
    xc = xp.reshape(b, nc, L, h, p)
    dtc = dtp.reshape(b, nc, L, h)
    Bc = Bp.reshape(b, nc, L, n)
    Cc = Cp.reshape(b, nc, L, n)

    dA = dtc * A_[:, None, None, :]                       # (b,nc,L,h)
    cum = torch.cumsum(dA, dim=2)                         # within-chunk

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

    # --- chunk states ---
    decay_end = torch.exp(cum[:, :, -1:, :] - cum)        # (b,nc,L,h)
    states = torch.einsum("bclh,bcln,bclhp->bchpn", decay_end * dtc, Bc, xc)

    # --- inter-chunk recurrence ---
    chunk_decay = torch.exp(cum[:, :, -1, :])             # (b,nc,h)
    hstate = torch.zeros((b, h, p, n), dtype=torch.float32, device=x.device)
    h_prevs = []
    for c in range(nc):
        h_prevs.append(hstate)
        hstate = hstate * chunk_decay[:, c, :, None, None] + states[:, c]
    h_prev = torch.stack(h_prevs, dim=1)                  # (b,nc,h,p,n)
    y_inter = torch.einsum("bcln,bchpn,bclh->bclhp", Cc, h_prev,
                           torch.exp(cum))

    y = (y_intra + y_inter).reshape(b, nc * L, h, p)[:, :s]
    y = y + x * D_[:, None, :, None]
    return y.to(x.dtype), hstate
