"""SSD scan entries: device dispatch in the two layouts.

- ``ssd_chunked(x, dt, A, B, C, D, chunk)`` — the model's layout, the
  signature of ``repro.models.mamba2._ssd_chunked``; returns
  ``(y, h_final)``.  ``mamba2.mamba_forward`` calls it in prefill and
  train modes.
- ``ssd_scan(x, dt, B, C, A, D, chunk=...)`` — the stream layout and
  signature of ``repro.kernels.ssd_scan.ops.ssd_scan`` (one (b, h)
  stream a row, A/D one value a stream); returns y.  Unlike the Pallas op
  it takes any S, not only a multiple of the chunk.

A CPU tensor runs the plain version (``ref.ssd_chunked``); a CUDA tensor
launches the kernel (``kernel.ssd_scan_fwd``) or raises — there is no
fallback.  The kernel has no backward yet: on the card, a call that
would need a gradient raises.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.common import aligned
from repro_torch.kernels.ssd_scan import kernel as K
from repro_torch.kernels.ssd_scan import ref


def _needs_grad(*ts) -> bool:
    return torch.is_grad_enabled() and any(t.requires_grad for t in ts)


def ssd_chunked(x, dt, A, B, C, D, chunk: int):
    """x: (b, s, h, p); dt: (b, s, h); A: (h,) < 0; B/C: (b, s, n); D:
    (h,); fp32.  Returns ``(y (b, s, h, p), h_final (b, h, p, n))``."""
    if x.device.type == "cpu":
        return ref.ssd_chunked(x, dt, A, B, C, D, chunk)
    if _needs_grad(x, dt, A, B, C, D):
        raise NotImplementedError(
            "SSD backward: the CUDA SSD scan has no gradient yet, so the "
            "ssm and hybrid families train on the CPU only (ROADMAP B4 "
            "follow-up, the SSD backward for mamba2 and jamba training)")
    b, _, h, _ = x.shape
    return K.ssd_scan_fwd(
        aligned(x), dt.contiguous(), aligned(B), aligned(C),
        A.expand(b, h).contiguous().view(-1),
        D.expand(b, h).contiguous().view(-1), chunk=chunk)


def ssd_scan(x, dt, B, C, A, D, *, chunk: int = 128):
    """x: (BH, S, P); dt: (BH, S, 1); B/C: (BH, S, N); A/D: (BH,).
    Returns y (BH, S, P)."""
    BH, S, P = x.shape
    y, _ = ssd_chunked(x.reshape(BH, S, 1, P), dt.reshape(BH, S, 1),
                       A.reshape(BH, 1), B, C, D.reshape(BH, 1), chunk)
    return y.reshape(BH, S, P)
