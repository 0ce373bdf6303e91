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
fallback.  On the card the call goes through ``SSDChunked``, whose
forward is the kernel and whose backward is the vector-Jacobian product
of the plain scan recomputed: the reference's gradient is autodiff of
its jnp ``_ssd_chunked`` too, outside any Pallas kernel.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.common import aligned
from repro_torch.kernels.ssd_scan import kernel as K
from repro_torch.kernels.ssd_scan import ref


PROFILE_RANGE = "ssd_plain_backward"


class SSDChunked(torch.autograd.Function):
    """``fwd(x, dt, A, B, C, D, chunk) -> (y, h_final)`` with the plain
    scan's gradient: the backward runs ``ref.ssd_chunked`` again on the
    saved inputs under autograd and returns its vector-Jacobian product
    for the cotangents of ``y`` and ``h_final`` (either may be absent).
    ``ssd_chunked`` passes the kernel as ``fwd`` on the card; a test may
    pass the plain forward to run the same backward on the CPU."""

    @staticmethod
    def forward(ctx, fwd, x, dt, A, B, C, D, chunk):
        ctx.set_materialize_grads(False)
        ctx.save_for_backward(x, dt, A, B, C, D)
        ctx.chunk = chunk
        return fwd(x, dt, A, B, C, D, chunk)

    @staticmethod
    def backward(ctx, dy, dh):
        inputs = ctx.saved_tensors
        want = ctx.needs_input_grad[1:7]
        live = [t.detach().requires_grad_(w) for t, w in zip(inputs, want)]
        cots = [(o, g) for o, g in zip((0, 1), (dy, dh)) if g is not None]
        if not cots or not any(want):
            return (None,) * 8
        # the range names this backward's device time under torch.profiler
        with torch.profiler.record_function(PROFILE_RANGE), \
                torch.enable_grad():
            outs = ref.ssd_chunked(*live, ctx.chunk)
            grads = iter(torch.autograd.grad(
                [outs[o] for o, _ in cots],
                [t for t in live if t.requires_grad], [g for _, g in cots],
                allow_unused=True))
        return (None, *(next(grads) if w else None for w in want), None)


def _kernel_fwd(x, dt, A, B, C, D, chunk):
    b, _, h, _ = x.shape
    return K.ssd_scan_fwd(
        aligned(x), dt.contiguous(), aligned(B), aligned(C),
        A.expand(b, h).contiguous().view(-1),
        D.expand(b, h).contiguous().view(-1), chunk=chunk)


def ssd_chunked(x, dt, A, B, C, D, chunk: int):
    """x: (b, s, h, p); dt: (b, s, h); A: (h,) < 0; B/C: (b, s, n); D:
    (h,); fp32.  Returns ``(y (b, s, h, p), h_final (b, h, p, n))``,
    differentiable in every input."""
    if x.device.type == "cpu":
        return ref.ssd_chunked(x, dt, A, B, C, D, chunk)
    return SSDChunked.apply(_kernel_fwd, x, dt, A, B, C, D, chunk)


def ssd_scan(x, dt, B, C, A, D, *, chunk: int = 128):
    """x: (BH, S, P); dt: (BH, S, 1); B/C: (BH, S, N); A/D: (BH,).
    Returns y (BH, S, P)."""
    BH, S, P = x.shape
    y, _ = ssd_chunked(x.reshape(BH, S, 1, P), dt.reshape(BH, S, 1),
                       A.reshape(BH, 1), B, C, D.reshape(BH, 1), chunk)
    return y.reshape(BH, S, P)
