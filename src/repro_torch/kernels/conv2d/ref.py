"""Plain stride-1 SAME conv2d, NHWC / HWIO, with the TPU kernel's padding.

The padding is ``(k // 2, k - 1 - k // 2)`` on each spatial axis, as
``repro.kernels.conv2d.kernel.conv2d_same`` pads.  For odd k that is
XLA's "SAME"; for even k the JAX kernel pads one more row (column)
before than after, where XLA's "SAME" (``repro.kernels.conv2d.ref``) pads
one more after.  The port follows the kernel.
"""
import torch
import torch.nn.functional as F


def pads(k: int):
    return k // 2, k - 1 - k // 2


def conv2d_same(x, w) -> torch.Tensor:
    """x: (N, H, W, Cin); w: (kh, kw, Cin, Cout).  Returns (N, H, W, Cout)
    as the sum over taps (dy, dx) of the shifted input times w[dy, dx],
    accumulated in fp32 (fp64 inputs stay fp64)."""
    N, H, W, Cin = x.shape
    kh, kw, _, Cout = w.shape
    acc_t = torch.float64 if x.dtype == torch.float64 else torch.float32
    (pt, pb), (pl, pr) = pads(kh), pads(kw)
    xp = F.pad(x.to(acc_t), (0, 0, pl, pr, pt, pb))
    wf = w.to(acc_t)
    acc = torch.zeros((N, H, W, Cout), dtype=acc_t, device=x.device)
    for dy in range(kh):
        for dx in range(kw):
            acc += xp[:, dy:dy + H, dx:dx + W, :] @ wf[dy, dx]
    return acc.to(x.dtype)
