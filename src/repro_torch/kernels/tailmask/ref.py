"""Plain PyTorch versions of the tail-handling kernels (counterpart of
``repro.kernels.tailmask.ref``): the CPU path and the on-card oracle."""
import torch
import torch.nn.functional as F


def compute(x: torch.Tensor) -> torch.Tensor:
    return F.silu(x) * 2.0


def compute_masked(x_padded: torch.Tensor, n_valid: int) -> torch.Tensor:
    rows, lane = x_padded.shape
    idx = torch.arange(rows * lane, device=x_padded.device).view(rows, lane)
    return torch.where(idx < n_valid, compute(x_padded), 0.0)
