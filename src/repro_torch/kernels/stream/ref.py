"""Plain PyTorch versions of the STREAM kinds (counterpart of
``repro.kernels.stream.ref``): the CPU path and the on-card oracle."""
import torch


def stream_copy(x):
    return x.clone()


def stream_scale(x, alpha):
    return alpha * x


def stream_add(x, y):
    return x + y


def stream_triad(x, y, alpha):
    return x + alpha * y


def stream(kind, x, y=None, alpha=2.0) -> torch.Tensor:
    if kind == "copy":
        return stream_copy(x)
    if kind == "scale":
        return stream_scale(x, alpha)
    if kind == "add":
        return stream_add(x, y)
    if kind == "triad":
        return stream_triad(x, y, alpha)
    raise ValueError(kind)
