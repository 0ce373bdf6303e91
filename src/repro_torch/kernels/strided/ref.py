"""Plain PyTorch version of the strided row gather (counterpart of
``repro.kernels.strided.ref``): the CPU path and the on-card oracle."""
import torch


def strided_gather(x: torch.Tensor, stride: int, out_rows=None
                   ) -> torch.Tensor:
    """Rows 0, stride, 2 stride, ... of x: ``out_rows`` of them, or
    cdiv(rows, stride).  A new contiguous tensor, as the kernels return."""
    n = out_rows if out_rows is not None else -(-x.shape[0] // stride)
    return x[: n * stride: stride].clone(
        memory_format=torch.contiguous_format)
