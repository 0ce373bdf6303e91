"""Plain ELL SpMV, in the gather idiom and in the one-hot idiom, and the
format helper (counterpart of ``repro.kernels.spmv.ref``)."""
import numpy as np
import torch


def spmv_ell(vals, cols, x) -> torch.Tensor:
    """vals/cols: (R, K); x: (C,).  Returns y: (R, 1)."""
    return torch.sum(vals * x[cols], dim=-1, keepdim=True)


ONEHOT_CHUNK = 1 << 24      # elements of the (rows, K, C) one-hot at a time


def spmv_ell_onehot(vals, cols, x) -> torch.Tensor:
    """The one-hot idiom of the TPU kernel ``_spmv_onehot_kernel``:
    ``y[r] = sum_k vals[r, k] * sum_c [cols[r, k] == c] * x[c]``, so a
    column outside [0, C) contributes 0.  vals/cols: (R, K); x: (C,).
    Returns y: (R, 1).  Rows go in blocks whose one-hot stays under
    ``ONEHOT_CHUNK`` elements."""
    R, K = cols.shape
    C = x.shape[0]
    iota = torch.arange(C, device=x.device)
    step = max(1, ONEHOT_CHUNK // max(1, K * C))
    out = []
    for r0 in range(0, R, step):
        c = cols[r0:r0 + step]
        onehot = c[..., None] == iota[None, None, :]
        contrib = torch.where(onehot, x[None, None, :], 0.0).sum(dim=-1)
        out.append(torch.sum(vals[r0:r0 + step] * contrib, dim=-1,
                             keepdim=True))
    return (torch.cat(out) if out else
            torch.zeros((0, 1), dtype=vals.dtype, device=vals.device))


def random_ell(key_seed: int, rows: int, cols: int, nnz_per_row: int,
               dtype=np.float32):
    """Deterministic random ELL matrix (numpy; a copy of the JAX
    package's helper, so the arrays come out identical bit for bit)."""
    rng = np.random.default_rng(key_seed)
    vals = rng.standard_normal((rows, nnz_per_row)).astype(dtype)
    idx = rng.integers(0, cols, size=(rows, nnz_per_row)).astype(np.int32)
    return vals, idx
