"""Plain ELL SpMV and the format helper (counterpart of
``repro.kernels.spmv.ref``)."""
import numpy as np
import torch


def spmv_ell(vals, cols, x) -> torch.Tensor:
    """vals/cols: (R, K); x: (C,).  Returns y: (R, 1)."""
    return torch.sum(vals * x[cols], dim=-1, keepdim=True)


def random_ell(key_seed: int, rows: int, cols: int, nnz_per_row: int,
               dtype=np.float32):
    """Deterministic random ELL matrix (numpy; a copy of the JAX
    package's helper, so the arrays come out identical bit for bit)."""
    rng = np.random.default_rng(key_seed)
    vals = rng.standard_normal((rows, nnz_per_row)).astype(dtype)
    idx = rng.integers(0, cols, size=(rows, nnz_per_row)).astype(np.int32)
    return vals, idx
