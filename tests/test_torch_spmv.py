"""The port's ELL SpMV on the CPU (its plain versions) against the JAX
package's ``spmv_ell`` (the Pallas kernels in interpret mode), in both
idioms (take and one-hot), on the same numpy matrices: rows that are and
are not a multiple of the TPU's 8-row block, and nonzeros per row that
are not a power of two.  A column outside [0, C) contributes 0 in the
one-hot idiom, as in the JAX one-hot kernel.  fp32; the tolerance is
fp32 roundoff of a <= 16-term sum (1e-5)."""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from repro.kernels.spmv import ops as jax_ops
from repro.kernels.spmv import ref as jax_ref
from repro_torch.kernels.spmv import kernel as pt_kernel
from repro_torch.kernels.spmv import ops as pt_ops
from repro_torch.kernels.spmv import ref as pt_ref


@pytest.mark.parametrize("idiom", ["take", "onehot"])
@pytest.mark.parametrize("rows,cols,nnz", [(64, 256, 16), (100, 77, 13),
                                           (9, 512, 1)])
def test_spmv_matches_jax(rows, cols, nnz, idiom):
    vals, idx = pt_ref.random_ell(rows, rows, cols, nnz)
    x = np.random.default_rng(2).standard_normal(cols).astype(np.float32)
    got = pt_ops.spmv_ell(torch.from_numpy(vals), torch.from_numpy(idx),
                          torch.from_numpy(x), idiom=idiom)
    want = jax_ops.spmv_ell(jnp.asarray(vals), jnp.asarray(idx),
                            jnp.asarray(x), idiom=idiom)
    assert got.shape == (rows, 1)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)


@pytest.mark.parametrize("rows,cols,nnz", [(64, 256, 16), (37, 50, 5)])
def test_onehot_out_of_range_columns_contribute_zero(rows, cols, nnz):
    """Columns at -1 and at C against the JAX one-hot kernel; each row's
    sum then equals the take idiom's over its in-range nonzeros."""
    vals, idx = pt_ref.random_ell(rows + 1, rows, cols, nnz)
    idx[::3, 0] = -1
    idx[1::3, -1] = cols
    x = np.random.default_rng(3).standard_normal(cols).astype(np.float32)
    got = pt_ops.spmv_ell(torch.from_numpy(vals), torch.from_numpy(idx),
                          torch.from_numpy(x), idiom="onehot")
    want = jax_ops.spmv_ell(jnp.asarray(vals), jnp.asarray(idx),
                            jnp.asarray(x), idiom="onehot")
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)
    inside = (idx >= 0) & (idx < cols)
    kept = np.where(inside, vals, 0.0).astype(np.float32)
    take = pt_ops.spmv_ell(torch.from_numpy(kept),
                           torch.from_numpy(np.where(inside, idx, 0)
                                            .astype(np.int32)),
                           torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy(), take.numpy(), rtol=1e-5,
                               atol=1e-5)


def test_random_ell_is_the_reference_helper():
    for a, b in zip(pt_ref.random_ell(4, 33, 70, 5),
                    jax_ref.random_ell(4, 33, 70, 5)):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("mult", [0, 1, 3, 8, 16])
def test_block_multiplier_validation_matches(mult):
    vals, idx = pt_ref.random_ell(0, 16, 32, 4)
    x = np.ones(32, np.float32)
    outcomes = []
    for call in (lambda: jax_ops.spmv_ell(jnp.asarray(vals),
                                          jnp.asarray(idx), jnp.asarray(x),
                                          block_multiplier=mult),
                 lambda: pt_ops.spmv_ell(torch.from_numpy(vals),
                                         torch.from_numpy(idx),
                                         torch.from_numpy(x),
                                         block_multiplier=mult)):
        try:
            call()
            outcomes.append(None)
        except ValueError:
            outcomes.append(ValueError)
    assert outcomes[0] == outcomes[1]


def test_unknown_idiom_raises():
    vals, idx = pt_ref.random_ell(0, 16, 32, 4)
    with pytest.raises(ValueError):
        pt_ops.spmv_ell(torch.from_numpy(vals), torch.from_numpy(idx),
                        torch.ones(32), idiom="gather")


@pytest.mark.parametrize("idiom,wrapper", [("take", "spmv_ell"),
                                           ("onehot", "spmv_ell_onehot")])
def test_non_cpu_tensor_launches_the_kernel_or_raises(monkeypatch, idiom,
                                                      wrapper):
    class Launched(Exception):
        pass

    def launched(*args, **kwargs):
        raise Launched

    monkeypatch.setattr(pt_kernel, wrapper, launched)
    for name in ("spmv_ell", "spmv_ell_onehot"):
        monkeypatch.setattr(pt_ref, name, launched)
    vals = torch.zeros((16, 4), device="meta")
    with pytest.raises(Launched):
        pt_ops.spmv_ell(vals, torch.zeros((16, 4), dtype=torch.int32,
                                          device="meta"),
                        torch.zeros(32, device="meta"), idiom=idiom)


def test_kernel_wrapper_refuses_cpu_tensors():
    vals, idx = pt_ref.random_ell(0, 16, 32, 4)
    before = pt_kernel.spmv_ell.launches
    with pytest.raises(RuntimeError):
        pt_kernel.spmv_ell(torch.from_numpy(vals), torch.from_numpy(idx),
                           torch.ones(32))
    assert pt_kernel.spmv_ell.launches == before


def test_onehot_kernel_wrapper_refuses_cpu_tensors():
    vals, idx = pt_ref.random_ell(0, 16, 32, 4)
    before = pt_kernel.spmv_ell_onehot.launches
    with pytest.raises(RuntimeError):
        pt_kernel.spmv_ell_onehot(torch.from_numpy(vals),
                                  torch.from_numpy(idx), torch.ones(32))
    assert pt_kernel.spmv_ell_onehot.launches == before


@pytest.mark.parametrize("K", [0, 1, 2, 3, 5, 8, 9, 16, 17, 33, 100, 257])
@pytest.mark.parametrize("C", [1, 77, 20000])
def test_onehot_plan_covers_k_and_c(K, C):
    """The one-hot kernel's plan: a power-of-two count of lanes a row (at
    most 32), four nonzeros a lane where K > 4 (one broadcast of x feeds
    sixteen compare-selects), enough passes for every nonzero, and x staged
    in chunks of a multiple of 4 floats, at most 16384 (64 KB), the whole
    of C where it fits."""
    lanes, per_lane, passes, chunk = pt_kernel.onehot_plan(K, C)
    assert lanes in (1, 2, 4, 8, 16, 32) and per_lane in (1, 2, 4)
    assert per_lane == pt_kernel.ONEHOT_PER_LANE or lanes == 1
    assert lanes * per_lane * passes >= K
    assert K == 0 or lanes * per_lane * (passes - 1) < K or passes == 1
    assert chunk % 4 == 0 and 4 <= chunk <= pt_kernel.ONEHOT_X_CHUNK
    assert chunk >= C or chunk == pt_kernel.ONEHOT_X_CHUNK

