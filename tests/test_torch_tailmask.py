"""The port's tail handling on the CPU (its plain versions) against the
JAX package's ``tail_compute`` (the Pallas kernels in interpret mode), on
the same numpy inputs: the exact idiom at 8, 13 and 57 rows (whole tiles
and ragged remainders), the masked idiom at n_valid 1000, 4096 and 6000
on 48 padded rows.  rtol 1e-6: silu(x) * 2 in fp32 through another
library's exp."""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from repro.kernels.tailmask import ops as jax_ops
from repro_torch.kernels.tailmask import kernel as pt_kernel
from repro_torch.kernels.tailmask import ops as pt_ops
from repro_torch.kernels.tailmask import ref as pt_ref


def _x(rows, seed):
    return np.random.default_rng(seed).standard_normal((rows, 128)).astype(
        np.float32) * 4


@pytest.mark.parametrize("rows", [8, 13, 57])
def test_exact_tail_matches_jax(rows):
    x = _x(rows, rows)
    got = pt_ops.tail_compute(torch.from_numpy(x), "exact_tail")
    want = np.asarray(jax_ops.tail_compute(jnp.asarray(x), "exact_tail"))
    assert got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=0)


@pytest.mark.parametrize("n_valid", [1000, 4096, 6000])
def test_masked_full_matches_jax(n_valid):
    x = _x(48, n_valid)
    got = pt_ops.tail_compute(torch.from_numpy(x), "masked_full",
                              n_valid=n_valid)
    want = np.asarray(jax_ops.tail_compute(jnp.asarray(x), "masked_full",
                                           n_valid=n_valid))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=0)
    assert (got.reshape(-1)[n_valid:] == 0).all()


@pytest.mark.parametrize("rows,block_rows", [(13, 8), (48, 32), (8, 3)])
def test_masked_needs_whole_tiles(rows, block_rows):
    with pytest.raises(ValueError):
        pt_ops.tail_compute(torch.zeros((rows, 128)), "masked_full",
                            n_valid=100, block_rows=block_rows)


def test_bad_arguments_raise():
    x = torch.zeros((16, 128))
    with pytest.raises(ValueError):
        pt_ops.tail_compute(x, "vsetvl")
    with pytest.raises(ValueError):
        pt_ops.tail_compute(x, "masked_full")
    with pytest.raises(ValueError):
        pt_ops.tail_compute(x, block_rows=0)


@pytest.mark.parametrize("idiom,wrapper", [("exact_tail", "exact_tail"),
                                           ("masked_full", "masked_full")])
def test_non_cpu_tensor_launches_the_kernel_or_raises(monkeypatch, idiom,
                                                      wrapper):
    class Launched(Exception):
        pass

    def launched(*args, **kwargs):
        raise Launched

    monkeypatch.setattr(pt_kernel, wrapper, launched)
    monkeypatch.setattr(pt_ref, "compute", launched)
    monkeypatch.setattr(pt_ref, "compute_masked", launched)
    with pytest.raises(Launched):
        pt_ops.tail_compute(torch.zeros((16, 128), device="meta"), idiom,
                            n_valid=100)


@pytest.mark.parametrize("wrapper,args", [("exact_tail", ()),
                                          ("masked_full", (100,))])
def test_kernel_wrappers_refuse_cpu_tensors(wrapper, args):
    fn = getattr(pt_kernel, wrapper)
    before = fn.launches
    with pytest.raises(RuntimeError):
        fn(torch.zeros((16, 128)), *args)
    assert fn.launches == before
