"""The port's strided row gather on the CPU (its plain version) against the
JAX package's ``strided_gather`` (the Pallas kernels in interpret mode), on
the same numpy inputs: both idioms, strides 2, 4 and 8, and row counts
that the stride does and does not divide (257).  A gather is exact."""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from repro.kernels.strided import ops as jax_ops
from repro_torch.kernels.strided import kernel as pt_kernel
from repro_torch.kernels.strided import ops as pt_ops
from repro_torch.kernels.strided import ref as pt_ref


@pytest.mark.parametrize("rows", [256, 257])
@pytest.mark.parametrize("stride", [2, 4, 8])
@pytest.mark.parametrize("idiom", ["strided_rowwise", "overfetch_select"])
def test_strided_matches_jax(idiom, stride, rows):
    x = np.random.default_rng(rows).standard_normal((rows, 128)).astype(
        np.float32)
    got = pt_ops.strided_gather(torch.from_numpy(x), stride, idiom)
    want = np.asarray(jax_ops.strided_gather(jnp.asarray(x), stride, idiom))
    n_out = (-(-rows // stride) if idiom == "strided_rowwise"
             else rows // stride)
    assert got.shape == want.shape == (n_out, 128)
    assert got.is_contiguous()
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("mult", [0, 1, 2, 3, 4, 8, 16])
def test_block_multiplier_validation_matches(mult):
    x = np.zeros((64, 128), np.float32)
    outcomes = []
    for call in (lambda: jax_ops.strided_gather(jnp.asarray(x), 2,
                                                block_multiplier=mult),
                 lambda: pt_ops.strided_gather(torch.from_numpy(x), 2,
                                               block_multiplier=mult)):
        try:
            call()
            outcomes.append(None)
        except ValueError:
            outcomes.append(ValueError)
    assert outcomes[0] == outcomes[1]


def test_bad_idiom_and_stride_raise():
    x = torch.zeros((16, 128))
    with pytest.raises(ValueError):
        pt_ops.strided_gather(x, 2, "vlse")
    with pytest.raises(ValueError):
        pt_ops.strided_gather(x, 0, "strided_rowwise")


def test_ref_returns_a_copy():
    x = torch.arange(24.0).view(6, 4)
    out = pt_ref.strided_gather(x, 2)
    out.zero_()
    assert x[0, 1] == 1.0


@pytest.mark.parametrize("idiom,wrapper", [
    ("strided_rowwise", "strided_rowwise"),
    ("overfetch_select", "overfetch_select")])
def test_non_cpu_tensor_launches_the_kernel_or_raises(monkeypatch, idiom,
                                                      wrapper):
    class Launched(Exception):
        pass

    def launched(*args, **kwargs):
        raise Launched

    monkeypatch.setattr(pt_kernel, wrapper, launched)
    monkeypatch.setattr(pt_ref, "strided_gather", launched)
    with pytest.raises(Launched):
        pt_ops.strided_gather(torch.zeros((16, 128), device="meta"), 2,
                              idiom)


@pytest.mark.parametrize("wrapper", ["strided_rowwise", "overfetch_select"])
def test_kernel_wrappers_refuse_cpu_tensors(wrapper):
    fn = getattr(pt_kernel, wrapper)
    before = fn.launches
    with pytest.raises(RuntimeError):
        fn(torch.zeros((16, 128)), 2)
    assert fn.launches == before
