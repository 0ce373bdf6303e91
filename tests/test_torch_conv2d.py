"""The port's direct conv2d on the CPU (its plain version) against the
JAX package.  The Pallas kernel does not run on the installed jax
(``pl.unblocked`` is gone), so odd filters are held against its oracle
``repro.kernels.conv2d.ref`` (XLA's SAME convolution).  For even filters
the JAX kernel pads ``(k // 2, k - 1 - k // 2)``, one more before than
after, where XLA's SAME pads one more after: the port follows the
kernel, so even filters are held against XLA's convolution with the
kernel's explicit padding.  fp32; tolerance 1e-5 (fp32 roundoff of a
sum of <= 200 products)."""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro.kernels.conv2d import kernel as jax_kernel
from repro.kernels.conv2d import ref as jax_ref
from repro_torch.kernels.conv2d import kernel as pt_kernel
from repro_torch.kernels.conv2d import ops as pt_ops

SHAPES = [(2, 16, 16, 8, 16), (1, 8, 13, 5, 7)]


def _inputs(shape, k, seed=3):
    N, H, W, Cin, Cout = shape
    rng = np.random.default_rng(seed + k)
    x = rng.standard_normal((N, H, W, Cin)).astype(np.float32)
    w = (rng.standard_normal((k, k, Cin, Cout)) * 0.1).astype(np.float32)
    return x, w


def _xla(x, w, padding):
    return np.asarray(jax.lax.conv_general_dilated(
        jnp.asarray(x), jnp.asarray(w), (1, 1), padding,
        dimension_numbers=("NHWC", "HWIO", "NHWC"),
        precision=jax.lax.Precision.HIGHEST))


@pytest.mark.parametrize("k", [1, 2, 3, 5])
@pytest.mark.parametrize("shape", SHAPES)
def test_conv2d_matches_jax(k, shape):
    x, w = _inputs(shape, k)
    got = pt_ops.conv2d_same(torch.from_numpy(x), torch.from_numpy(w),
                             block_h=8).numpy()
    if k % 2:
        want = np.asarray(jax_ref.conv2d_same(jnp.asarray(x),
                                              jnp.asarray(w)))
    else:
        p = (k // 2, k - 1 - k // 2)
        want = _xla(x, w, [p, p])
    assert got.shape == shape[:3] + (shape[4],)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


def test_even_filter_pads_as_the_tpu_kernel():
    """k = 2: the port agrees with the kernel's padding (1, 0) and not
    with XLA's SAME (0, 1)."""
    x, w = _inputs(SHAPES[0], 2)
    got = pt_ops.conv2d_same(torch.from_numpy(x), torch.from_numpy(w))
    got = got.numpy()
    np.testing.assert_allclose(got, _xla(x, w, [(1, 0), (1, 0)]), rtol=1e-5,
                               atol=1e-5)
    assert np.abs(got - _xla(x, w, "SAME")).max() > 1e-2


def test_rows_must_divide_by_block_h():
    x, w = _inputs((1, 12, 8, 4, 4), 3)
    with pytest.raises(AssertionError):           # the JAX kernel's check
        jax_kernel.conv2d_same(jnp.asarray(x), jnp.asarray(w), block_h=8)
    with pytest.raises(ValueError):
        pt_ops.conv2d_same(torch.from_numpy(x), torch.from_numpy(w),
                           block_h=8)
    got = pt_ops.conv2d_same(torch.from_numpy(x), torch.from_numpy(w),
                             block_h=4)
    np.testing.assert_allclose(
        got.numpy(), np.asarray(jax_ref.conv2d_same(jnp.asarray(x),
                                                    jnp.asarray(w))),
        rtol=1e-5, atol=1e-5)


def test_kernel_wrapper_refuses_cpu_tensors():
    x, w = torch.ones((1, 8, 8, 4)), torch.ones((3, 3, 4, 4))
    before = pt_kernel.conv2d_same.launches
    with pytest.raises(RuntimeError):
        pt_kernel.conv2d_same(x, w, bh=8)
    assert pt_kernel.conv2d_same.launches == before
