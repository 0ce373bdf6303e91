"""The port's direct conv2d on the CPU (its plain version) against the
JAX package.  The Pallas kernel does not run on the installed jax
(``pl.unblocked`` is gone), so odd filters are held against its oracle
``repro.kernels.conv2d.ref`` (XLA's SAME convolution).  For even filters
the JAX kernel pads ``(k // 2, k - 1 - k // 2)``, one more before than
after, where XLA's SAME pads one more after: the port follows the
kernel, so even filters are held against XLA's convolution with the
kernel's explicit padding.  fp32; tolerance 1e-5 (fp32 roundoff of a
sum of <= 200 products).  The CUDA kernel's tile plan
(``kernel.plan``: channel tile, block rows, filter template, shared
memory) is checked here too; the kernel itself runs only on the card
(tests/test_torch_gpu.py)."""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro.kernels.conv2d import kernel as jax_kernel
from repro.kernels.conv2d import ref as jax_ref
from repro_torch.core import veceval
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


# the kernel's tile plan (csrc/conv2d.cu), checked here without a card
SMS = 132               # an H100 SXM's SMs


def _check_plan(p, N, H, W, Cin, Cout, kh, kw):
    assert p.bn >= min(Cout, 64) and p.tc * p.cg == p.bn
    assert (p.tc, p.cg) == pt_kernel.CHANNEL_TILES[p.bn]
    if kw <= pt_kernel.KW_MAX[-1]:
        assert kw <= p.kw_max and p.kw_max in pt_kernel.KW_MAX
    else:
        assert p.kw_max == pt_kernel.ANY_WIDTH
    assert p.threads == 4 * pt_kernel.TILE_H * p.cg and p.threads <= 256
    # the grid covers every output pixel and channel
    assert p.grid[0] * pt_kernel.TILE_W * p.bn >= W * Cout
    assert p.grid[0] == -(-W // pt_kernel.TILE_W) * -(-Cout // p.bn)
    assert p.grid[1] == -(-H // pt_kernel.TILE_H) and p.grid[2] == N
    assert p.smem == pt_kernel.smem_bytes(kh, kw, p.bn)
    assert p.smem <= pt_kernel.MAX_SMEM_BYTES


@pytest.mark.parametrize("side", [32, 224])
@pytest.mark.parametrize("app", ["alexnet", "yolov3"])
def test_plan_covers_the_veceval_layers(app, side):
    """Every layer of the CNN proxy apps at the JAX size and the card
    size: Cout 8, 16, 32 and 64 get their own channel tile (BN = Cout),
    1x1 and 3x3 their filter templates."""
    specs = {"alexnet": veceval.ALEXNET_SPECS,
             "yolov3": veceval.YOLOV3_SPECS}[app]
    cin = 16
    for k, cout in specs:
        p = pt_kernel.plan(1, side, side, cin, cout, k, k, SMS)
        _check_plan(p, 1, side, side, cin, cout, k, k)
        assert p.bn == cout and p.kw_max == k
        cin = cout


def test_plan_at_the_timed_layers():
    """224^2 64 -> 64 3x3: 4 x 32 pixels x 64 channels a block, 392 blocks
    (2.97 waves of 132); yolov3's 8 -> 32: 8 x 4 a thread, 4 warps."""
    p = pt_kernel.plan(1, 224, 224, 64, 64, 3, 3, SMS)
    assert (p.bn, p.tc, p.threads, p.grid) == (64, 8, 128, (7, 56, 1))
    p = pt_kernel.plan(1, 224, 224, 8, 32, 3, 3, SMS)
    assert (p.bn, p.tc, p.cg, p.threads) == (32, 4, 8, 128)
    p = pt_kernel.plan(4, 264, 32, 8, 64, 3, 3, SMS)
    assert p.grid == (1, 66, 4)


@pytest.mark.parametrize("kh,kw", [(1, 1), (2, 2), (3, 3), (4, 4), (5, 5),
                                   (3, 1), (1, 5), (9, 5), (7, 7), (3, 7),
                                   (1, 9)])
@pytest.mark.parametrize("cout", [1, 8, 9, 16, 32, 33, 64, 100])
def test_plan_fits_shared_memory(kh, kw, cout):
    """Every channel tile, filters up to 5 wide under their templates and
    wider ones under the any-width one (7x7 up to 64 channels), within a
    block's shared memory; the ragged shape of the GPU tests."""
    p = pt_kernel.plan(2, 24, 37, 5, cout, kh, kw, SMS)
    _check_plan(p, 2, 24, 37, 5, cout, kh, kw)


def test_plan_refuses_what_the_kernel_does_not_take():
    with pytest.raises(ValueError, match="shared memory"):
        pt_kernel.plan(1, 8, 8, 4, 64, 40, 5, SMS)
    with pytest.raises(ValueError, match="shared memory"):
        pt_kernel.plan(1, 8, 8, 4, 64, 9, 9, SMS)
    with pytest.raises(ValueError, match="filter"):
        pt_kernel.plan(1, 8, 8, 4, 4, 0, 3, SMS)
