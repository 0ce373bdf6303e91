"""The port's GEMM on the CPU (its plain version) against the JAX
package's ``gemm`` (the Pallas kernel in interpret mode) on the same
numpy inputs, M and N not multiples of the 128 tile.  The JAX kernel
takes a ragged K only when ``bk`` divides it (a partial K block reads
padding), so K is a multiple of ``bk`` or below it.

Each element is held to a tolerance relative to the scale of its own
sum, ``(|a| @ |b|)[i, j]`` (a dot product's rounding error grows with
the sum of its terms' magnitudes, not with its possibly cancelled
result).  fp32: 1e-5.  fp64, with x64 on: against JAX's ``a @ b`` at
1e-12, and against the JAX kernel at 1e-6 only, because that kernel
accumulates in fp32 (the port's kernel accumulates in fp64).

``kernel.plan``, what the CUDA kernel launches, is checked on the host:
four distinct block tiles a dtype that grow with the block multiplier,
fp64 on the tensor cores (DMMA) and fp32 on the CUDA cores (SIMT), a
grid that covers M and N (ragged, and M, N or K of 1) and shared memory
within the 227 KB a block may take."""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro.kernels.gemm import ops as jax_ops
from repro_torch.kernels.gemm import kernel as pt_kernel
from repro_torch.kernels.gemm import ops as pt_ops

SHAPES = [(128, 256, 128, 128), (100, 77, 51, 512), (200, 128, 150, 64)]


def _close(got, want, a, b, rtol):
    """|got - want| <= rtol * (|a| @ |b|), element by element."""
    scale = np.abs(a).astype(np.float64) @ np.abs(b).astype(np.float64)
    err = np.abs(np.asarray(got, np.float64) - np.asarray(want, np.float64))
    assert got.shape == want.shape
    assert (err <= rtol * scale).all(), (err / scale).max()


def _inputs(M, K, N, dtype, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((M, K)).astype(dtype),
            rng.standard_normal((K, N)).astype(dtype))


@pytest.mark.parametrize("M,K,N,bk", SHAPES)
@pytest.mark.parametrize("mult", [1, 2])
def test_sgemm_matches_jax(M, K, N, bk, mult):
    a, b = _inputs(M, K, N, np.float32)
    got = pt_ops.gemm(torch.from_numpy(a), torch.from_numpy(b),
                      block_multiplier=mult, bk=bk)
    want = jax_ops.gemm(jnp.asarray(a), jnp.asarray(b),
                        block_multiplier=mult, bk=bk)
    assert got.dtype == torch.float32 and got.shape == (M, N)
    _close(got.numpy(), np.asarray(want), a, b, 1e-5)


@pytest.mark.parametrize("M,K,N,bk", SHAPES[:2])
def test_dgemm_matches_jax_x64(M, K, N, bk):
    a, b = _inputs(M, K, N, np.float64, seed=1)
    got = pt_ops.gemm(torch.from_numpy(a), torch.from_numpy(b),
                      block_multiplier=2, bk=bk)
    assert got.dtype == torch.float64
    with jax.enable_x64(True):
        ja, jb = jnp.asarray(a), jnp.asarray(b)
        exact = np.asarray(ja @ jb)
        tpu = np.asarray(jax_ops.gemm(ja, jb, block_multiplier=2, bk=bk))
    assert exact.dtype == tpu.dtype == np.float64
    _close(got.numpy(), exact, a, b, 1e-12)
    _close(got.numpy(), tpu, a, b, 1e-6)


def test_out_dtype_casts():
    a, b = _inputs(16, 8, 4, np.float64)
    got = pt_ops.gemm(torch.from_numpy(a), torch.from_numpy(b),
                      out_dtype=torch.float32)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), (a @ b).astype(np.float32),
                               rtol=1e-6)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16,
                                   torch.int32])
def test_other_types_raise(dtype):
    a = torch.ones((8, 8), dtype=dtype)
    with pytest.raises(ValueError):
        pt_ops.gemm(a, a)


@pytest.mark.parametrize("mult", [0, 1, 3, 8, 16])
def test_block_multiplier_validation_matches(mult):
    a, b = _inputs(16, 16, 16, np.float32)
    outcomes = []
    for call in (lambda: jax_ops.gemm(jnp.asarray(a), jnp.asarray(b),
                                      block_multiplier=mult),
                 lambda: pt_ops.gemm(torch.from_numpy(a), torch.from_numpy(b),
                                     block_multiplier=mult)):
        try:
            call()
            outcomes.append(None)
        except ValueError:
            outcomes.append(ValueError)
    assert outcomes[0] == outcomes[1]


def test_kernel_wrapper_refuses_cpu_tensors():
    a = torch.ones((8, 8))
    before = pt_kernel.gemm.launches
    with pytest.raises(RuntimeError):
        pt_kernel.gemm(a, a)
    assert pt_kernel.gemm.launches == before


@pytest.mark.parametrize("dtype,path", [(torch.float64, pt_kernel.DMMA),
                                        (torch.float32, pt_kernel.SIMT)])
def test_plan_tiles_grow_with_the_multiplier(dtype, path):
    plans = [pt_kernel.plan(4096, 4096, 4096, dtype, m) for m in (1, 2, 4, 8)]
    tiles = [p.tile for p in plans]
    assert all(p.path == path for p in plans)
    assert len(set(tiles)) == 4
    for (bm, bn, bk), (bm2, bn2, bk2) in zip(tiles, tiles[1:]):
        assert bm2 >= bm and bn2 >= bn and bm2 * bn2 > bm * bn
    assert all(p.smem <= pt_kernel.SMEM_LIMIT and p.stages >= 2
               for p in plans)


@pytest.mark.parametrize("M,N,K", [(1000, 777, 515), (1, 1, 1), (1, 300, 7),
                                   (300, 1, 7), (300, 200, 1),
                                   (4096, 4096, 4096)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("mult", [1, 2, 4, 8])
def test_plan_grid_covers_the_output(M, N, K, dtype, mult):
    plan = pt_kernel.plan(M, N, K, dtype, mult)
    bm, bn, _ = plan.tile
    gn, gm = plan.grid
    assert (gn - 1) * bn < N <= gn * bn
    assert (gm - 1) * bm < M <= gm * bm


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.int32])
def test_plan_refuses_other_types(dtype):
    with pytest.raises(ValueError):
        pt_kernel.plan(8, 8, 8, dtype, 1)
