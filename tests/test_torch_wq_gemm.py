"""The port's weight-only int8 GEMM (``repro_torch.kernels.wq_gemm``) on the
CPU against the JAX package, with the same inputs made by numpy.

- ``quantize`` equal to ``repro.kernels.wq_gemm.ref.quantize`` bit for bit
  (int8 q and fp32 scale), fp32 and bf16 weights, odd shapes included, and
  of an (E, K, N) expert stack to the reference's ``quant_dense``.
- ``ops.wq_gemm`` (a CPU tensor: the plain version) against the JAX op
  ``wq_ops.wq_gemm`` (its Pallas kernel in interpret mode) at
  ``tests/test_quant.py``'s shapes and block multipliers, ``rtol = atol =
  2e-4`` as there; and against the JAX plain version at ragged shapes
  (M 1, 7, 8, 33; K and N not multiples of a tile), fp32 within 2e-4 and
  bf16 within one bf16 ulp (the two frameworks sum in another order).
- The transposed layout (``q_transposed``: the tied unembed's (V, d)
  table read in place) against the reference ``layers.unembed`` of a
  quantized table.
- The kernel's launch plan (which kernel each dtype and M takes; the
  GEMV's K split and wgmma's tiles cover M, N and K) and its argument
  checks, which run here.
"""
import numpy as np
import pytest

import jax.numpy as jnp
import torch

from repro.kernels.wq_gemm import ops as jax_wq_ops
from repro.kernels.wq_gemm import ref as jax_wq_ref
from repro.models import layers as jax_layers
from repro.models.quant import quant_dense as jax_quant_dense
from repro.models.quant import quant_table as jax_quant_table
from repro_torch.kernels.wq_gemm import kernel as wq_kernel
from repro_torch.kernels.wq_gemm import ops as wq_ops
from repro_torch.kernels.wq_gemm import ref as wq_ref
from repro_torch.weights import tensor_from_numpy

TOL = dict(rtol=2e-4, atol=2e-4)
RAGGED = [(1, 37, 61), (7, 130, 9), (8, 256, 200), (33, 300, 257)]


def _inputs(M, K, N, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((M, K)).astype(np.float32),
            rng.standard_normal((K, N)).astype(np.float32))


def _bf16_ulp(v):
    """One bf16 ulp at each |v| (8 significant bits)."""
    a = np.maximum(np.abs(v.astype(np.float64)), np.finfo(np.float32).tiny)
    return 2.0 ** (np.floor(np.log2(a)) - 7)


@pytest.mark.parametrize("shape", [(128, 256, 128), (256, 128, 384),
                                   (7, 37, 61), (5, 300, 1)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_quantize_is_bitwise_the_jax_quantizer(shape, dtype):
    _, K, N = shape
    _, w = _inputs(1, K, N, seed=K + N)
    w = w * np.linspace(1e-3, 3.0, N, dtype=np.float32)   # varied scales
    w[:, 0] = 0.0                                          # the 1e-8 floor
    jw = jnp.asarray(w, dtype=getattr(jnp, dtype))
    jq, js = jax_wq_ref.quantize(jw)
    q, s = wq_ops.quantize(tensor_from_numpy(np.asarray(jw), "cpu"))
    assert q.dtype == torch.int8 and s.dtype == torch.float32
    np.testing.assert_array_equal(q.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(s.numpy().view(np.uint32),
                                  np.asarray(js).view(np.uint32))


@pytest.mark.parametrize("shape", [(4, 37, 61), (2, 128, 1)])
def test_quantize_of_an_expert_stack_is_the_jax_quant_dense(shape):
    """(E, K, N): one scale per (expert, output column), as the reference's
    ``quant_dense`` of an MoE weight, bit for bit."""
    w = np.random.default_rng(sum(shape)).standard_normal(shape).astype(
        np.float32)
    w[0, :, 0] = 0.0
    want = jax_quant_dense(jnp.asarray(w))
    q, s = wq_ref.quantize(torch.from_numpy(w))
    assert q.shape == shape and s.shape == (shape[0], shape[2])
    np.testing.assert_array_equal(q.numpy(), np.asarray(want["q"]))
    np.testing.assert_array_equal(s.numpy().view(np.uint32),
                                  np.asarray(want["scale"]).view(np.uint32))


@pytest.mark.parametrize("shape", [(128, 256, 128), (256, 128, 384)])
@pytest.mark.parametrize("mult", [1, 2])
def test_plain_matches_the_jax_kernel(shape, mult):
    """tests/test_quant.py::test_wq_gemm_kernel's shapes and multipliers
    (the multipliers are the JAX kernel's tiles: the port's have none)."""
    M, K, N = shape
    x, w = _inputs(M, K, N)
    q, s = wq_ref.quantize(torch.from_numpy(w))
    got = wq_ops.wq_gemm(torch.from_numpy(x), q, s, out_dtype=torch.float32)
    want = jax_wq_ops.wq_gemm(jnp.asarray(x), jnp.asarray(q.numpy()),
                              jnp.asarray(s.numpy()), block_multiplier=mult,
                              bk=128, out_dtype=jnp.float32)
    assert got.dtype == torch.float32 and got.shape == (M, N)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    # and close to the exact fp32 product, as the JAX test holds it
    exact = x @ w
    rel = np.abs(got.numpy() - exact) / (np.abs(exact) + 1.0)
    assert rel.mean() < 0.03


@pytest.mark.parametrize("M,K,N", RAGGED)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_plain_matches_the_jax_plain_at_ragged_shapes(M, K, N, dtype):
    x, w = _inputs(M, K, N, seed=M * K)
    q, s = wq_ref.quantize(torch.from_numpy(w))
    jx = jnp.asarray(x, dtype=getattr(jnp, dtype))
    got = wq_ops.wq_gemm(tensor_from_numpy(np.asarray(jx), "cpu"), q, s)
    want = np.asarray(jax_wq_ref.wq_gemm(jx, jnp.asarray(q.numpy()),
                                         jnp.asarray(s.numpy())))
    assert got.dtype == getattr(torch, dtype)
    got = got.float().numpy()
    want = want.astype(np.float32)
    if dtype == "float32":
        np.testing.assert_allclose(got, want, **TOL)
    else:
        assert np.all(np.abs(got - want) <= _bf16_ulp(want) + 1e-6)


@pytest.mark.parametrize("M,K,N", RAGGED)
def test_transposed_layout_is_the_reference_unembed(M, K, N):
    """q (N, K) with ``q_transposed``: the reference's quantized-table
    unembed, ``(x @ q.T) * scale``, without a transposed copy."""
    x, _ = _inputs(M, K, N, seed=N)
    table = np.random.default_rng(N).standard_normal((N, K)).astype(
        np.float32) * 0.02
    jt = jax_quant_table(jnp.asarray(table))
    want = jax_layers.unembed(jnp.asarray(x)[None], {"table": jt})[0]
    q = torch.from_numpy(np.array(jt["q"]))
    s = torch.from_numpy(np.array(jt["scale"]))
    got = wq_ops.wq_gemm(torch.from_numpy(x), q, s, q_transposed=True)
    assert got.shape == (M, N)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    same = wq_ops.wq_gemm(torch.from_numpy(x), q.T.contiguous(), s)
    np.testing.assert_allclose(got.numpy(), same.numpy(), rtol=1e-6,
                               atol=1e-6)


@pytest.mark.parametrize("M,x_bf16,path", [
    (1, True, wq_kernel.GEMV), (8, True, wq_kernel.GEMV),
    (9, True, wq_kernel.WGMMA), (256, True, wq_kernel.WGMMA),
    (4096, True, wq_kernel.WGMMA), (1, False, wq_kernel.GEMV),
    (8, False, wq_kernel.GEMV), (9, False, wq_kernel.FP32_TILED),
    (4096, False, wq_kernel.FP32_TILED)])
@pytest.mark.parametrize("N,K", [(8192, 2048), (1000, 300)])
def test_plan_picks_the_path_by_dtype_and_m(M, x_bf16, path, N, K):
    """The GEMV up to 8 rows for either x type; above, wgmma for bf16 x
    and the CUDA-core tiled kernel for fp32 x (TF32 would break fp32
    parity)."""
    p = wq_kernel.plan(M, N, K, x_bf16, 132)
    assert p.path == path
    assert p.splits == 1 or path == wq_kernel.GEMV


@pytest.mark.parametrize("M,N,K", [(8, 8192, 2048), (8, 2048, 8192),
                                   (1, 64, 4096), (8, 49408, 2048),
                                   (4, 200, 100), (8, 512, 2048),
                                   (3, 1000, 0)])
@pytest.mark.parametrize("x_bf16", [True, False])
def test_gemv_k_split_covers_k(M, N, K, x_bf16):
    """The GEMV's K split, the same for either x type: every row of K in
    exactly one split, each split a whole number of stages, at most a
    portable cluster of splits, and a split only where the column strips
    leave the card's 132 SMs short."""
    p = wq_kernel.plan(M, N, K, x_bf16, 132)
    assert p.path == wq_kernel.GEMV
    strips = -(-N // wq_kernel.GEMV_BN)
    assert p.blocks == (strips, p.splits)
    assert p.k_per_split % wq_kernel.GEMV_BK == 0
    assert 1 <= p.splits <= wq_kernel.MAX_SPLITS
    assert (p.splits - 1) * p.k_per_split < max(K, 1) <= \
        p.splits * p.k_per_split
    if strips >= 132:
        assert p.splits == 1
    assert wq_kernel.plan(8, 8192, 2048, True, 132).splits == 1
    assert wq_kernel.plan(8, 2048, 8192, True, 132).splits == 4


@pytest.mark.parametrize("M,N", [(9, 1000), (33, 8192), (65, 2048),
                                 (256, 8192), (4096, 8192), (4096, 49408),
                                 (300, 520)])
def test_wgmma_tiles_cover_m_and_n(M, N):
    """wgmma's grid covers M and N with its tile, and the tile is the
    largest whose grid fills the card (the smallest where none does)."""
    p = wq_kernel.plan(M, N, 2048, True, 132)
    bm, bn = wq_kernel.WGMMA_TILES[p.tile]
    assert p.blocks == (-(-N // bn), -(-M // bm))
    assert p.blocks[0] * bn >= N and p.blocks[1] * bm >= M
    fills = [(-(-N // n)) * (-(-M // m)) >= 132
             for m, n in wq_kernel.WGMMA_TILES]
    assert p.tile == (fills.index(True) if any(fills)
                      else len(fills) - 1)


def test_entry_checks_and_the_kernel_refuses_the_cpu():
    x = torch.ones((2, 4))
    q, s = wq_ref.quantize(torch.ones((4, 3)))
    with pytest.raises(RuntimeError, match="CUDA"):
        wq_kernel.wq_gemm(x, q, s)
    assert wq_kernel.wq_gemm.launches == 0
    torch.testing.assert_close(wq_ops.wq_gemm(x, q, s),
                               torch.full((2, 3), 4.0))
