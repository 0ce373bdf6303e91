"""The port's flash attention on the CPU (its plain version and its
backward) against the JAX package, on the same numpy inputs, fp32.

- ``ops.flash_attention`` against the JAX ``flash_attention`` (the Pallas
  kernel in interpret mode): the cases of the JAX package's own kernel
  test (causal and full, softcap 0 and 30, (B, S, NQ, NKV, H) =
  (2, 256, 4, 2, 64) and (1, 512, 8, 8, 32)) and a ragged grouped one, S
  200 with G 8 at H 128.  rtol = atol = 2e-4, the JAX test's tolerance.
  The JAX kernel is given blocks that divide its rows (100 for S 200): in
  interpret mode it reads NaN past a partial block.
- the log-sum-exp the forward saves against ``jax.nn.logsumexp`` of the
  JAX oracle's masked scores (1e-5: fp32 sums in another order).
- the gradients (dq, dk, dv) of both of the port's attention impls
  against ``jax.grad`` of the JAX ``chunked_attention`` (the gradient the
  JAX package trains with; its Pallas forward has none), causal and full,
  softcap 0 and 30, KV chunks that do not divide S: 1e-4.

The CUDA kernel itself runs only on the card (tests/test_torch_gpu.py).
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro.kernels.flash_attention import ops as jax_fa_ops
from repro.kernels.flash_attention import ref as jax_fa_ref
from repro.models.attention import chunked_attention as jax_chunked
from repro_torch.kernels.flash_attention import kernel as pt_kernel
from repro_torch.kernels.flash_attention import ops as pt_ops
from repro_torch.kernels.flash_attention import ref as pt_ref
from repro_torch.models.attention import chunked_attention

TOL = dict(rtol=2e-4, atol=2e-4)
GRAD_TOL = dict(rtol=1e-4, atol=1e-4)


def _qkv(B, S, NQ, NKV, H, seed):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((B, S, NQ, H)).astype(np.float32),
            rng.standard_normal((B, S, NKV, H)).astype(np.float32),
            rng.standard_normal((B, S, NKV, H)).astype(np.float32))


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("softcap", [0.0, 30.0])
@pytest.mark.parametrize("shape", [(2, 256, 4, 2, 64), (1, 512, 8, 8, 32),
                                   (1, 200, 8, 1, 128)])
def test_flash_attention_matches_jax_kernel(causal, softcap, shape):
    q, k, v = _qkv(*shape, seed=sum(shape))
    got = pt_ops.flash_attention(torch.from_numpy(q), torch.from_numpy(k),
                                 torch.from_numpy(v), causal=causal,
                                 softcap=softcap)
    block = 128 if shape[1] % 128 == 0 else 100
    want = jax_fa_ops.flash_attention(jnp.asarray(q), jnp.asarray(k),
                                      jnp.asarray(v), causal=causal,
                                      softcap=softcap, block_q=block,
                                      block_kv=block)
    assert got.shape == want.shape and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("softcap", [0.0, 30.0])
def test_lse_matches_jax_logsumexp(causal, softcap):
    """Grouped layout, G 4: row r is query column r % Sq."""
    B, S, NQ, NKV, H = 2, 48, 8, 2, 32
    q, k, v = _qkv(B, S, NQ, NKV, H, seed=3)
    qg, kg, vg, _ = pt_ops._group(*map(torch.from_numpy, (q, k, v)))
    out, lse = pt_ref.flash_fwd(qg, kg, vg, causal=causal, softcap=softcap,
                                sq_real=S)
    assert lse.dtype == torch.float32 and lse.shape == qg.shape[:2]
    jq, jk, jv, _ = jax_fa_ops._group(jnp.asarray(q), jnp.asarray(k),
                                      jnp.asarray(v))
    s = jnp.einsum("brh,bkh->brk", jq, jk) * H ** -0.5
    if softcap:
        s = softcap * jnp.tanh(s / softcap)
    if causal:
        rows = jnp.arange(jq.shape[1]) % S
        s = jnp.where(jnp.arange(S)[None, :] <= rows[:, None], s, -1e30)
    np.testing.assert_allclose(lse.numpy(),
                               np.asarray(jax.nn.logsumexp(s, axis=-1)),
                               rtol=1e-5, atol=1e-5)
    want = jax_fa_ref.attention(*jax_fa_ops._oracle_expand(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))[:3], causal=causal,
        softcap=softcap)
    want = np.asarray(want).reshape(B, NQ, S, H).transpose(0, 2, 1, 3)
    np.testing.assert_allclose(pt_ops._ungroup(out, (B, NKV, NQ // NKV, S,
                                                     H)).numpy(), want,
                               **TOL)


def _jax_grads(q, k, v, w, *, causal, softcap, kv_chunk):
    def loss(q, k, v):
        out = jax_chunked(q, k, v, causal=causal, softcap=softcap,
                          kv_chunk=kv_chunk)
        return jnp.sum(out * w)
    return jax.grad(loss, argnums=(0, 1, 2))(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))


@pytest.mark.parametrize("impl", ["reference", "pallas"])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("softcap", [0.0, 30.0])
def test_attention_grads_match_jax(impl, causal, softcap):
    """S 40 in KV chunks of 16 (the last one padded), G 2."""
    B, S, NQ, NKV, H, chunk = 2, 40, 4, 2, 32, 16
    q, k, v = _qkv(B, S, NQ, NKV, H, seed=11)
    w = np.random.default_rng(12).standard_normal(
        (B, S, NQ, H)).astype(np.float32)
    tq, tk, tv = (torch.from_numpy(a).requires_grad_(True)
                  for a in (q, k, v))
    if impl == "reference":
        out = chunked_attention(tq, tk, tv, causal=causal, softcap=softcap,
                                kv_chunk=chunk)
    else:
        out = pt_ops.flash_attention(tq, tk, tv, causal=causal,
                                     softcap=softcap)
    (out * torch.from_numpy(w)).sum().backward()
    want = _jax_grads(q, k, v, jnp.asarray(w), causal=causal,
                      softcap=softcap, kv_chunk=chunk)
    for got, ref_grad in zip((tq.grad, tk.grad, tv.grad), want):
        np.testing.assert_allclose(got.numpy(), np.asarray(ref_grad),
                                   **GRAD_TOL)


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("chunk", [7, 16, 64])
def test_flash_backward_is_chunk_invariant(causal, chunk):
    """The grouped backward (G 4, Sq 24) in chunks of 7, 16 and 64 KV rows
    gives the gradients of one chunk (1e-5: fp32 sums in another order);
    the causal skip of whole chunks changes nothing."""
    q, k, v = (torch.from_numpy(a) for a in _qkv(1, 24, 8, 2, 32, seed=5))
    qg, kg, vg, _ = pt_ops._group(q, k, v)
    out, lse = pt_ref.flash_fwd(qg, kg, vg, causal=causal, sq_real=24)
    dout = torch.from_numpy(np.random.default_rng(6).standard_normal(
        out.shape).astype(np.float32))
    kw = dict(causal=causal, softcap=0.0, sq_real=24)
    want = pt_ops.flash_backward(qg, kg, vg, out, lse, dout, kv_chunk=1024,
                                 **kw)
    got = pt_ops.flash_backward(qg, kg, vg, out, lse, dout, kv_chunk=chunk,
                                **kw)
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, rtol=1e-5, atol=1e-5)


def test_bf16_inputs_give_bf16_out_and_grads():
    q, k, v = (torch.from_numpy(a).bfloat16().requires_grad_(True)
               for a in _qkv(1, 33, 4, 2, 64, seed=8))
    out = pt_ops.flash_attention(q, k, v, causal=True)
    assert out.dtype == torch.bfloat16
    out.float().sum().backward()
    assert all(t.grad.dtype == torch.bfloat16 and
               bool(torch.isfinite(t.grad.float()).all()) for t in (q, k, v))


def test_non_cpu_tensor_launches_the_kernel_or_raises(monkeypatch):
    class Launched(Exception):
        pass

    def launched(*args, **kwargs):
        raise Launched

    monkeypatch.setattr(pt_kernel, "flash_fwd", launched)
    monkeypatch.setattr(pt_ref, "flash_fwd", launched)
    q = torch.zeros((1, 16, 4, 64), device="meta")
    k = torch.zeros((1, 16, 2, 64), device="meta")
    with pytest.raises(Launched):
        pt_ops.flash_attention(q, k, k, causal=True)


def test_kernel_wrapper_refuses_cpu_tensors():
    before = pt_kernel.flash_fwd.launches
    x = torch.zeros((2, 16, 64))
    with pytest.raises(RuntimeError):
        pt_kernel.flash_fwd(x, x, x)
    assert pt_kernel.flash_fwd.launches == before
