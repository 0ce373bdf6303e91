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
What the host can check of it is checked here:

- ``kernel.fwd_plan`` sends bf16 to the tensor cores and fp32 to the CUDA
  cores at every head dim, issues every (bn, query tile) once, heaviest
  first, and the KV tiles each query tile visits hold every (row, kv)
  pair the causal mask keeps while every tile it skips is wholly masked:
  grouped rows that wrap from one query head into the next inside a tile
  (S 1, 63, 200, 4096; G 1, 2, 8).
- a plain emulation of the tensor-core path's arithmetic (bf16 Q K^T
  products summed in fp32, an fp32 online softmax over 64-row KV tiles,
  P split into two bf16 halves for P.V) stays within ``ref.FLASH_TOL`` of
  ``ref.flash_fwd``, while rounding P once to bf16 does not.
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


@pytest.mark.parametrize("H", pt_kernel.HEAD_DIMS)
def test_fwd_plan_path_by_dtype(H):
    """bf16 on the tensor cores (128-row query tiles), fp32 on the CUDA
    cores (64-row tiles: TF32 would miss the fp32 tolerance)."""
    bf = pt_kernel.fwd_plan(3, 400, 200, 200, H, torch.bfloat16, True)
    f32 = pt_kernel.fwd_plan(3, 400, 200, 200, H, torch.float32, True)
    assert (bf.path, bf.block_q, bf.block_kv) == (pt_kernel.TC, 128, 64)
    assert (f32.path, f32.block_q, f32.block_kv) == (pt_kernel.SIMT, 64, 64)
    assert bf.blocks == 3 * 4 and f32.blocks == 3 * 7
    with pytest.raises(ValueError):
        pt_kernel.fwd_plan(3, 400, 200, 200, H, torch.float16, True)


def test_fwd_plan_refuses_other_head_dims():
    with pytest.raises(ValueError):
        pt_kernel.fwd_plan(1, 64, 64, 64, 96, torch.bfloat16, True)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("S", [1, 63, 200, 4096])
def test_fwd_plan_visits_every_kept_pair(S, dtype):
    """Per block: every kv the causal mask keeps for one of its rows lies
    in a visited tile, every skipped tile is wholly masked, and all tiles
    are visited without the mask; each (bn, query tile) comes once."""
    BN = 2
    for G in (1, 2, 8):
        R = G * S
        for causal in (True, False):
            plan = pt_kernel.fwd_plan(BN, R, S, S, 128, dtype, causal)
            bq, bkv = plan.block_q, plan.block_kv
            seen = set()
            for bn, r0, n_kv in plan.tiles:
                assert r0 % bq == 0 and (bn, r0) not in seen
                seen.add((bn, r0))
                if not causal:
                    assert n_kv == -(-S // bkv)
                    continue
                q_pos = np.arange(r0, min(r0 + bq, R)) % S
                # row r keeps kv 0 .. q_pos[r]: the furthest kept kv is the
                # largest query position, and it must sit in the last tile
                assert (n_kv - 1) * bkv <= q_pos.max() < n_kv * bkv
            assert len(seen) == BN * -(-R // bq) == plan.blocks


@pytest.mark.parametrize("S,G", [(128, 2), (4096, 2), (256, 8)])
def test_fwd_plan_issues_the_heaviest_first(S, G):
    """With S a multiple of the query tile, the causal reach never grows
    along the issue order (the train shapes: qwen3's 16/8 heads)."""
    plan = pt_kernel.fwd_plan(8, G * S, S, S, 128, torch.bfloat16, True)
    reach = [n for _, _, n in plan.tiles]
    assert reach == sorted(reach, reverse=True)
    assert reach[0] == S // plan.block_kv


def _emulate_tensor_cores(q, k, v, *, causal, softcap, sq, split):
    """The tensor-core path's arithmetic in plain fp32: bf16 products summed
    in fp32 (exact products, another order of the sum), the online softmax
    over 64-row KV tiles, then P.V with P split into ``p_hi = bf16(p)``
    and ``p_lo = bf16(p - p_hi)`` (``split``) or rounded once to bf16."""
    BN, R, H = q.shape
    Skv = k.shape[1]
    qf, kf, vf = q.float(), k.float(), v.float()
    q_pos = (torch.arange(R) % sq)[:, None]
    m = torch.full((BN, R, 1), pt_ref.NEG_INF)
    l = torch.zeros((BN, R, 1))
    acc = torch.zeros((BN, R, H))
    for kv0 in range(0, Skv, 64):
        kc, vc = kf[:, kv0:kv0 + 64], vf[:, kv0:kv0 + 64]
        s = torch.bmm(qf, kc.transpose(1, 2)) * H ** -0.5
        if softcap:
            s = softcap * torch.tanh(s / softcap)
        if causal:
            kv = torch.arange(kv0, kv0 + kc.shape[1])[None, :]
            s = torch.where(kv <= q_pos, s, pt_ref.NEG_INF)
        m_new = torch.maximum(m, s.amax(-1, keepdim=True))
        corr, p = torch.exp(m - m_new), torch.exp(s - m_new)
        l = l * corr + p.sum(-1, keepdim=True)
        p_hi = p.bfloat16().float()
        pv = torch.bmm(p_hi, vc)
        if split:
            pv = torch.bmm((p - p_hi).bfloat16().float(), vc) + pv
        acc, m = acc * corr + pv, m_new
    denom = l.clamp_min(1e-30)
    return (acc / denom).bfloat16(), (m + torch.log(denom)).squeeze(-1)


def _outside(got, want, rtol, atol):
    err = (got.double() - want.double()).abs()
    return int((err > atol + rtol * want.double().abs()).sum())


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("softcap", [0.0, 30.0])
@pytest.mark.parametrize("S", [1, 63, 200])
def test_tensor_core_arithmetic_within_flash_tol(S, softcap, causal):
    """chip_smoke's short bf16 cases (H 32, 64, 128; G 1, 2, 8; 3 KV
    heads): the split P passes ``FLASH_TOL`` and the lse tolerance at
    every shape; a P rounded once to bf16 puts elements outside it
    whenever a row has more than one key (S 1: p is exactly 1)."""
    rtol, atol = pt_ref.FLASH_TOL[torch.bfloat16]
    for H in (32, 64, 128):
        for G in (1, 2, 8):
            rng = np.random.default_rng(1000 * S + 10 * H + G)
            q, k, v = (torch.from_numpy(rng.standard_normal(shape).astype(
                np.float32)).bfloat16() for shape in
                [(3, G * S, H), (3, S, H), (3, S, H)])
            kw = dict(causal=causal, softcap=softcap, sq=S)
            want, want_lse = pt_ref.flash_fwd(q, k, v, causal=causal,
                                              softcap=softcap, sq_real=S)
            out, lse = _emulate_tensor_cores(q, k, v, split=True, **kw)
            once, _ = _emulate_tensor_cores(q, k, v, split=False, **kw)
            assert _outside(out.float(), want.float(), rtol, atol) == 0
            assert _outside(lse, want_lse, *pt_ref.LSE_TOL) == 0
            missed = _outside(once.float(), want.float(), rtol, atol)
            assert missed > 0 if S > 1 else missed == 0, (H, G, missed)
