"""The port's dense-cache decode on the CPU against the JAX package, on the
same numpy inputs.

- ``ops.flash_decode`` (its plain version) against the JAX
  ``flash_decode`` (the Pallas ``_decode_kernel`` in interpret mode, with
  ``block_kv`` 128): the JAX kernel test's shapes (B 2, S 512, 4/2 heads,
  H 64, valid [100, 512] and [1, 333]), then H 128, G 1 and 8, softcap 30
  and a row with no valid key, which must come out exactly zero.  fp32,
  rtol = atol = 2e-4, the JAX test's tolerance.
- the model's ``_full_attention_with_cache`` against the JAX one, Sq 1
  and 4, ragged positions and a fully masked row: fp32 (1e-5), bf16
  (one bf16 ulp: rtol 8e-3, atol 1e-4), and fp32 queries over a bf16
  cache, where only the reference's rounding of ``p`` to the cache's
  dtype before P.V gives 1e-5.  The per-query length fold
  (``query_lens``) that the card path feeds the kernel against the
  reference's mask.
- ``ContinuousBatchingEngine(paged_kernel=False)`` against ``(True)`` and
  against the JAX engine with ``paged_kernel=False``, token for token, on
  reduced granite-3-2b and qwen3-1.7b (tests/test_kernels_paged.py's
  engine case); the static engine gives the same tokens.  With ``False``
  every forward takes the dense-cache attention once a layer and the
  paged one never; with ``True`` the reverse.
- a tensor off the CPU launches the kernel or raises; the kernel's
  wrapper refuses CPU tensors.
- the kernel's KV split: ``ref.flash_decode_split`` (per-split partials
  folded in rank order) against the JAX ``flash_decode`` (Pallas,
  interpret) at every forced count 1-8, softcap 0 and 30, rows of length
  0, 1, 32, ragged and full (fp32, 2e-4); ``kernel.decode_plan`` at the
  served shapes and under the tests' override.

The CUDA kernel itself runs only on the card (tests/test_torch_gpu.py).
"""
import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro.configs import reduced_config as jax_reduced_config
from repro.kernels.flash_attention import ops as jax_fa_ops
from repro.models import attention as jax_attention
from repro.models import build_model as jax_build_model
from repro.serve import ContinuousBatchingEngine as JaxEngine
from repro_torch.configs import reduced_config
from repro_torch.kernels.flash_attention import kernel as pt_kernel
from repro_torch.kernels.flash_attention import ops as pt_ops
from repro_torch.kernels.flash_attention import ref as pt_ref
from repro_torch.models import attention
from repro_torch.models.model import LM
from repro_torch.serve.engine import ContinuousBatchingEngine, StaticBatchEngine
from repro_torch.weights import params_from_numpy

TOL = dict(rtol=2e-4, atol=2e-4)


def _qkv(B, Sq, S, NQ, NKV, H, seed):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((B, Sq, NQ, H)).astype(np.float32),
            rng.standard_normal((B, S, NKV, H)).astype(np.float32),
            rng.standard_normal((B, S, NKV, H)).astype(np.float32))


# ---------------------------------------------------------------------------
# the op against the Pallas decode kernel
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("S,NQ,NKV,H,valid,softcap", [
    (512, 4, 2, 64, [100, 512], 0.0),       # the JAX kernel test's cases
    (512, 4, 2, 64, [1, 333], 0.0),
    (256, 4, 2, 128, [129, 256], 0.0),      # qwen3's head width
    (256, 4, 4, 64, [77, 200], 0.0),        # G 1
    (256, 8, 1, 32, [256, 31], 0.0),        # G 8, the reduced head width
    (384, 4, 2, 64, [300, 5], 30.0),        # softcap
    (256, 4, 2, 64, [0, 130], 0.0),         # a row with no valid key
])
def test_flash_decode_matches_jax_kernel(S, NQ, NKV, H, valid, softcap):
    q, k, v = _qkv(2, 1, S, NQ, NKV, H, seed=S + NQ + H)
    kv_valid = np.asarray(valid, np.int32)
    got = pt_ops.flash_decode(torch.from_numpy(q), torch.from_numpy(k),
                              torch.from_numpy(v),
                              torch.from_numpy(kv_valid), softcap=softcap)
    want = jax_fa_ops.flash_decode(jnp.asarray(q), jnp.asarray(k),
                                   jnp.asarray(v), jnp.asarray(kv_valid),
                                   softcap=softcap, block_kv=128)
    assert got.shape == (2, 1, NQ, H) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    for b, n in enumerate(valid):
        if n == 0:
            assert bool((got[b] == 0).all())


def test_flash_decode_bf16_keeps_q_dtype():
    q, k, v = (torch.from_numpy(a).bfloat16()
               for a in _qkv(2, 1, 64, 4, 2, 64, seed=3))
    out = pt_ops.flash_decode(q, k, v, torch.tensor([10, 64]))
    assert out.dtype == torch.bfloat16 and out.shape == (2, 1, 4, 64)
    want = pt_ops.flash_decode(q.float(), k.float(), v.float(),
                               torch.tensor([10, 64]))
    torch.testing.assert_close(out.float(), want, rtol=8e-3, atol=1e-4)


# ---------------------------------------------------------------------------
# the model's dense-cache attention against the reference's
# ---------------------------------------------------------------------------
def _attention_case(Sq, seed):
    """B 3 rows over a 40-token cache, 4 query heads on 2 KV heads, H 32:
    ragged per-row positions, the last row fully masked (kv_valid 0)."""
    B, S, NQ, NKV, H = 3, 40, 4, 2, 32
    q, k, v = _qkv(B, Sq, S, NQ, NKV, H, seed)
    start = np.array([5, 30, 0])
    positions = (start[:, None] + np.arange(Sq)[None]).astype(np.int32)
    kv_valid = np.array([5 + Sq, 30 + Sq - 1, 0], np.int32)
    return q, k, v, positions, kv_valid


def _both(q, k, v, positions, kv_valid, softcap, q_dtype, kv_dtype):
    jq = jnp.asarray(q, q_dtype)
    jk, jv = jnp.asarray(k, kv_dtype), jnp.asarray(v, kv_dtype)
    want = jax_attention._full_attention_with_cache(
        jq, jk, jv, positions=jnp.asarray(positions),
        kv_valid_len=jnp.asarray(kv_valid), softcap=softcap)
    tq = {jnp.float32: torch.float32, jnp.bfloat16: torch.bfloat16}
    got = attention._full_attention_with_cache(
        torch.from_numpy(q).to(tq[q_dtype]),
        torch.from_numpy(k).to(tq[kv_dtype]),
        torch.from_numpy(v).to(tq[kv_dtype]),
        positions=torch.from_numpy(positions).long(),
        kv_valid_len=torch.from_numpy(kv_valid), softcap=softcap)
    return got, np.asarray(want.astype(jnp.float32))


@pytest.mark.parametrize("Sq", [1, 4])
@pytest.mark.parametrize("softcap", [0.0, 30.0])
@pytest.mark.parametrize("q_dtype,kv_dtype,rtol,atol", [
    (jnp.float32, jnp.float32, 1e-5, 1e-5),
    (jnp.bfloat16, jnp.bfloat16, 8e-3, 1e-4),
    (jnp.float32, jnp.bfloat16, 1e-5, 1e-5)])
def test_full_attention_with_cache_matches_jax(Sq, softcap, q_dtype,
                                               kv_dtype, rtol, atol):
    """Every row, the fully masked one included (the uniform mean of v).
    fp32 queries over a bf16 cache come out in fp32: 1e-5 holds only if
    ``p`` is rounded to bf16 before P.V, as the reference does."""
    got, want = _both(*_attention_case(Sq, seed=Sq), softcap, q_dtype,
                      kv_dtype)
    assert got.shape == want.shape
    np.testing.assert_allclose(got.float().numpy(), want, rtol=rtol,
                               atol=atol)
    # the masked row is the mean of v over the cache, not zero
    assert float(got[2].float().abs().max()) > 0


@pytest.mark.parametrize("Sq", [1, 4])
def test_query_lens_fold_matches_the_reference_mask(Sq):
    """The kernel's contract on the per-query lengths (its plain version,
    fp32 p) against the reference's masked attention: equal on every
    query with a valid key, zero where the reference averages v."""
    q, k, v, positions, kv_valid = _attention_case(Sq, seed=10 + Sq)
    tpos = torch.from_numpy(positions).long()
    tvalid = torch.from_numpy(kv_valid)
    lens = attention.query_lens(tpos, tvalid, k.shape[1])
    want_lens = np.minimum(positions + 1, kv_valid[:, None]).clip(0, 40)
    np.testing.assert_array_equal(lens.numpy(), want_lens)
    assert lens.dtype == torch.int32
    got = pt_ref.flash_decode(torch.from_numpy(q), torch.from_numpy(k),
                              torch.from_numpy(v), lens)
    ref = attention._full_attention_with_cache(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
        positions=tpos, kv_valid_len=tvalid, softcap=0.0)
    live = torch.from_numpy(want_lens > 0)
    torch.testing.assert_close(got[live], ref[live], rtol=1e-5, atol=1e-5)
    assert bool((got[~live] == 0).all()) and int((~live).sum()) == Sq
    # a length past the cache reads no further than the cache
    long_lens = attention.query_lens(tpos + 100, tvalid + 100, k.shape[1])
    assert int(long_lens.max()) == k.shape[1]


# ---------------------------------------------------------------------------
# the engine's paged_kernel option against the JAX engine
# ---------------------------------------------------------------------------
REQUESTS = [(12, 5), (6, 4), (9, 3)]
PAGE = 8


def _count_calls(monkeypatch):
    calls = {"paged": 0, "dense": 0}
    for name, key in (("_paged_attention_with_cache", "paged"),
                      ("_full_attention_with_cache", "dense")):
        fn = getattr(attention, name)

        def counted(*a, _fn=fn, _key=key, **kw):
            calls[_key] += 1
            return _fn(*a, **kw)
        monkeypatch.setattr(attention, name, counted)
    return calls


@pytest.mark.parametrize("arch", ["granite-3-2b", "qwen3-1.7b"])
def test_paged_kernel_off_matches_on_and_jax(arch, monkeypatch):
    """The port of tests/test_kernels_paged.py's engine case: greedy
    tokens with the paged kernel on and off, on the port and on the JAX
    engine with it off; and the static engine.  Counts which attention
    each forward took."""
    jcfg = jax_reduced_config(arch)
    jmodel = jax_build_model(jcfg)
    jparams = jmodel.init_params(jax.random.key(0))
    model = LM(reduced_config(arch), device="cpu")
    params = params_from_numpy(jax.tree.map(np.asarray, jparams),
                               device="cpu")
    rng = np.random.default_rng(4)
    prompts = [rng.integers(1, jcfg.vocab_size, size=n) for n, _ in REQUESTS]

    jeng = JaxEngine(jmodel, jparams, n_slots=2, max_len=32, page_size=PAGE,
                     prefill_chunk=4, paged_kernel=False)
    jrids = [jeng.submit(p, g) for p, (_, g) in zip(prompts, REQUESTS)]
    jout = jeng.run()
    want = [np.asarray(jout[r]) for r in jrids]

    calls = _count_calls(monkeypatch)
    for paged in (True, False):
        calls.update(paged=0, dense=0)
        eng = ContinuousBatchingEngine(model, params, n_slots=2, max_len=32,
                                       page_size=PAGE, prefill_chunk=4,
                                       paged_kernel=paged)
        assert eng.paged_kernel is paged
        rids = [eng.submit(p, g) for p, (_, g) in zip(prompts, REQUESTS)]
        out = eng.run()
        for i, (rid, w) in enumerate(zip(rids, want)):
            np.testing.assert_array_equal(
                out[rid], w, err_msg=f"{arch} paged_kernel={paged}: "
                                     f"request {i}")
        per_layer = model.cfg.n_layers * eng.stats.forwards
        assert (calls["paged"], calls["dense"]) == (
            (per_layer, 0) if paged else (0, per_layer))
    assert ContinuousBatchingEngine(model, params, n_slots=2,
                                    max_len=32).paged_kernel is True
    calls.update(paged=0, dense=0)
    static = StaticBatchEngine(model, params, max_len=32, batch=1)
    for p, (_, g), w in zip(prompts, REQUESTS, want):
        np.testing.assert_array_equal(static.generate(p[None], g)[0].numpy(),
                                      w)
    # the static decode steps enter no paged context
    assert calls["paged"] == 0
    assert calls["dense"] == model.cfg.n_layers * sum(
        g - 1 for _, g in REQUESTS)


# ---------------------------------------------------------------------------
# dispatch
# ---------------------------------------------------------------------------
def test_non_cpu_tensor_launches_the_kernel_or_raises(monkeypatch):
    class Launched(Exception):
        pass

    def launched(*args, **kwargs):
        raise Launched

    monkeypatch.setattr(pt_kernel, "flash_decode", launched)
    monkeypatch.setattr(pt_ref, "flash_decode", launched)
    q = torch.zeros((2, 1, 4, 64), device="meta")
    k = torch.zeros((2, 16, 2, 64), device="meta")
    with pytest.raises(Launched):
        pt_ops.flash_decode(q, k, k, torch.zeros(2, dtype=torch.int32,
                                                  device="meta"))
    # the model's dense-cache attention off the CPU is the kernel too
    with pytest.raises(Launched):
        attention._full_attention_with_cache(
            q, k, k, positions=torch.zeros((2, 1), dtype=torch.long,
                                           device="meta"),
            kv_valid_len=torch.ones(2, dtype=torch.int32, device="meta"),
            softcap=0.0)


def test_kernel_wrapper_refuses_cpu_tensors():
    before = pt_kernel.flash_decode.launches
    q = torch.zeros((2, 1, 4, 64))
    k = torch.zeros((2, 16, 2, 64))
    with pytest.raises(RuntimeError):
        pt_kernel.flash_decode(q, k, k, torch.ones((2, 1), dtype=torch.int32))
    assert pt_kernel.flash_decode.launches == before


# ---------------------------------------------------------------------------
# the KV split over a thread-block cluster and its plan
# ---------------------------------------------------------------------------
SMS = 132               # an H100 SXM's SMs
SPLIT_S = 256           # 8 tiles of 32 tokens: every split count up to 8
SPLIT_VALID = [0, 1, 32, 77, SPLIT_S]   # empty, one, a tile edge, ragged, full


@functools.lru_cache(maxsize=None)
def _split_case(softcap):
    """fp32 inputs (B 5, 4/2 heads, H 64) and the JAX kernel's output."""
    q, k, v = _qkv(len(SPLIT_VALID), 1, SPLIT_S, 4, 2, 64, seed=31)
    valid = np.asarray(SPLIT_VALID, np.int32)
    want = jax_fa_ops.flash_decode(jnp.asarray(q), jnp.asarray(k),
                                   jnp.asarray(v), jnp.asarray(valid),
                                   softcap=softcap, block_kv=128)
    return q, k, v, valid, np.asarray(want)


@pytest.mark.parametrize("softcap", [0.0, 30.0])
@pytest.mark.parametrize("forced", range(1, 9))
def test_flash_decode_split_matches_jax_kernel(forced, softcap):
    """The kernel's split, emulated, at every forced count: splits wholly
    past a row's length hold the neutral partial, which the rank-order
    fold adds exactly, so the row with no valid key is exactly 0."""
    q, k, v, valid, want = _split_case(softcap)
    plan = pt_kernel.decode_plan(len(valid), 1, 4, 2, 64, SPLIT_S, 4, SMS,
                                 forced)
    assert plan.splits == forced or (forced > 4 and plan.splits in (4, 8))
    got = pt_ref.flash_decode_split(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
        torch.from_numpy(valid), splits=plan.splits,
        tokens_per_split=plan.tokens_per_split, softcap=softcap)
    np.testing.assert_allclose(got.numpy(), want, **TOL)
    assert bool((got[0] == 0).all())
    # the split twin and the unsplit plain version: the same function
    torch.testing.assert_close(got, pt_ref.flash_decode(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
        torch.from_numpy(valid), softcap=softcap), rtol=1e-5, atol=1e-5)


# (B, Sq, NQ, NKV, H, S_cache, elem) -> (rows, slices, splits, tokens)
DECODE_PLANS = {
    "qwen3_static_decode": ((8, 1, 16, 8, 128, 2088, 2), (2, 1, 2, 1056)),
    "granite_6c_static_decode": ((8, 1, 32, 8, 64, 552, 2), (4, 1, 2, 288)),
    "qwen3_decode_64_slots": ((64, 1, 16, 8, 128, 2088, 2),
                              (2, 1, 1, 2112)),
    "qwen3_sq32_prefill": ((8, 32, 16, 8, 128, 2088, 2), (8, 8, 1, 2112)),
    "fp32_h128_g8": ((5, 1, 16, 2, 128, 200, 4), (8, 1, 7, 32)),
    "one_tile": ((1, 1, 1, 1, 32, 16, 4), (1, 1, 1, 32)),
}


@pytest.mark.parametrize("name", DECODE_PLANS)
def test_decode_plan(name):
    """Split only as far as the grid stays within one wave of the blocks
    the SMs hold (one of four warps each an SM: the kernel is issue-bound
    inside an SM), at most 8 and at most the tiles; the Sq 32 prefill row
    keeps its slices and is not split; the split covers the capacity."""
    args, want = DECODE_PLANS[name]
    B, Sq, NQ, NKV, H, S_cache, elem = args
    plan = pt_kernel.decode_plan(*args, SMS)
    assert (plan.rows, plan.slices, plan.splits,
            plan.tokens_per_split) == want
    assert plan.grid == (B * plan.splits, NKV, plan.slices)
    assert plan.tokens_per_split % pt_kernel.DECODE_TILE == 0
    assert plan.tokens_per_split * plan.splits >= S_cache
    assert plan.tokens_per_split * (plan.splits - 1) < S_cache
    blocks = B * NKV * plan.slices
    tiles = -(-S_cache // pt_kernel.DECODE_TILE)
    assert blocks * plan.splits <= SMS * plan.blocks_per_sm or \
        plan.splits == 1
    assert plan.splits in (pt_kernel.DECODE_MAX_SPLITS, tiles) or \
        blocks * (plan.splits + 1) > SMS * plan.blocks_per_sm
    assert pt_kernel.decode_smem_bytes(H, elem, plan.rows) \
        + pt_kernel.BLOCK_RESERVED_BYTES <= pt_kernel.SM_SMEM_BYTES


def test_decode_smem_at_the_served_shapes():
    """208 KB a block at bf16 H 128 (one an SM), 110 KB at H 64 (two by
    shared memory, one by the schedulers)."""
    assert pt_kernel.decode_smem_bytes(128, 2, 2) == 2 * 128 * 4 + 4 * 3 \
        * 2 * 32 * 272
    assert pt_kernel.decode_blocks_per_sm(128, 2, 2) == 1
    assert pt_kernel.SM_SMEM_BYTES // (pt_kernel.decode_smem_bytes(
        64, 2, 4) + pt_kernel.BLOCK_RESERVED_BYTES) == 2
    assert pt_kernel.decode_blocks_per_sm(64, 2, 4) == 1
    assert pt_kernel.decode_warps(128, 4) == 2


@pytest.mark.parametrize("forced", range(1, 9))
def test_decode_plan_override(forced):
    """The tests' override forces a count, still at most the tiles and
    each split whole tiles; outside 1..8 it raises."""
    for args, _ in DECODE_PLANS.values():
        plan = pt_kernel.decode_plan(*args, SMS, forced)
        S_cache = args[5]
        tiles = -(-S_cache // pt_kernel.DECODE_TILE)
        assert plan.splits <= min(forced, tiles)
        per = plan.tokens_per_split // pt_kernel.DECODE_TILE
        assert per == -(-tiles // min(forced, tiles))
        assert plan.splits == -(-tiles // per)
    for bad in (0, 9):
        with pytest.raises(ValueError):
            pt_kernel.decode_plan(8, 1, 16, 8, 128, 2088, 2, SMS, bad)
