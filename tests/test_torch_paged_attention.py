"""The port's paged attention (plain version, the CPU path) against the
reference: ``repro.kernels.paged_attention.ref`` (the gather oracle) and
``ops.paged_attention(impl="pallas", interpret=True)`` (the TPU kernel in
interpret mode), on the cases of tests/test_kernels_paged.py.  Inputs
are made with numpy from a seed and handed to both packages; everything
is fp32 on the CPU, so the tolerance is fp32 roundoff of a softmax over
<= 32 tokens (2e-5, the reference tests' own).  The CUDA kernel's KV
split is checked here through its host plan (``kernel.split_plan``) and
the plain emulation of the split and its rank-order fold
(``ref.split_partials``); the kernel itself runs only on the card
(tests/test_torch_gpu.py).
"""
import numpy as np
import pytest

import jax.numpy as jnp
import torch

from repro.kernels.paged_attention import ops as jax_ops
from repro.kernels.paged_attention import ref as jax_ref
from repro_torch.kernels.common import require_hopper
from repro_torch.kernels.paged_attention import kernel as pt_kernel
from repro_torch.kernels.paged_attention import ops as pt_ops
from repro_torch.kernels.paged_attention import ref as pt_ref

PAGE = 8
TOL = dict(rtol=2e-5, atol=2e-5)


def _case(B, NQ, NKV, H, pps, valid, *, sq=1, seed=0, permuted=False):
    """numpy q + page pool (B*pps pages), identity or permuted map, and
    the decode positions of the last ``sq`` tokens of each row."""
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((B, sq, NQ, H)).astype(np.float32)
    kp = rng.standard_normal((B * pps, PAGE, NKV, H)).astype(np.float32)
    vp = rng.standard_normal((B * pps, PAGE, NKV, H)).astype(np.float32)
    idx = (rng.permutation(B * pps) if permuted
           else np.arange(B * pps)).reshape(B, pps).astype(np.int32)
    valid = np.asarray(valid, np.int32)
    pos = np.maximum(valid[:, None] - sq + np.arange(sq)[None], 0)
    return q, kp, vp, idx, pos.astype(np.int32), valid


def _jax(q, kp, vp, idx, pos, valid, softcap=0.0):
    args = [jnp.asarray(a) for a in (q, kp, vp, idx, pos, valid)]
    oracle = jax_ref.paged_attention(*args, softcap=softcap)
    pallas = jax_ops.paged_attention(*args, page_size=PAGE, softcap=softcap,
                                     impl="pallas", interpret=True)
    return np.asarray(oracle), np.asarray(pallas)


def _torch(q, kp, vp, idx, pos, valid, softcap=0.0, **kw):
    args = [torch.from_numpy(a) for a in (q, kp, vp, idx, pos, valid)]
    return pt_ops.paged_attention(*args, page_size=PAGE, softcap=softcap,
                                  **kw)


CASES = {
    # every ragged edge on a permuted map: empty row, single token, exact
    # page boundary, last-page partial, full cache
    "ragged_permuted": dict(B=5, NQ=8, NKV=2, H=16, pps=4,
                            valid=[0, 1, 16, 27, 32], permuted=True, seed=3),
    "ragged_identity": dict(B=5, NQ=8, NKV=2, H=16, pps=4,
                            valid=[0, 1, 16, 27, 32], seed=4),
    "gqa_g1_sq4": dict(B=3, NQ=2, NKV=2, H=16, pps=4, valid=[4, 19, 32],
                       sq=4, seed=1),
    "gqa_g4_sq4": dict(B=3, NQ=8, NKV=2, H=16, pps=4, valid=[4, 19, 32],
                       sq=4, seed=4),
    "gqa_g8_sq4": dict(B=3, NQ=16, NKV=2, H=16, pps=4, valid=[4, 19, 32],
                       sq=4, seed=8, permuted=True),
    "softcap": dict(B=2, NQ=4, NKV=2, H=16, pps=4, valid=[13, 32], seed=5,
                    softcap=30.0),
}


@pytest.mark.parametrize("name", sorted(CASES))
def test_plain_matches_reference(name):
    kw = dict(CASES[name])
    softcap = kw.pop("softcap", 0.0)
    inputs = _case(**kw)
    oracle, pallas = _jax(*inputs, softcap=softcap)
    got = _torch(*inputs, softcap=softcap).numpy()
    np.testing.assert_allclose(got, oracle, **TOL)
    np.testing.assert_allclose(got, pallas, **TOL)
    # the port's own gather oracle agrees too
    want = pt_ref.paged_attention(
        *[torch.from_numpy(a) for a in inputs], softcap=softcap).numpy()
    np.testing.assert_allclose(got, want, **TOL)
    assert not np.isnan(got).any()
    empty = np.asarray(kw["valid"]) == 0
    np.testing.assert_array_equal(got[empty], 0.0)


def test_partials_match_pallas_partials():
    """return_partials: (m, l, acc) agree with the TPU kernel's partials
    row for row, including the kv_valid == 0 row (l = 0, acc = 0)."""
    inputs = _case(B=5, NQ=8, NKV=2, H=16, pps=4, valid=[0, 1, 16, 27, 32],
                   sq=2, seed=6, permuted=True)
    m, l, acc = jax_ops.paged_attention(
        *[jnp.asarray(a) for a in inputs], page_size=PAGE, impl="pallas",
        interpret=True, return_partials=True)
    pm, pl_, pacc = _torch(*inputs, return_partials=True)
    np.testing.assert_allclose(pl_.numpy(), np.asarray(l), **TOL)
    np.testing.assert_allclose(pacc.numpy(), np.asarray(acc), **TOL)
    live = np.asarray(l) > 0
    np.testing.assert_allclose(pm.numpy()[live], np.asarray(m)[live], **TOL)
    np.testing.assert_array_equal(pl_.numpy()[0], 0.0)
    np.testing.assert_array_equal(pacc.numpy()[0], 0.0)


def test_split_partials_combine_associative():
    """Partials over two halves of each row's pages, combined, give the
    whole answer; the combine is order-insensitive exactly."""
    q, kp, vp, idx, pos, valid = _case(B=3, NQ=8, NKV=2, H=16, pps=4,
                                       valid=[3, 17, 32], seed=9)
    whole = _torch(q, kp, vp, idx, pos, valid)
    # second half: the same rows, first two pages masked out by
    # attending only to tokens >= 16 through a shifted view of the map
    t = lambda a: torch.from_numpy(a)                       # noqa: E731
    lo_valid = np.minimum(valid, 2 * PAGE).astype(np.int32)
    p0 = pt_ops.paged_attention(t(q), t(kp), t(vp), t(idx[:, :2]), t(pos),
                                t(lo_valid), page_size=PAGE,
                                return_partials=True)
    # the upper half as its own pool: pages 2..3 of every row, positions
    # and lengths shifted down by 16
    hi_valid = np.maximum(valid - 2 * PAGE, 0).astype(np.int32)
    hi_pos = (pos - 2 * PAGE).astype(np.int32)
    p1 = pt_ops.paged_attention(t(q), t(kp), t(vp), t(idx[:, 2:]),
                                t(hi_pos), t(hi_valid), page_size=PAGE,
                                return_partials=True)
    fwd = pt_ops.combine_partials([p0, p1])
    rev = pt_ops.combine_partials([p1, p0])
    np.testing.assert_allclose(fwd.numpy(), whole.numpy(), **TOL)
    np.testing.assert_array_equal(fwd.numpy(), rev.numpy())


def test_combine_matches_reference_combine():
    """The port's combine_partials folds the reference's partials to the
    reference's combine, and vice versa."""
    inputs = _case(B=3, NQ=4, NKV=2, H=16, pps=4, valid=[2, 21, 32],
                   seed=13)
    parts = jax_ops.paged_attention(*[jnp.asarray(a) for a in inputs],
                                    page_size=PAGE, impl="pallas",
                                    interpret=True, return_partials=True)
    want = np.asarray(jax_ops.combine_partials([parts]))
    got = pt_ops.combine_partials(
        [tuple(torch.from_numpy(np.array(p)) for p in parts)]).numpy()
    np.testing.assert_allclose(got, want, **TOL)


def test_non_cpu_tensor_never_takes_the_plain_path():
    """A tensor off the CPU goes to the kernel wrapper, which raises
    without a Hopper card — it never falls back to the plain version."""
    args = [torch.from_numpy(a).to("meta")
            for a in _case(B=2, NQ=4, NKV=2, H=64, pps=2, valid=[3, 9])]
    with pytest.raises(RuntimeError, match="CUDA"):
        pt_ops.paged_attention(*args, page_size=PAGE)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            require_hopper(torch.device("cuda"))
    cpu = [torch.from_numpy(a)
           for a in _case(B=2, NQ=4, NKV=2, H=64, pps=2, valid=[3, 9])]
    qg = cpu[0].reshape(2, 1, 2, 2, 64).permute(0, 2, 3, 1, 4)
    before = pt_kernel.paged_flash_decode.launches
    with pytest.raises(RuntimeError, match="CUDA device"):
        pt_kernel.paged_flash_decode(qg.reshape(2, 2, 2, 64).contiguous(),
                                     *cpu[1:4], cpu[4][:, 0].contiguous(),
                                     cpu[5], sq=1)
    assert pt_kernel.paged_flash_decode.launches == before



# the kernel's KV split: the host plan and the plain emulation of the
# split and its rank-order fold (csrc/paged_attention.cu)
SMS = 132               # an H100 SXM's SMs
PLAN_CASES = {
    # name: (B, NKV, R, max_tokens, head_dim, kv_bytes)
    "granite_decode": (8, 8, 4, 512, 64, 2),
    "granite_decode_1024": (8, 8, 4, 1024, 64, 2),
    "qwen3_decode": (8, 8, 2, 1024, 128, 2),
    "granite_sq32_prefill": (8, 8, 128, 1024, 64, 2),
    "qwen3_sq32_prefill": (8, 8, 64, 1024, 128, 2),
    "one_slot_long": (1, 8, 4, 8192, 128, 2),
    "fp32_h128_decode": (4, 2, 4, 32, 128, 4),
    "one_tile": (1, 1, 1, 16, 64, 4),
}


def _check_plan(plan, B, NKV, R, max_tokens):
    kp = pt_kernel
    assert 1 <= plan.splits <= kp.MAX_SPLITS
    assert plan.tokens_per_split % kp.TILE == 0
    # the splits cover the capacity, and none starts past it
    assert (plan.splits - 1) * plan.tokens_per_split < max(max_tokens, 1)
    assert plan.splits * plan.tokens_per_split >= max_tokens
    rows = kp.block_rows(plan.mode)
    assert plan.grid == (plan.splits, B * NKV, -(-R // rows))


@pytest.mark.parametrize("name", sorted(PLAN_CASES))
def test_split_plan(name):
    B, NKV, R, max_tokens, H, kv_bytes = PLAN_CASES[name]
    plan = pt_kernel.split_plan(B, NKV, R, max_tokens, SMS, head_dim=H,
                                kv_bytes=kv_bytes)
    _check_plan(plan, B, NKV, R, max_tokens)
    assert pt_kernel.smem_bytes(H, kv_bytes, plan.mode) <= \
        pt_kernel.MAX_SMEM_BYTES
    blocks = plan.grid[0] * plan.grid[1] * plan.grid[2]
    unsplit = blocks // plan.splits
    if unsplit >= SMS:                   # the grid fills the card already
        assert plan.splits == 1
    else:                                # split only as far as one a SM
        tiles = -(-max_tokens // pt_kernel.TILE)
        assert blocks >= SMS or plan.splits == min(pt_kernel.MAX_SPLITS,
                                                   tiles)
        if plan.splits > 1:
            assert unsplit * (plan.splits - 1) < SMS


def test_split_plan_at_the_main_path_shapes():
    """granite's 8-slot decode gives each SM a block (>= 132 blocks, 4 KV
    warps a block); its Sq 32 prefill chunk (512 blocks) is not split."""
    dec = pt_kernel.split_plan(8, 8, 4, 512, SMS)
    assert dec.mode == (4, 4) and dec.splits == 3
    assert dec.tokens_per_split == 192
    assert dec.grid[0] * dec.grid[1] * dec.grid[2] >= SMS
    pre = pt_kernel.split_plan(8, 8, 128, 512, SMS)
    assert pre.splits == 1 and pre.mode == (1, 4) and pre.grid == (1, 64, 8)
    assert pt_kernel.split_plan(8, 8, 2, 512, SMS, head_dim=128).mode == \
        (4, 2)
    # 4 KV warps would need 266 KB of shared memory at fp32 H 128
    assert pt_kernel.smem_bytes(128, 4, (4, 4)) > pt_kernel.MAX_SMEM_BYTES
    assert pt_kernel.block_mode(4, 128, 4) == (2, 4)


@pytest.mark.parametrize("forced", range(1, 9))
def test_split_plan_override(forced):
    """The tests' override forces a count, still held to the plan's rules
    (at most the tiles there are)."""
    for B, NKV, R, max_tokens, H, kv_bytes in PLAN_CASES.values():
        plan = pt_kernel.split_plan(B, NKV, R, max_tokens, SMS, head_dim=H,
                                    kv_bytes=kv_bytes, splits=forced)
        _check_plan(plan, B, NKV, R, max_tokens)
        assert plan.splits <= forced
    with pytest.raises(ValueError):
        pt_kernel.split_plan(8, 8, 4, 512, SMS, splits=9)


SPLIT_PPS = 32          # 256 tokens of capacity: 8 tiles
SPLIT_VALID = [0, 1, 33, 70, 128]   # empty, one token, splits past valid


def _grouped(inputs):
    """numpy inputs of _case -> the kernel's grouped torch operands."""
    q, kp, vp, idx, pos, valid = (torch.from_numpy(a) for a in inputs)
    B, Sq, NQ, H = q.shape
    NKV = kp.shape[2]
    qg = q.reshape(B, Sq, NKV, NQ // NKV, H).permute(0, 2, 3, 1, 4)
    return (qg.reshape(B, NKV, -1, H), kp, vp, idx, pos[:, 0], valid), Sq


@pytest.mark.parametrize("sq", [1, 2])
@pytest.mark.parametrize("forced", [1, 2, 3, 4, 8])
def test_split_partials_match_partials_and_pallas(forced, sq):
    """The emulated split and rank-order fold against the unsplit plain
    partials and the TPU kernel's partials in interpret mode, on a
    permuted map with a kv_valid == 0 row and splits wholly past
    kv_valid: fp32 (2e-5, as TOL)."""
    inputs = _case(B=5, NQ=8, NKV=2, H=16, pps=SPLIT_PPS, valid=SPLIT_VALID,
                   sq=sq, seed=21, permuted=True)
    ops_args, Sq = _grouped(inputs)
    plan = pt_kernel.split_plan(5, 2, 4 * sq, SPLIT_PPS * PAGE, SMS,
                                splits=forced)
    assert plan.splits == forced
    acc, m, l = pt_ref.split_partials(
        *ops_args, sq=Sq, splits=plan.splits,
        tokens_per_split=plan.tokens_per_split)
    want = pt_ref.paged_partials(*ops_args, sq=Sq)
    live = want[2] > 0
    torch.testing.assert_close(acc, want[0], **TOL)
    torch.testing.assert_close(l, want[2], **TOL)
    torch.testing.assert_close(m[live], want[1][live], **TOL)
    # the empty row: acc = 0, l = 0, m = NEG_INF, no NaN
    assert (acc[0] == 0).all() and (l[0] == 0).all()
    assert (m[0] == pt_ref.NEG_INF).all() and not acc.isnan().any()
    jm, jl, jacc = jax_ops.paged_attention(
        *[jnp.asarray(a) for a in inputs], page_size=PAGE, impl="pallas",
        interpret=True, return_partials=True)
    B, NKV, R, H = acc.shape
    as_heads = lambda t, *h: t.reshape(B, NKV, R // Sq, Sq, *h).reshape(
        B, NKV * (R // Sq), Sq, *h).numpy()                 # noqa: E731
    np.testing.assert_allclose(as_heads(acc, H), np.asarray(jacc), **TOL)
    np.testing.assert_allclose(as_heads(l), np.asarray(jl), **TOL)
    jlive = np.asarray(jl) > 0
    np.testing.assert_allclose(as_heads(m)[jlive], np.asarray(jm)[jlive],
                               **TOL)


def test_split_fold_is_bitwise_for_splits_that_order_alike():
    """Where every row's valid tokens lie in the first split, whatever the
    count, the fold adds only neutral partials (weight exp(-1e30 - m) = 0,
    or l = acc = 0) after the same first one: the same bits for every
    split count; and a second fold repeats the bits."""
    inputs = _case(B=4, NQ=8, NKV=2, H=16, pps=SPLIT_PPS,
                   valid=[0, 5, 17, 32], sq=1, seed=22, permuted=True)
    ops_args, Sq = _grouped(inputs)
    outs = []
    for forced in (1, 2, 3, 4, 8):
        plan = pt_kernel.split_plan(4, 2, 4, SPLIT_PPS * PAGE, SMS,
                                    splits=forced)
        outs.append(pt_ref.split_partials(
            *ops_args, sq=Sq, splits=plan.splits,
            tokens_per_split=plan.tokens_per_split))
    for got in outs[1:]:
        for g, w in zip(got, outs[0]):
            assert torch.equal(g, w)
    again = pt_ref.split_partials(*ops_args, sq=Sq, splits=8,
                                  tokens_per_split=32)
    assert all(torch.equal(g, w) for g, w in zip(again, outs[-1]))
