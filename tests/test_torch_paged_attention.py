"""The port's paged attention (plain version, the CPU path) against the
reference: ``repro.kernels.paged_attention.ref`` (the gather oracle) and
``ops.paged_attention(impl="pallas", interpret=True)`` (the TPU kernel in
interpret mode), on the cases of tests/test_kernels_paged.py.  Inputs
are made with numpy from a seed and handed to both packages; everything
is fp32 on the CPU, so the tolerance is fp32 roundoff of a softmax over
<= 32 tokens (2e-5, the reference tests' own).
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

