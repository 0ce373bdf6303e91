"""Tests of the port that need a Hopper card (marker ``gpu``): each CUDA
kernel (paged attention, STREAM, ELL SpMV in both idioms, GEMM, conv2d,
strided gather, tail mask, Qsim gate, flash attention, dense-cache flash
decode, SSD scan, int8 GEMM) against its plain version on ragged shapes,
with its launch counter checked (the attention kernels also at the
served head groups: grok-1's G 6, phi3-medium's 10 KV heads), the MoE
on the card (fp32, and int8 through one int8 GEMM an expert), the
kernels at jamba-v0.1-52b's shapes (the SSD scan at 128 heads and N 16,
the int8 GEMM at its experts and mamba projections), and the port's
engines (dense, moe, ssm and hybrid, bf16/fp32 and int8 weights, the
paged kernel on and off) and train step on the card against the same on
the CPU.  The serving features: both attention kernels at the verify
width of speculative decoding (Sq 5, a ragged ``n_valid`` of 0 to 5 a
row), the verify forward's discarded columns finite, and the engine with
``spec_decode`` and with ``prefix_cache`` on the card against the CPU.
Without a card they skip; on the card run them with

    PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_gpu.py

This module imports no jax, so it runs where only PyTorch is installed.
"""
import dataclasses

import numpy as np
import pytest
import torch

from repro_torch.configs import reduced_config
from repro_torch.kernels.common import (require_hopper,
                                       sm_count)
from repro_torch.kernels.conv2d import kernel as conv_kernel
from repro_torch.kernels.conv2d import ops as conv_ops
from repro_torch.kernels.gemm import kernel as gemm_kernel
from repro_torch.kernels.flash_attention import kernel as fa_kernel
from repro_torch.kernels.flash_attention import ops as fa_ops
from repro_torch.kernels.flash_attention import ref as fa_ref
from repro_torch.kernels.gemm import ops as gemm_ops
from repro_torch.kernels.gemm import ref as gemm_ref
from repro_torch.kernels.paged_attention import kernel as pa_kernel
from repro_torch.kernels.paged_attention import ops as pa_ops
from repro_torch.kernels.paged_attention import ref as pa_ref
from repro_torch.kernels.qsim_gate import kernel as gate_kernel
from repro_torch.kernels.qsim_gate import ops as gate_ops
from repro_torch.kernels.spmv import kernel as spmv_kernel
from repro_torch.kernels.ssd_scan import kernel as ssd_kernel
from repro_torch.kernels.ssd_scan import ops as ssd_ops
from repro_torch.kernels.ssd_scan import ref as ssd_ref
from repro_torch.kernels.spmv import ops as spmv_ops
from repro_torch.kernels.spmv import ref as spmv_ref
from repro_torch.kernels.stream import kernel as stream_kernel
from repro_torch.kernels.stream import ops as stream_ops
from repro_torch.kernels.strided import kernel as strided_kernel
from repro_torch.kernels.strided import ops as strided_ops
from repro_torch.kernels.tailmask import kernel as tail_kernel
from repro_torch.kernels.tailmask import ops as tail_ops
from repro_torch.kernels.wq_gemm import kernel as wq_kernel
from repro_torch.kernels.wq_gemm import ops as wq_ops
from repro_torch.kernels.wq_gemm import ref as wq_ref
from repro_torch.models import moe
from repro_torch.models.model import LM
from repro_torch.models.quant import quantize_params
from repro_torch.quantum import gates, qsim
from repro_torch.serve.engine import ContinuousBatchingEngine, StaticBatchEngine
from repro_torch.train.parity import card_step_matches_cpu

pytestmark = pytest.mark.gpu

PAGE = 8


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card of capability (9, 0)")
    dev = torch.device("cuda")
    require_hopper(dev)
    return dev


def _paged_inputs(card, H, sq, permuted, dtype, valid, pps=32, seed=None,
                  NKV=2, G=4):
    """A 256-token table (8 tiles: every split count the plan can return
    up to 8), a row per entry of ``valid``, NKV KV heads (2) of G query
    heads each (4); numpy-seeded."""
    rng = np.random.default_rng(H + sq if seed is None else seed)
    B = len(valid)
    q = torch.from_numpy(rng.standard_normal((B, sq, NKV * G, H))).float()
    kp = torch.from_numpy(rng.standard_normal((B * pps, PAGE, NKV, H)))
    vp = torch.from_numpy(rng.standard_normal((B * pps, PAGE, NKV, H)))
    idx = (rng.permutation(B * pps) if permuted else np.arange(B * pps))
    valid = np.asarray(valid, np.int32)
    pos = np.maximum(valid[:, None] - sq + np.arange(sq)[None], 0)
    return [q.to(card), kp.to(card, dtype), vp.to(card, dtype),
            torch.from_numpy(idx.reshape(B, pps).astype(np.int32)).to(card),
            torch.from_numpy(pos.astype(np.int32)).to(card),
            torch.from_numpy(valid).to(card)]


def _grouped(args):
    q, kp, vp, idx, pos, valid = args
    B, Sq, NQ, H = q.shape
    NKV = kp.shape[2]
    qg = q.reshape(B, Sq, NKV, NQ // NKV, H).permute(0, 2, 3, 1, 4)
    return (qg.reshape(B, NKV, -1, H).contiguous(), kp, vp, idx,
            pos[:, 0].contiguous(), valid), Sq


# softcap 30 over queries scaled by 30: scores of ~30, where the cap
# changes the output (at ~1 it would be within the tolerance of no cap)
SOFTCAP, SOFTCAP_Q_SCALE = 30.0, 30.0


@pytest.mark.parametrize("splits,softcap", [
    *((s, 0.0) for s in (None, 1, 2, 3, 4, 5, 8)),
    *((s, SOFTCAP) for s in (None, 1, 3, 8))])
@pytest.mark.parametrize("H,sq,permuted,dtype", [
    (64, 1, True, torch.bfloat16), (128, 4, False, torch.bfloat16),
    (64, 4, True, torch.float32), (128, 1, True, torch.float32)])
def test_kernel_matches_plain(card, H, sq, permuted, dtype, splits, softcap):
    """Partials and normalized output of the kernel against the plain
    version on the same card inputs: empty (kv_valid 0), page-boundary,
    partial-last-page, long and full-table rows (the last split clamped at
    the table's end), with splits wholly past kv_valid, at
    every split count the plan returns for the 256-token table (forced
    through the binding's test-only ``splits``; None: the plan's own,
    through ops.paged_attention), without and with a softcap (scores
    of ~30: the cap moves the output far past the tolerance).  Both
    compute in fp32 from the same inputs, so they differ only in
    summation order (2e-3).  A second launch gives the same bits."""
    args = _paged_inputs(card, H, sq, permuted, dtype, [0, 8, 17, 200, 256])
    if softcap:
        args[0] = args[0] * SOFTCAP_Q_SCALE
        cpu = [a.cpu() for a in args]     # the plain version: the cap bites
        capped = pa_ops.paged_attention(*cpu, page_size=PAGE, softcap=softcap)
        uncapped = pa_ops.paged_attention(*cpu, page_size=PAGE)
        assert float((capped - uncapped).abs().max()) > 0.1
    before = pa_kernel.paged_flash_decode.launches
    if splits is None:
        call = lambda: pa_ops.paged_attention(                # noqa: E731
            *args, page_size=PAGE, return_partials=True, softcap=softcap)
        got = call()
        assert pa_kernel.paged_flash_decode.launches == before + 1
        want = pa_ops.paged_attention(*[a.cpu() for a in args],
                                      page_size=PAGE, return_partials=True,
                                      softcap=softcap)
        torch.cuda.synchronize()
        for g, w in zip(got[1:], want[1:]):
            torch.testing.assert_close(g.cpu(), w, rtol=2e-3, atol=2e-3)
        out = pa_ops.combine_partials([got]).cpu()
        assert torch.isfinite(out).all() and (out[0] == 0).all()
        torch.testing.assert_close(out, pa_ops.combine_partials([want]),
                                   rtol=2e-3, atol=2e-3)
    else:
        grouped, Sq = _grouped(args)
        call = lambda: pa_kernel.paged_flash_decode(          # noqa: E731
            *grouped, sq=Sq, splits=splits, softcap=softcap)
        got = call()
        assert pa_kernel.paged_flash_decode.launches == before + 1
        want = pa_ref.paged_partials(*grouped, sq=Sq, softcap=softcap)
        torch.cuda.synchronize()
        live = want[2] > 0
        torch.testing.assert_close(got[0], want[0], rtol=2e-3, atol=2e-3)
        torch.testing.assert_close(got[2], want[2], rtol=2e-3, atol=2e-3)
        torch.testing.assert_close(got[1][live], want[1][live], rtol=2e-3,
                                   atol=2e-3)
        # the empty row: acc = 0, l = 0, m = -1e30, no NaN
        assert (got[0][0] == 0).all() and (got[2][0] == 0).all()
        assert (got[1][0] == pa_ref.NEG_INF).all()
        assert all(torch.isfinite(t).all() for t in got)
    again = call()
    torch.cuda.synchronize()
    assert all(torch.equal(a, b) for a, b in zip(got, again))


@pytest.mark.parametrize("softcap", [0.0, SOFTCAP])
@pytest.mark.parametrize("H,dtype", [(64, torch.bfloat16),
                                     (128, torch.bfloat16),
                                     (64, torch.float32),
                                     (128, torch.float32)])
def test_kernel_bits_do_not_depend_on_empty_splits(card, H, dtype, softcap):
    """Every valid token in the first 32 of a 256-token table: the other
    splits (and warps) hold neutral partials, which the fold adds exactly,
    so every split count gives the same bits (against the plain version
    at 2e-3), without and with a softcap."""
    args = _paged_inputs(card, H, 1, True, dtype, [0, 5, 17, 32], seed=7)
    if softcap:
        args[0] = args[0] * SOFTCAP_Q_SCALE
    grouped, Sq = _grouped(args)
    outs = [pa_kernel.paged_flash_decode(*grouped, sq=Sq, splits=s,
                                         softcap=softcap)
            for s in range(1, 9)]
    want = pa_ref.paged_partials(*grouped, sq=Sq, softcap=softcap)
    torch.cuda.synchronize()
    torch.testing.assert_close(outs[0][0], want[0], rtol=2e-3, atol=2e-3)
    for got in outs[1:]:
        assert all(torch.equal(a, b) for a, b in zip(got, outs[0]))


def test_kernel_smem_copies_agree(card):
    """kernel.py's copies of the kernels' shared memory (the plans rest on
    them) equal csrc's."""
    lib = pa_kernel.load_library()
    for H in pa_kernel.HEAD_DIMS:
        for kv_bytes in (2, 4):
            for mode in pa_kernel.MODES:
                assert lib.paged_partials_smem_bytes(H, kv_bytes, *mode) == \
                    pa_kernel.smem_bytes(H, kv_bytes, mode)
    lib = conv_kernel.load_library()
    for bn in conv_kernel.CHANNEL_TILES:
        for kh, kw in ((1, 1), (3, 3), (5, 5), (7, 3), (2, 4), (7, 7),
                       (1, 9)):
            assert lib.conv2d_smem_bytes(kh, kw, bn) == \
                conv_kernel.smem_bytes(kh, kw, bn)


def _counted(wrapper, call):
    before = wrapper.launches
    out = call()
    assert wrapper.launches == before + 1
    torch.cuda.synchronize()
    return out


@pytest.mark.parametrize("kind", ["copy", "scale", "add", "triad"])
@pytest.mark.parametrize("shape,mult", [((37, 128), 1), ((1001, 127), 8)])
def test_stream_kernel_matches_plain(card, kind, shape, mult):
    """Every kind, rows past the block and a length that is not a
    multiple of 4 (the masked tail): exact, as the kernel rounds as the
    plain version does (rtol 1e-6)."""
    rng = np.random.default_rng(0)
    x, y = (torch.from_numpy(rng.standard_normal(shape).astype(np.float32))
            for _ in range(2))
    got = _counted(stream_kernel.stream_call, lambda: stream_ops.stream(
        kind, x.to(card), y.to(card), 0.3, block_multiplier=mult))
    want = stream_ops.stream(kind, x, y, 0.3)
    torch.testing.assert_close(got.cpu(), want, rtol=1e-6, atol=0.0)


def _spmv_inputs(R, C, nnz, seed, out_of_range=True):
    """A numpy-seeded ELL matrix with columns at -1 and at C among the
    nonzeros (they add nothing); also the plain version's y over the
    in-range nonzeros and each row's sum of |terms|."""
    rng = np.random.default_rng(seed)
    vals = torch.from_numpy(rng.standard_normal((R, nnz)).astype(
        np.float32))
    cols = torch.from_numpy(rng.integers(0, C, (R, nnz)).astype(np.int32))
    if out_of_range and nnz:
        cols[::7, 0] = -1
        cols[3::7, -1] = C
    x = torch.from_numpy(rng.random(C).astype(np.float32))
    inside = (cols >= 0) & (cols < C)
    kept, at = vals * inside, cols.clamp(0, C - 1)
    want = spmv_ops.spmv_ell(kept, at, x)
    return vals, cols, x, want, (kept * x[at]).abs().sum(-1, keepdim=True)


@pytest.mark.parametrize("nnz,mult", [
    (1, 1), (13, 2), (16, 4), (33, 8),
    *((k, m) for k in (4, 16, 64) for m in (1, 2, 4, 8) if (k, m) != (16, 4))])
def test_spmv_kernel_matches_plain(card, nnz, mult):
    """1000 rows (not a multiple of any tile), nnz below, at and past a
    warp, columns at -1 and at C (they add nothing); each row within 1e-6
    of the scale of its terms.  Through ops the plan's path (the general
    one: no block would walk a second tile); K 4, 16 and 64 also on the
    vector path forced, at every block multiplier (a ragged last
    tile)."""
    vals, cols, x, want, scale = _spmv_inputs(1000, 777, nnz, nnz)
    sms = sm_count(require_hopper(card))
    assert spmv_kernel.take_plan(1000, nnz, mult, sms, True).path == \
        "general"
    tv, tc, tx = vals.to(card), cols.to(card), x.to(card)
    got = _counted(spmv_kernel.spmv_ell, lambda: spmv_ops.spmv_ell(
        tv, tc, tx, block_multiplier=mult))
    assert ((got.cpu() - want).abs() <= 1e-6 * scale).all()
    if nnz % 4 == 0:
        got = _counted(spmv_kernel.spmv_ell, lambda: spmv_kernel.spmv_ell(
            tv, tc, tx, block_multiplier=mult, path="vector"))
        assert ((got.cpu() - want).abs() <= 1e-6 * scale).all()


@pytest.mark.parametrize("mult", [1, 2, 4, 8])
@pytest.mark.parametrize("nnz", [16, 64])
def test_spmv_kernel_plan_takes_the_vector_path(card, nnz, mult):
    """At 70001 rows every block of the persistent grid walks several
    tiles, so the plan itself takes the vector path through ops; columns
    at -1 and at C; within 1e-6 of the row's scale."""
    R = 70001
    vals, cols, x, want, scale = _spmv_inputs(R, 20000, nnz, mult)
    assert spmv_kernel.take_plan(R, nnz, mult, sm_count(require_hopper(
        card)), True).path == "vector"
    got = _counted(spmv_kernel.spmv_ell, lambda: spmv_ops.spmv_ell(
        vals.to(card), cols.to(card), x.to(card), block_multiplier=mult))
    assert ((got.cpu() - want).abs() <= 1e-6 * scale).all()


@pytest.mark.parametrize("R", [1, 255, 4097])
@pytest.mark.parametrize("nnz", [16, 64])
def test_spmv_kernel_misaligned_view_takes_the_general_path(card, R, nnz):
    """vals a view one float past a 16-byte boundary: the plan takes the
    general path, forcing the vector path raises, and the result is the
    plain version's (1e-6 of the row's scale)."""
    vals, cols, x, want, scale = _spmv_inputs(R, 300, nnz, R)
    buf = torch.empty(R * nnz + 1, device=card)
    view = buf[1:].view(R, nnz)
    view.copy_(vals)
    tc, tx = cols.to(card), x.to(card)
    with pytest.raises(ValueError):
        spmv_kernel.spmv_ell(view, tc, tx, path="vector")
    got = _counted(spmv_kernel.spmv_ell,
                   lambda: spmv_ops.spmv_ell(view, tc, tx))
    assert ((got.cpu() - want).abs() <= 1e-6 * scale).all()


@pytest.mark.parametrize("path", ["vector", "general"])
@pytest.mark.parametrize("mult", [1, 2, 4, 8])
def test_spmv_kernel_repeats_its_bits(card, path, mult):
    """Two calls on the same inputs give the same bits (no atomics, a
    fixed order of sums), at 2^16 + 3 rows x 16 (a persistent block walks
    several tiles)."""
    vals, cols, x, want, scale = _spmv_inputs((1 << 16) + 3, 5000, 16, mult)
    tv, tc, tx = vals.to(card), cols.to(card), x.to(card)
    first = spmv_kernel.spmv_ell(tv, tc, tx, block_multiplier=mult,
                                 path=path)
    again = spmv_kernel.spmv_ell(tv, tc, tx, block_multiplier=mult,
                                 path=path)
    torch.cuda.synchronize()
    assert torch.equal(first, again)
    assert ((first.cpu() - want).abs() <= 1e-6 * scale).all()


@pytest.mark.parametrize("mult", [1, 2, 4, 8])
@pytest.mark.parametrize("nnz", [4, 16, 64, 128])
def test_spmv_take_plan_matches_the_library(card, nnz, mult):
    """The plan's ring is the library's (``spmv_take_smem_bytes``), and
    after a launch the card holds the plan's blocks a SM (so the
    persistent grid is one wave)."""
    plan = spmv_kernel.take_plan(1 << 20, nnz, mult,
                                 sm_count(require_hopper(card)), True)
    assert plan.path == "vector"
    lib = spmv_kernel.load_library()
    assert lib.spmv_take_smem_bytes(nnz, plan.lanes, mult, plan.stages) == \
        plan.smem
    vals, cols, x, want, scale = _spmv_inputs(2 * plan.tile_rows + 1, 50,
                                              nnz, 0)
    got = spmv_kernel.spmv_ell(vals.to(card), cols.to(card), x.to(card),
                               block_multiplier=mult, path="vector")
    torch.cuda.synchronize()
    assert ((got.cpu() - want).abs() <= 1e-6 * scale).all()
    assert lib.spmv_take_occupancy(plan.lanes, mult, plan.smem) >= \
        plan.blocks_per_sm


@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-4),
                                       (torch.float64, 1e-12)])
@pytest.mark.parametrize("mult", [1, 2, 4, 8])
def test_gemm_kernel_matches_plain(card, dtype, tol, mult):
    """M, N and K not multiples of any tile; fp32 without TF32, fp64
    accumulated in fp64."""
    torch.backends.cuda.matmul.allow_tf32 = False
    rng = np.random.default_rng(mult)
    a = torch.from_numpy(rng.standard_normal((1000, 515))).to(dtype)
    b = torch.from_numpy(rng.standard_normal((515, 777))).to(dtype)
    got = _counted(gemm_kernel.gemm, lambda: gemm_ops.gemm(
        a.to(card), b.to(card), block_multiplier=mult))
    torch.testing.assert_close(got.cpu(), gemm_ops.gemm(a, b), rtol=tol,
                               atol=tol)


@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-4),
                                       (torch.float64, 1e-12)])
@pytest.mark.parametrize("mult", [1, 2, 4, 8])
@pytest.mark.parametrize("M,K,N", [(512, 512, 512), (300, 64, 1032)])
def test_gemm_kernel_16_byte_rows_match_plain(card, dtype, tol, mult, M, K,
                                              N):
    """Rows of 16-byte multiples take the 16-byte copies (the ragged test
    above the element copies): against ref.gemm on the card."""
    torch.backends.cuda.matmul.allow_tf32 = False
    g = torch.Generator(device=card).manual_seed(mult)
    a = torch.randn((M, K), generator=g, device=card, dtype=dtype)
    b = torch.randn((K, N), generator=g, device=card, dtype=dtype)
    got = _counted(gemm_kernel.gemm, lambda: gemm_kernel.gemm(
        a, b, block_multiplier=mult))
    torch.testing.assert_close(got, gemm_ref.gemm(a, b), rtol=tol, atol=tol)


@pytest.mark.parametrize("k", [1, 2, 3, 4, 5, 7])
@pytest.mark.parametrize("block_h", [4, 8, 12])
def test_conv2d_kernel_matches_plain(card, k, block_h):
    """Ragged width, input and output channels; even filters pad as the
    TPU kernel does; block_h (the JAX entry's row block, checked for
    parity) below, at and past 8.  Every tile of the plan: Cout 8, 16, 32
    (and 33, 64 wide), 64 and 100 (two channel tiles), 1x1 to 5x5 filters
    under their width templates, 7x7 under the any-width one, and a 3-row
    by k-column one.  fp32 FMAs in both (1e-4)."""
    rng = np.random.default_rng(k)
    for cin, cout in ((5, 33), (16, 8), (12, 16), (8, 32), (20, 64),
                      (3, 100)):
        x = torch.from_numpy(rng.standard_normal((2, 24, 37, cin)).astype(
            np.float32))
        for kh in sorted({k, 3}):
            w = torch.from_numpy((rng.standard_normal((kh, k, cin, cout))
                                  * 0.1).astype(np.float32))
            want = conv_ops.conv2d_same(x, w)
            got = _counted(conv_kernel.conv2d_same,
                           lambda: conv_ops.conv2d_same(
                               x.to(card), w.to(card), block_h=block_h))
            torch.testing.assert_close(got.cpu(), want, rtol=1e-4,
                                       atol=1e-4)


@pytest.mark.parametrize("idiom,wrapper", [
    ("strided_rowwise", "strided_rowwise"),
    ("overfetch_select", "overfetch_select")])
@pytest.mark.parametrize("rows,cols,stride,mult", [
    (1001, 128, 8, 1), (1007, 128, 2, 8), (257, 127, 4, 2), (1000, 4, 3, 4)])
def test_strided_kernel_matches_plain(card, idiom, wrapper, rows, cols,
                                      stride, mult):
    """Rows the stride does not divide, a ragged last block, rows of 127
    floats (the one-float path): exact."""
    x = torch.from_numpy(np.random.default_rng(rows).standard_normal(
        (rows, cols)).astype(np.float32))
    got = _counted(getattr(strided_kernel, wrapper),
                   lambda: strided_ops.strided_gather(
                       x.to(card), stride, idiom, block_multiplier=mult))
    want = strided_ops.strided_gather(x, stride, idiom)
    assert torch.equal(got.cpu(), want)


@pytest.mark.parametrize("rows,block_rows,launches", [
    (1000, 8, 1), (1001, 8, 2), (1007, 16, 2), (3, 8, 1)])
def test_tailmask_exact_kernel_matches_plain(card, rows, block_rows,
                                             launches):
    """Whole tiles in one launch and the remainder in a second: the
    counter shows 1 or 2 launches; within rtol 1e-6 of F.silu(x) * 2."""
    x = torch.from_numpy(np.random.default_rng(rows).standard_normal(
        (rows, 128)).astype(np.float32) * 4)
    before = tail_kernel.exact_tail.launches
    got = tail_ops.tail_compute(x.to(card), "exact_tail",
                                block_rows=block_rows)
    assert tail_kernel.exact_tail.launches == before + launches
    torch.cuda.synchronize()
    torch.testing.assert_close(got.cpu(), tail_ops.tail_compute(x),
                               rtol=1e-6, atol=0.0)


@pytest.mark.parametrize("n_valid", [0, 1, 1000, 6143, 6144, 7000])
def test_tailmask_masked_kernel_matches_plain(card, n_valid):
    x = torch.from_numpy(np.random.default_rng(n_valid).standard_normal(
        (48, 128)).astype(np.float32) * 4)
    got = _counted(tail_kernel.masked_full, lambda: tail_ops.tail_compute(
        x.to(card), "masked_full", n_valid=n_valid))
    torch.testing.assert_close(
        got.cpu(), tail_ops.tail_compute(x, "masked_full", n_valid=n_valid),
        rtol=1e-6, atol=0.0)


@pytest.mark.parametrize("n,qubit", [(1, 0), (6, 0), (6, 3), (12, 4),
                                     (12, 11)])
def test_qsim_gate_kernel_matches_plain(card, n, qubit):
    """Pairs within one 128-byte line (q < 5) and across lines; bitwise the
    plain version (the kernel rounds each operation as it does)."""
    rng = np.random.default_rng(n + qubit)
    re, im = (torch.from_numpy(rng.standard_normal(2 ** n).astype(
        np.float32)) for _ in range(2))
    gate = (gates.rx(0.4) @ gates.T).astype(np.complex64)
    got = _counted(gate_kernel.apply_gate_planar,
                   lambda: gate_ops.apply_gate_planar(re.to(card),
                                                      im.to(card), gate,
                                                      qubit))
    want = gate_ops.apply_gate_planar(re, im, gate, qubit)
    for g_, w_ in zip(got, want):
        torch.testing.assert_close(g_.cpu(), w_, rtol=0, atol=0)


def test_qsim_kernel_version_on_card_matches_cpu(card):
    """run_kernel_planar on the card launches the kernel once per
    uncontrolled gate and agrees with the CPU run (atol 1e-5)."""
    circuit = gates.random_circuit(10, 3, 4)
    before = gate_kernel.apply_gate_planar.launches
    got = qsim.run_kernel_planar(*qsim.init_planar(10, card), circuit)
    assert gate_kernel.apply_gate_planar.launches - before == sum(
        g.control is None for g in circuit)
    want = qsim.run_kernel_planar(*qsim.init_planar(10, "cpu"), circuit)
    for g_, w_ in zip(got, want):
        torch.testing.assert_close(g_.cpu(), w_, rtol=0, atol=1e-5)


def test_engine_on_card_matches_cpu(card):
    """Greedy tokens of the engine on the card equal the CPU engine's,
    fp32 reduced granite-3-2b at head_dim 64 (TF32 off)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = reduced_config("granite-3-2b", head_dim=64)
    params = LM(cfg, device="cpu").init_params(
        torch.Generator().manual_seed(0))
    rng = np.random.default_rng(1)
    prompts = [rng.integers(1, cfg.vocab_size, size=n) for n in (13, 5, 21)]
    outs = []
    for dev in (card, torch.device("cpu")):
        model = LM(cfg, device=dev)
        eng = ContinuousBatchingEngine(model, _to(params, dev), n_slots=2,
                                       max_len=48, page_size=8,
                                       prefill_chunk=6)
        rids = [eng.submit(pr, 7) for pr in prompts]
        res = eng.run()
        outs.append([res[r].tolist() for r in rids])
    assert outs[0] == outs[1]


@pytest.mark.parametrize("S,G,H,dtype,causal,softcap", [
    (1, 1, 32, torch.float32, True, 0.0),
    (63, 2, 64, torch.float32, True, 0.0),
    (97, 8, 32, torch.float32, True, 30.0),
    (130, 2, 128, torch.bfloat16, False, 0.0),
    (200, 8, 128, torch.bfloat16, True, 30.0),
    (63, 8, 64, torch.bfloat16, True, 0.0),
    (4096, 2, 128, torch.bfloat16, True, 0.0)])
def test_flash_kernel_matches_plain(card, S, G, H, dtype, causal, softcap):
    """Grouped rows that wrap from one query head to the next inside a
    query tile (S not a multiple of 64 or 128, G 2 and 8): out and lse
    against the plain version on the same card inputs, within
    ``ref.FLASH_TOL`` and ``ref.LSE_TOL`` (fp32 on the CUDA cores, bf16 on
    the tensor cores)."""
    rng = np.random.default_rng(S + G)
    BN = 3
    q, k, v = (torch.from_numpy(rng.standard_normal(shape).astype(
        np.float32)).to(card, dtype) for shape in
        [(BN, G * S, H), (BN, S, H), (BN, S, H)])
    out, lse = _counted(fa_kernel.flash_fwd, lambda: fa_kernel.flash_fwd(
        q, k, v, causal=causal, softcap=softcap, sq_real=S))
    want_out, want_lse = fa_ref.flash_fwd(q, k, v, causal=causal,
                                          softcap=softcap, sq_real=S)
    rtol, atol = fa_ref.FLASH_TOL[dtype]
    torch.testing.assert_close(out.float(), want_out.float(), rtol=rtol,
                               atol=atol)
    rtol, atol = fa_ref.LSE_TOL
    torch.testing.assert_close(lse, want_lse, rtol=rtol, atol=atol)


@pytest.mark.parametrize("S,G,causal", [(128, 2, True), (4096, 2, True),
                                        (200, 8, False)])
def test_flash_kernel_gives_the_same_bits_twice(card, S, G, causal):
    """The tensor-core forward (no atomics, no split-KV) run twice on the
    same inputs: out and lse bit for bit, at qwen3's train shapes and a
    wrapped full-attention one."""
    g = torch.Generator(device=card).manual_seed(S)
    q, k, v = (torch.randn(shape, generator=g, device=card).bfloat16()
               for shape in [(4, G * S, 128), (4, S, 128), (4, S, 128)])
    first = _counted(fa_kernel.flash_fwd, lambda: fa_kernel.flash_fwd(
        q, k, v, causal=causal, sq_real=S))
    second = fa_kernel.flash_fwd(q, k, v, causal=causal, sq_real=S)
    torch.cuda.synchronize()
    assert all(torch.equal(a, b) for a, b in zip(first, second))


@pytest.mark.parametrize("H,G,Sq,dtype,softcap", [
    (32, 1, 1, torch.float32, 0.0), (64, 4, 1, torch.bfloat16, 0.0),
    (128, 2, 1, torch.bfloat16, 30.0), (128, 8, 1, torch.float32, 0.0),
    (64, 2, 32, torch.float32, 30.0), (128, 2, 32, torch.bfloat16, 0.0)])
def test_flash_decode_kernel_matches_plain(card, H, G, Sq, dtype, softcap):
    """Rows with valid length 0, 1, a tile edge (32), ragged and the whole
    cache, each with its own query lengths (a prefill row's ramp for Sq
    32), over a cache read through a strided view (every other row of a
    wider cache).  fp32 within 2e-4 (the JAX test's tolerance); bf16
    within one bf16 ulp (rtol 8e-3, atol 1e-4); a query with no valid key
    exactly 0."""
    rng = np.random.default_rng(H + G + Sq)
    B, S, NKV = 5, 200, 2
    q = torch.from_numpy(rng.standard_normal((B, Sq, NKV * G, H)).astype(
        np.float32)).to(card, dtype)
    wide = torch.from_numpy(rng.standard_normal((2 * B, S, NKV, H)).astype(
        np.float32)).to(card, dtype)
    k, v = wide[::2], wide[1::2]                  # batch stride 2 rows
    valid = torch.tensor([0, 1, 32, 77, S], dtype=torch.int32)
    lens = (valid[:, None] - Sq + 1 + torch.arange(Sq)[None]).clamp(0, S)
    lens = lens.to(torch.int32).to(card)
    got = _counted(fa_kernel.flash_decode, lambda: fa_ops.flash_decode(
        q, k, v, lens, softcap=softcap))
    want = fa_ref.flash_decode(q, k, v, lens, softcap=softcap)
    rtol, atol = (2e-4, 2e-4) if dtype == torch.float32 else (8e-3, 1e-4)
    torch.testing.assert_close(got.float(), want.float(), rtol=rtol,
                               atol=atol)
    assert bool((got[lens == 0] == 0).all())


DECODE_SPLIT_S = 256        # 8 tiles of 32: every split count up to 8


def _decode_inputs(card, dtype, H, G, Sq, valid, seed, q_scale=1.0,
                   NKV=2):
    """B = len(valid) rows over a DECODE_SPLIT_S-token cache read through
    a strided view (every other row of a wider one), NKV KV heads (2);
    query c of a row attends to the ramp ending at the row's length."""
    rng = np.random.default_rng(seed)
    B, S = len(valid), DECODE_SPLIT_S
    q = torch.from_numpy((rng.standard_normal((B, Sq, NKV * G, H))
                          * q_scale).astype(np.float32)).to(card, dtype)
    wide = torch.from_numpy(rng.standard_normal((2 * B, S, NKV, H)).astype(
        np.float32)).to(card, dtype)
    lens = (torch.tensor(valid)[:, None] - Sq + 1
            + torch.arange(Sq)[None]).clamp(0, S)
    return q, wide[::2], wide[1::2], lens.to(torch.int32).to(card)


@pytest.mark.parametrize("softcap", [0.0, SOFTCAP])
@pytest.mark.parametrize("Sq", [1, 32])
@pytest.mark.parametrize("G", [1, 2, 8])
@pytest.mark.parametrize("H", [64, 128])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_decode_kernel_at_every_split(card, dtype, H, G, Sq, softcap):
    """The cluster split forced to every count 1-8 (the binding's
    test-only ``splits``) over a 256-token cache: rows of length 0, 1, a
    tile edge, ragged and full, so some splits lie wholly past a row's
    length.  Against ``ref.flash_decode`` (fp32 2e-4; bf16 one ulp, rtol
    8e-3 atol 1e-4), a query with no valid key exactly 0; a second launch
    gives the same bits.  With softcap 30 the queries are scaled by 30."""
    q, k, v, lens = _decode_inputs(
        card, dtype, H, G, Sq, [0, 1, 32, 77, DECODE_SPLIT_S],
        seed=H + G + Sq, q_scale=SOFTCAP_Q_SCALE if softcap else 1.0)
    want = fa_ref.flash_decode(q, k, v, lens, softcap=softcap)
    rtol, atol = (2e-4, 2e-4) if dtype == torch.float32 else (8e-3, 1e-4)
    for splits in range(1, 9):
        call = lambda: fa_kernel.flash_decode(            # noqa: E731
            q, k, v, lens, softcap=softcap, splits=splits)
        got = _counted(fa_kernel.flash_decode, call)
        torch.testing.assert_close(got.float(), want.float(), rtol=rtol,
                                   atol=atol, msg=lambda m: f"{splits}: {m}")
        assert bool((got[lens == 0] == 0).all())
        again = call()
        torch.cuda.synchronize()
        assert torch.equal(got, again)


@pytest.mark.parametrize("H,dtype", [(64, torch.bfloat16),
                                     (128, torch.bfloat16),
                                     (64, torch.float32),
                                     (128, torch.float32)])
def test_flash_decode_bits_do_not_depend_on_empty_splits(card, H, dtype):
    """Every valid token in the first 32 of the cache: the other splits
    hold neutral partials, which the fold adds exactly, so every split
    count gives the bits of one split (against the plain version at the
    tolerance of the test above)."""
    q, k, v, lens = _decode_inputs(card, dtype, H, 4, 1, [0, 5, 17, 32],
                                   seed=7)
    outs = [fa_kernel.flash_decode(q, k, v, lens, splits=s)
            for s in range(1, 9)]
    want = fa_ref.flash_decode(q, k, v, lens)
    torch.cuda.synchronize()
    rtol, atol = (2e-4, 2e-4) if dtype == torch.float32 else (8e-3, 1e-4)
    torch.testing.assert_close(outs[0].float(), want.float(), rtol=rtol,
                               atol=atol)
    for got in outs[1:]:
        assert torch.equal(got, outs[0])


def test_flash_decode_smem_copy_agrees(card):
    """kernel.py's copy of the decode's shared memory (its split plan
    rests on it) equals csrc's."""
    lib = fa_kernel.load_decode_library()
    for H in fa_kernel.HEAD_DIMS:
        for dtype, code in ((torch.float32, 0), (torch.bfloat16, 1)):
            elem = torch.tensor([], dtype=dtype).element_size()
            for nr in (1, 2, 4, 8):
                assert lib.flash_decode_smem_bytes(H, code, nr) == \
                    fa_kernel.decode_smem_bytes(H, elem, nr)


@pytest.mark.parametrize("R,C,K", [
    (64, 256, 16), (100, 77, 13), (1000, 3000, 33), (9, 512, 1),
    (50, 2049, 2), (70, 5000, 7), (17, 100, 8), (20, 1, 9), (300, 4097, 24),
    (40, 16385, 32), (33, 20000, 17), (5, 33000, 16)])
def test_spmv_onehot_kernel_matches_plain(card, R, C, K):
    """The one-hot kernel against its plain version, columns at -1 and C
    among the nonzeros (they contribute 0): fp32 roundoff of the row sum
    (rtol 1e-5 of the sum of |terms|).  K from 1 to 33 (every lane and
    nonzeros-a-lane choice of ``kernel.onehot_plan``, several passes); C
    off the 2048-column compare window and the 16384-float staged chunk,
    and past one chunk."""
    vals, cols = spmv_ref.random_ell(R + C + K, R, C, K)
    cols[::5, 0] = -1
    cols[2::5, -1] = C
    x = np.random.default_rng(1).standard_normal(C).astype(np.float32)
    tv, tc, tx = (torch.from_numpy(a).to(card) for a in (vals, cols, x))
    got = _counted(spmv_kernel.spmv_ell_onehot, lambda: spmv_ops.spmv_ell(
        tv, tc, tx, idiom="onehot"))
    want = spmv_ops.spmv_ell(*(torch.from_numpy(a) for a in (vals, cols, x)),
                             idiom="onehot")
    scale = np.abs(vals).sum(-1, keepdims=True) * np.abs(x).max()
    assert np.all(np.abs(got.cpu().numpy() - want.numpy())
                  <= 1e-5 * scale + 1e-6)


def test_dense_cache_engines_on_card_match_cpu(card):
    """Reduced qwen3-1.7b in fp32 (TF32 off), head_dim 64 (the paged
    kernel's width) on tests/test_serve_families.py's mix: greedy tokens
    of the continuous engine with the paged kernel off and on, and of the
    static engine, equal on the card and on the CPU and to each other.
    With it off the flash-decode kernel launches once a layer a forward
    and the paged kernel never; with it on, the reverse."""
    _engines_card_vs_cpu(card, reduced_config("qwen3-1.7b", head_dim=64))


@pytest.mark.parametrize("arch,extra", [
    ("phi3.5-moe-42b-a6.6b", {}),
    ("grok-1-314b", dict(n_heads=6, n_kv_heads=1))])
def test_moe_engines_on_card_match_cpu(card, arch, extra):
    """The moe family as the dense test above: reduced phi3.5-moe and
    grok-1 (softcap 30; 6/1 heads: G 6) at head_dim 64, fp32."""
    _engines_card_vs_cpu(card, reduced_config(arch, head_dim=64, **extra))


def _engines_card_vs_cpu(card, cfg):
    """The attention kernels launch once an attention layer a forward, the
    SSD kernel once a mamba layer a static prefill."""
    torch.backends.cuda.matmul.allow_tf32 = False
    kinds = [cfg.layer_kind(i) for i in range(cfg.n_layers)]
    attn, mamba = kinds.count("attn"), kinds.count("mamba")
    params = LM(cfg, device="cpu").init_params(
        torch.Generator().manual_seed(0))
    rng = np.random.default_rng(2)
    prompts = [rng.integers(1, cfg.vocab_size, size=n) for n in (15, 15, 7)]
    gens = [5, 4, 6]
    outs = {}
    for dev in (card, torch.device("cpu")):
        model = LM(cfg, device=dev)
        p = _to(params, dev)
        for paged in (False, True):
            eng = ContinuousBatchingEngine(model, p, n_slots=2, max_len=32,
                                           page_size=8, prefill_chunk=4,
                                           page_budget=4, paged_kernel=paged)
            # counted after the split sweep the engine ran at construction
            before = (fa_kernel.flash_decode.launches,
                      pa_kernel.paged_flash_decode.launches)
            rids = [eng.submit(pr, g) for pr, g in zip(prompts, gens)]
            res = eng.run()
            launched = (fa_kernel.flash_decode.launches - before[0],
                        pa_kernel.paged_flash_decode.launches - before[1])
            per = attn * eng.stats.forwards
            if dev.type == "cuda":
                assert launched == ((0, per) if paged else (per, 0))
            else:
                assert launched == (0, 0)
            outs[dev.type, paged] = [res[r].tolist() for r in rids]
        before = (fa_kernel.flash_decode.launches,
                  ssd_kernel.ssd_scan_fwd.launches)
        static = StaticBatchEngine(model, p, max_len=32, batch=1)
        outs[dev.type, "static"] = [static.generate(pr[None], g)[0].tolist()
                                    for pr, g in zip(prompts, gens)]
        launched = (fa_kernel.flash_decode.launches - before[0],
                    ssd_kernel.ssd_scan_fwd.launches - before[1])
        assert launched == ((attn * sum(g - 1 for g in gens),
                             mamba * len(prompts))
                            if dev.type == "cuda" else (0, 0))
    first = outs["cuda", False]
    assert all(o == first for o in outs.values()), outs


def test_train_step_on_card_matches_cpu(card):
    """One train step of reduced qwen3-1.7b (fp32, attention_impl
    "pallas": the kernel on the card, the plain version on the CPU, TF32
    off) through ``card_step_matches_cpu``: loss and grad norm within
    1e-4 relative; the kernel launched once per layer."""
    cfg = reduced_config("qwen3-1.7b", attention_impl="pallas")
    params = LM(cfg, device="cpu").init_params(
        torch.Generator().manual_seed(0))
    got, launches = card_step_matches_cpu(cfg, params, batch=4, seq=48)
    assert launches == cfg.n_layers
    for k, want in got["cpu"].items():
        assert abs(got["cuda"][k] - want) <= 1e-4 * abs(want), (k, got)


def _ssd_args(card, b, S, h, P, N):
    """Model-layout fp32 inputs at the JAX kernel test's scales."""
    rng = np.random.default_rng(S + P + N)
    f = np.float32
    x = rng.standard_normal((b, S, h, P)).astype(f)
    dt = (np.log1p(np.exp(rng.standard_normal((b, S, h)))) * 0.1).astype(f)
    A = (-np.exp(rng.standard_normal(h))).astype(f)
    B, C = ((rng.standard_normal((b, S, N)) * 0.5).astype(f)
            for _ in range(2))
    D = rng.standard_normal(h).astype(f)
    return [torch.from_numpy(a).to(card) for a in (x, dt, A, B, C, D)]


@pytest.mark.parametrize("b,S,h,P,N,chunk", [
    (1, 1, 2, 16, 16, 16), (2, 200, 3, 16, 16, 16), (1, 200, 2, 32, 64, 64),
    (2, 300, 2, 64, 128, 256), (1, 2048, 2, 64, 128, 256),
    (2, 100, 1, 64, 32, 128), (1, 77, 2, 32, 128, 32),
    (1, 511, 2, 64, 128, 256), (1, 513, 2, 64, 128, 256),
    (2, 767, 3, 32, 64, 256), (1, 1025, 2, 16, 32, 256),
    (8, 512, 128, 64, 16, 256)])
def test_ssd_kernel_matches_plain(card, b, S, h, P, N, chunk):
    """y and h_final of the kernel against ``ref.ssd_chunked`` on the same
    card inputs (TF32 off): every P and N the kernel takes, chunks of 16
    to 256, S shorter than, not a multiple of (k * 256 +- 1 among them)
    and a multiple of the chunk, and jamba-v0.1-52b's static prefill
    layer (b 8, S 512, 128 heads, P 64, N 16); the state before each chunk (the
    workspace after the state pass) against ``ref.state_pass``.  Both
    compute in fp32 grade (the kernel in 3xTF32) and differ in summation
    order: 2e-3, the JAX kernel test's tolerance.  A second launch gives
    the same bits."""
    torch.backends.cuda.matmul.allow_tf32 = False
    args = _ssd_args(card, b, S, h, P, N)
    y, hf = _counted(ssd_kernel.ssd_scan_fwd,
                     lambda: ssd_ops.ssd_chunked(*args, chunk=chunk))
    want_y, want_h = ssd_ref.ssd_chunked(*args, chunk=chunk)
    torch.testing.assert_close(y, want_y, rtol=2e-3, atol=2e-3)
    torch.testing.assert_close(hf, want_h, rtol=2e-3, atol=2e-3)
    x, dt, A, B, C, D = args
    y2, hf2, h_prev = ssd_kernel.ssd_scan_fwd(
        x, dt, B, C, A.repeat(b), D.repeat(b), chunk=chunk,
        return_states=True)
    want_prev, _ = ssd_ref.state_pass(
        ssd_ref.chunk_states(x, dt, A, B, C, chunk), dt, A, chunk)
    torch.cuda.synchronize()
    torch.testing.assert_close(h_prev, want_prev, rtol=2e-3, atol=2e-3)
    assert torch.equal(y, y2) and torch.equal(hf, hf2)


def test_ssd_kernel_is_fp32_grade(card):
    """At b 1, S 512, 2 heads, P 64, N 128, chunk 256, y is within 1e-4 of
    the largest |y| of the plain version run in fp64: fp32 grade, which a
    single TF32 pass (operands with ~5e-4 relative error) would miss."""
    args = _ssd_args(card, 1, 512, 2, 64, 128)
    y, _ = ssd_ops.ssd_chunked(*args, chunk=256)
    y64, _ = ssd_ref.ssd_chunked(*[a.double() for a in args], chunk=256)
    torch.cuda.synchronize()
    err = float((y.double() - y64).abs().max())
    assert err <= 1e-4 * float(y64.abs().max()), err


def test_ssd_stream_layout_and_gradient_on_card(card):
    """``ops.ssd_scan`` (one stream a row, A/D per stream) on the card
    against the CPU; a call that needs a gradient raises on the card."""
    rng = np.random.default_rng(0)
    BH, S, P, N = 4, 96, 16, 32
    f = np.float32
    x = torch.from_numpy(rng.standard_normal((BH, S, P)).astype(f))
    dt = torch.from_numpy((np.log1p(np.exp(rng.standard_normal(
        (BH, S, 1)))) * 0.1).astype(f))
    B, C = (torch.from_numpy((rng.standard_normal((BH, S, N)) * 0.5)
                             .astype(f)) for _ in range(2))
    A = torch.from_numpy((-np.exp(rng.standard_normal(BH))).astype(f))
    D = torch.ones(BH)
    args = (x, dt, B, C, A, D)
    got = _counted(ssd_kernel.ssd_scan_fwd, lambda: ssd_ops.ssd_scan(
        *[a.to(card) for a in args], chunk=32))
    torch.testing.assert_close(got.cpu(), ssd_ops.ssd_scan(*args, chunk=32),
                               rtol=2e-3, atol=2e-3)
    with pytest.raises(NotImplementedError, match="SSD backward"):
        ssd_ops.ssd_scan(x.to(card).requires_grad_(),
                         *[a.to(card) for a in args[1:]], chunk=32)


def test_ssm_engines_on_card_match_cpu(card):
    """Reduced mamba2-780m in fp32: greedy tokens of the continuous and
    the static engine on the card equal the CPU's (and each other's); the
    static prefill launches the SSD kernel once a layer, the continuous
    engine (recurrent prefill) never."""
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = reduced_config("mamba2-780m")
    params = LM(cfg, device="cpu").init_params(
        torch.Generator().manual_seed(0))
    rng = np.random.default_rng(2)
    prompts = [rng.integers(1, cfg.vocab_size, size=n) for n in (15, 15, 7)]
    gens = [5, 4, 6]
    outs = []
    for dev in (card, torch.device("cpu")):
        model = LM(cfg, device=dev)
        p = _to(params, dev)
        before = ssd_kernel.ssd_scan_fwd.launches
        eng = ContinuousBatchingEngine(model, p, n_slots=2, max_len=32,
                                       page_size=8, prefill_chunk=4,
                                       page_budget=4)
        rids = [eng.submit(pr, g) for pr, g in zip(prompts, gens)]
        res = eng.run()
        assert ssd_kernel.ssd_scan_fwd.launches == before
        static = StaticBatchEngine(model, p, max_len=32, batch=1)
        st = [static.generate(pr[None], g)[0].tolist()
              for pr, g in zip(prompts, gens)]
        launched = ssd_kernel.ssd_scan_fwd.launches - before
        assert launched == (cfg.n_layers * len(prompts)
                            if dev.type == "cuda" else 0)
        cont = [res[r].tolist() for r in rids]
        assert cont == st
        outs.append(cont)
    assert outs[0] == outs[1]


@pytest.mark.parametrize("M,K,N", [
    (128, 256, 128), (256, 128, 384), (1, 37, 61), (7, 130, 9),
    (8, 1000, 776), (8, 2048, 1000), (33, 300, 257), (8, 128, 4096),
    (3, 256, 17008), (8, 2000, 1008), (9, 2000, 1008), (33, 2000, 1008),
    (65, 2000, 1008), (256, 2000, 1008), (65, 300, 257), (300, 2048, 520),
    (16, 32, 48), (8, 8192, 1024), (65, 8192, 1024)])
@pytest.mark.parametrize("transposed", [False, True])
@pytest.mark.parametrize("x_dtype,out_dtype", [
    (torch.float32, torch.float32), (torch.bfloat16, torch.bfloat16),
    (torch.bfloat16, torch.float32)])
def test_wq_gemm_kernel_matches_plain(card, M, K, N, transposed, x_dtype,
                                      out_dtype):
    """Both layouts and every path of ``kernel.plan``: the GEMV (M <= 8,
    with a K split: (8, 2048, 1000); without: (8, 128, 4096), (3, 256,
    17008)) on the tensor cores for bf16 x and the CUDA cores for fp32;
    past it wgmma for bf16 x (M 9, 16, 33, 65, 256, 300: every tile) and
    the tiled kernel for fp32, ragged
    M, K and N, 16-byte loads (K 2000, N 1008: off every tile; K 32, N
    48: smaller than a TMA box) and byte loads; K 8192 with unit-scale
    weights, the longest sums (the GEMV, wgmma's promoted (64, 64) tile
    and the tiled kernel).  fp32 out within 2e-4 of the plain
    version's (the JAX test's tolerance: fp32 sums in another order);
    bf16 out is the kernel's fp32
    sum rounded once: within half a bf16 ulp of it, and so of the plain
    fp32 value within that plus their fp32 difference."""
    torch.backends.cuda.matmul.allow_tf32 = False
    rng = np.random.default_rng(M * N + K)
    x = torch.from_numpy(rng.standard_normal((M, K)).astype(np.float32))
    w = torch.from_numpy(rng.standard_normal((K, N)).astype(np.float32))
    q, s = wq_ref.quantize(w)
    if transposed:
        q = q.T.contiguous()
    args = (x.to(card, x_dtype), q.to(card), s.to(card))
    got = _counted(wq_kernel.wq_gemm, lambda: wq_ops.wq_gemm(
        *args, out_dtype=out_dtype, q_transposed=transposed))
    assert got.dtype == out_dtype and got.shape == (M, N)
    k32 = wq_ops.wq_gemm(*args, out_dtype=torch.float32,
                         q_transposed=transposed)
    p32 = wq_ref.wq_gemm(*args, out_dtype=torch.float32,
                         q_transposed=transposed)
    torch.testing.assert_close(k32, p32, rtol=2e-4, atol=2e-4)
    got = got.float()
    if out_dtype == torch.float32:
        assert torch.equal(got, k32)
    else:
        half_ulp = torch.exp2(torch.floor(torch.log2(got.abs().clamp_min(
            1e-30))) - 8)
        assert bool(((got - p32).abs() <= half_ulp + (k32 - p32).abs())
                    .all())


@pytest.mark.parametrize("M,K,N", [(8, 8192, 2048), (8, 2048, 8192),
                                   (1, 8192, 2048), (65, 8192, 2048)])
@pytest.mark.parametrize("transposed", [False, True])
def test_wq_gemm_kernel_fp32_x_at_model_scale(card, M, K, N, transposed):
    """fp32 x (the reduced configurations' and the parity checks' path) at
    granite-3-2b's own K and N, decode rows and past the GEMV's M, weights
    at the model's initializer scale (K^-1/2, as chip_smoke.py draws them):
    within 2e-4 of the plain version."""
    torch.backends.cuda.matmul.allow_tf32 = False
    rng = np.random.default_rng(M + K + N)
    x = torch.from_numpy(rng.standard_normal((M, K)).astype(np.float32))
    q, s = wq_ref.quantize(torch.from_numpy(
        (rng.standard_normal((K, N)) * K ** -0.5).astype(np.float32)))
    if transposed:
        q = q.T.contiguous()
    args = (x.to(card), q.to(card), s.to(card))
    got = _counted(wq_kernel.wq_gemm, lambda: wq_ops.wq_gemm(
        *args, q_transposed=transposed))
    assert got.dtype == torch.float32 and got.shape == (M, N)
    torch.testing.assert_close(got, wq_ref.wq_gemm(
        *args, q_transposed=transposed), rtol=2e-4, atol=2e-4)


@pytest.mark.parametrize("transposed", [False, True])
@pytest.mark.parametrize("M,x_dtype", [(8, torch.float32),
                                       (8, torch.bfloat16),
                                       (65, torch.bfloat16)])
def test_wq_gemm_kernel_unaligned_q_takes_the_byte_path(card, transposed, M,
                                                        x_dtype):
    """A q that starts off a 16-byte boundary: the kernel loads bytes
    (no vector loads), with the same result, on each path."""
    torch.backends.cuda.matmul.allow_tf32 = False
    rng = np.random.default_rng(9)
    K, N = 512, 256
    x = torch.from_numpy(rng.standard_normal((M, K)).astype(np.float32)).to(
        x_dtype)
    q, s = wq_ref.quantize(torch.from_numpy(
        rng.standard_normal((K, N)).astype(np.float32)))
    if transposed:
        q = q.T.contiguous()
    buf = torch.empty(q.numel() + 1, dtype=torch.int8, device=card)
    qu = buf[1:].view(q.shape)
    qu.copy_(q.to(card))
    assert qu.data_ptr() % 4 and qu.is_contiguous()
    args = (x.to(card), qu, s.to(card))
    got = _counted(wq_kernel.wq_gemm, lambda: wq_ops.wq_gemm(
        *args, out_dtype=torch.float32, q_transposed=transposed))
    torch.testing.assert_close(got, wq_ref.wq_gemm(
        *args, out_dtype=torch.float32, q_transposed=transposed),
        rtol=2e-4, atol=2e-4)


@pytest.mark.parametrize("x_dtype", [torch.bfloat16, torch.float32])
def test_wq_gemv_k_split_gives_the_same_bits_on_two_streams(card, x_dtype):
    """K-split GEMVs in flight on two streams at once: the split's blocks
    sum in rank order inside their cluster, so every result equals the
    same call made alone, bit for bit."""
    torch.backends.cuda.matmul.allow_tf32 = False
    rng = np.random.default_rng(11)
    M, K, N = 8, 4096, 1024
    sms = torch.cuda.get_device_properties(card).multi_processor_count
    assert wq_kernel.plan(M, N, K, x_dtype == torch.bfloat16,
                          sms).splits > 1
    x = torch.from_numpy(rng.standard_normal((2, M, K)).astype(
        np.float32)).to(card, x_dtype)
    q, s = wq_ref.quantize(torch.from_numpy(
        rng.standard_normal((K, N)).astype(np.float32)))
    q, s = q.to(card), s.to(card)
    want = [wq_ops.wq_gemm(x[i], q, s) for i in range(2)]
    streams = [torch.cuda.Stream(card) for _ in range(2)]
    torch.cuda.synchronize(card)
    outs = [[], []]
    for _ in range(20):
        for i, stream in enumerate(streams):
            with torch.cuda.stream(stream):
                outs[i].append(wq_ops.wq_gemm(x[i], q, s))
    torch.cuda.synchronize(card)
    for i in range(2):
        assert all(torch.equal(out, want[i]) for out in outs[i])


@pytest.mark.parametrize("arch,per_layer", [("granite-3-2b", 7),
                                            ("mamba2-780m", 6),
                                            ("phi3.5-moe-42b-a6.6b",
                                             4 + 3 * 4)])
def test_int8_engines_on_card_match_cpu(card, arch, per_layer):
    """Quantized reduced models in fp32: greedy tokens of the continuous
    and the static engine on the card equal the CPU's (and each
    other's); every forward on the card launches the int8 GEMM once a
    q-pack matmul: per_layer x n_layers + 1 (the unembed; moe: 4
    attention packs and 3 an expert a layer)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = reduced_config(arch) if arch == "mamba2-780m" \
        else reduced_config(arch, head_dim=64)
    params = quantize_params(LM(cfg, device="cpu").init_params(
        torch.Generator().manual_seed(0)))
    rng = np.random.default_rng(2)
    prompts = [rng.integers(1, cfg.vocab_size, size=n) for n in (15, 15, 7)]
    gens = [5, 4, 6]
    outs = []
    for dev in (card, torch.device("cpu")):
        model = LM(cfg, device=dev)
        p = _to(params, dev)
        before = wq_kernel.wq_gemm.launches
        eng = ContinuousBatchingEngine(model, p, n_slots=2, max_len=32,
                                       page_size=8, prefill_chunk=4,
                                       page_budget=4)
        rids = [eng.submit(pr, g) for pr, g in zip(prompts, gens)]
        res = eng.run()
        static = StaticBatchEngine(model, p, max_len=32, batch=1)
        st = [static.generate(pr[None], g)[0].tolist()
              for pr, g in zip(prompts, gens)]
        forwards = eng.stats.summary()["forwards"] + sum(gens)
        launched = wq_kernel.wq_gemm.launches - before
        assert launched == ((per_layer * cfg.n_layers + 1) * forwards
                            if dev.type == "cuda" else 0)
        cont = [res[r].tolist() for r in rids]
        assert cont == st
        outs.append(cont)
    assert outs[0] == outs[1]


def _to(tree, dev):
    if isinstance(tree, dict):
        return {k: _to(v, dev) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_to(v, dev) for v in tree]
    return tree.to(dev)


# ---------------------------------------------------------------------------
# the moe slice: B1 and B3 at the served head groups, the MoE on the card
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("softcap", [0.0, SOFTCAP])
@pytest.mark.parametrize("sq", [1, 32])
@pytest.mark.parametrize("NKV,G,H", [(8, 6, 128), (10, 4, 128), (8, 1, 64),
                                     (8, 8, 128)])
@pytest.mark.parametrize("splits", [None, 1, 3, 8])
def test_paged_kernel_at_served_groups(card, NKV, G, H, sq, softcap,
                                       splits):
    """The paged kernel at grok-1's G 6 (decode R 6, a 32-column chunk
    192 rows), phi3-medium-14b's 10 KV heads, whisper-base's G 1 (MHA, H
    64) and llama-3.2-vision-90b's G 8 (a chunk 256 rows), bf16, at the
    plan's split and forced ones, without and with softcap 30 (queries x
    30): partials against the plain version (2e-3), the empty row
    neutral, a second launch the same bits."""
    args = _paged_inputs(card, H, sq, True, torch.bfloat16,
                         [0, 8, 17, 200, 256], seed=NKV + G + sq, NKV=NKV,
                         G=G)
    if softcap:
        args[0] = args[0] * SOFTCAP_Q_SCALE
    grouped, Sq = _grouped(args)
    assert grouped[0].shape[1:3] == (NKV, G * sq)
    call = lambda: pa_kernel.paged_flash_decode(              # noqa: E731
        *grouped, sq=Sq, splits=splits, softcap=softcap)
    got = _counted(pa_kernel.paged_flash_decode, call)
    want = pa_ref.paged_partials(*grouped, sq=Sq, softcap=softcap)
    torch.cuda.synchronize()
    live = want[2] > 0
    torch.testing.assert_close(got[0], want[0], rtol=2e-3, atol=2e-3)
    torch.testing.assert_close(got[2], want[2], rtol=2e-3, atol=2e-3)
    torch.testing.assert_close(got[1][live], want[1][live], rtol=2e-3,
                               atol=2e-3)
    assert (got[0][0] == 0).all() and (got[2][0] == 0).all()
    again = call()
    torch.cuda.synchronize()
    assert all(torch.equal(a, b) for a, b in zip(got, again))


@pytest.mark.parametrize("softcap", [0.0, SOFTCAP])
@pytest.mark.parametrize("Sq", [1, 32])
@pytest.mark.parametrize("NKV,G", [(8, 6), (10, 4)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_decode_at_served_groups(card, dtype, NKV, G, Sq, softcap):
    """The flash-decode kernel at G 6 (a block of 8 query rows holds 6)
    and NKV 10 (B x NKV not a power of two), H 128, every forced split
    and the plan's, softcap 30 over queries x 30: against
    ``ref.flash_decode`` (fp32 2e-4; bf16 one ulp)."""
    q, k, v, lens = _decode_inputs(
        card, dtype, 128, G, Sq, [0, 1, 32, 77, DECODE_SPLIT_S],
        seed=NKV + G + Sq, q_scale=SOFTCAP_Q_SCALE if softcap else 1.0,
        NKV=NKV)
    want = fa_ref.flash_decode(q, k, v, lens, softcap=softcap)
    rtol, atol = (2e-4, 2e-4) if dtype == torch.float32 else (8e-3, 1e-4)
    for splits in (None, *range(1, 9)):
        got = _counted(fa_kernel.flash_decode, lambda: fa_kernel.flash_decode(
            q, k, v, lens, softcap=softcap, splits=splits))
        torch.testing.assert_close(got.float(), want.float(), rtol=rtol,
                                   atol=atol, msg=lambda m: f"{splits}: {m}")
        assert bool((got[lens == 0] == 0).all())


@pytest.mark.parametrize("B", [1, 3])
@pytest.mark.parametrize("Sq", [1, 32])
@pytest.mark.parametrize("S,NQ,NKV,H", [(1601, 64, 8, 128),
                                        (1500, 8, 8, 64)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_decode_at_cross_capacities(card, dtype, S, NQ, NKV, H, Sq, B):
    """The flash-decode kernel as a cross layer's decode runs it: every
    query over all S installed keys, S off the 32-token tile
    (llama-3.2-vision's 1601 image tokens, G 8; whisper's 1500 frames, G
    1), so a split ends in a partial tile; the cache a layer's view of a
    stacked one; B 1 at Sq 32 is the continuous engine's prefill chunk
    (one slot a forward); at the plan's split and every forced one,
    against ``ref.flash_decode`` (fp32 2e-4; bf16 one ulp)."""
    rng = np.random.default_rng(S + Sq + B)
    q = torch.from_numpy(rng.standard_normal((B, Sq, NQ, H)).astype(
        np.float32)).to(card, dtype)
    stacked = torch.from_numpy(rng.standard_normal(
        (2, 2, B, S, NKV, H)).astype(np.float32)).to(card, dtype)
    k, v = stacked[0, 1], stacked[1, 1]
    lens = torch.full((B, Sq), S, dtype=torch.int32, device=card)
    want = fa_ref.flash_decode(q, k, v, lens)
    rtol, atol = (2e-4, 2e-4) if dtype == torch.float32 else (8e-3, 1e-4)
    for splits in (None, *range(1, 9)):
        got = _counted(fa_kernel.flash_decode, lambda: fa_kernel.flash_decode(
            q, k, v, lens, splits=splits))
        torch.testing.assert_close(got.float(), want.float(), rtol=rtol,
                                   atol=atol, msg=lambda m: f"{splits}: {m}")
    full = _counted(fa_kernel.flash_decode, lambda: fa_ops.flash_decode(
        q, k, v, torch.full((B,), S, dtype=torch.int32, device=card)))
    torch.testing.assert_close(full.float(), want.float(), rtol=rtol,
                               atol=atol)


def _moe_case(capacity_factor):
    cfg = reduced_config("phi3.5-moe-42b-a6.6b")
    cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
        cfg.moe, capacity_factor=capacity_factor))
    p = moe.init_moe(torch.Generator().manual_seed(1), cfg, "cpu")
    x = torch.from_numpy(np.random.default_rng(2).standard_normal(
        (3, 16, cfg.d_model)).astype(np.float32))
    return cfg, p, x


@pytest.mark.parametrize("capacity_factor", [4.0, 1.0])
def test_moe_apply_on_card_matches_cpu(card, capacity_factor):
    """fp32, TF32 off: y and aux of ``moe_apply`` on the card against the
    CPU, dropless and with choices dropped (1e-4)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg, p, x = _moe_case(capacity_factor)
    y, aux = moe.moe_apply(p, x, cfg)
    yc, auxc = moe.moe_apply(_to(p, card), x.to(card), cfg)
    torch.testing.assert_close(yc.cpu(), y, rtol=1e-4, atol=1e-4)
    torch.testing.assert_close(auxc.cpu(), aux, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("x_dtype,tol", [(torch.float32, 2e-4),
                                         (torch.bfloat16, 2e-2)])
def test_int8_moe_on_card_launches_one_gemm_an_expert(card, x_dtype, tol):
    """An int8 expert tree: ``moe_apply`` on the card launches the int8
    GEMM 3 x E times (one an expert and projection), against the CPU's
    plain version on the same packs (fp32 x: 2e-4, the kernel test's;
    bf16 x: 2e-2, three bf16 roundings of the activations); in a
    gradient context the card raises (no fallback)."""
    cfg, p, x = _moe_case(1.0)
    qp = quantize_params(p)
    want, _ = moe.moe_apply(qp, x.to(x_dtype), cfg, with_aux=False)
    before = wq_kernel.wq_gemm.launches
    got, _ = moe.moe_apply(_to(qp, card), x.to(card, x_dtype), cfg,
                           with_aux=False)
    torch.cuda.synchronize()
    assert wq_kernel.wq_gemm.launches - before == 3 * cfg.moe.num_experts
    torch.testing.assert_close(got.cpu().float(), want.float(), rtol=tol,
                               atol=tol)
    with pytest.raises(NotImplementedError):
        moe.moe_apply(_to(qp, card), x.to(card).requires_grad_(True), cfg)


def test_int8_moe_decode_forward_launch_count(card):
    """One decode forward of reduced phi3.5-moe in int8 on the card (8 x
    1): the int8 GEMM launched n_layers x (4 + 3 x E) + 1 times, the
    formula phase 6e holds the full width to (32 x (4 + 3 x 16) + 1 =
    1665)."""
    cfg = reduced_config("phi3.5-moe-42b-a6.6b", head_dim=64)
    model = LM(cfg, device=card)
    params = model.init_params(torch.Generator(device=card).manual_seed(0),
                               int8=True)
    cache = model.init_cache(8, 64)
    cache["pos"].fill_(20)
    before = wq_kernel.wq_gemm.launches
    logits, _ = model.forward(
        params, torch.ones((8, 1), dtype=torch.long, device=card),
        torch.full((8, 1), 20, dtype=torch.long, device=card), cache=cache)
    torch.cuda.synchronize()
    assert wq_kernel.wq_gemm.launches - before == \
        cfg.n_layers * (4 + 3 * cfg.moe.num_experts) + 1
    assert bool(torch.isfinite(logits).all())


# ---------------------------------------------------------------------------
# the hybrid slice: jamba-v0.1-52b's shapes, the hybrid engines
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("x_dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("M,K,N", [
    (8, 4096, 14336), (8, 14336, 4096), (640, 4096, 14336),
    (640, 14336, 4096), (8, 4096, 16), (4096, 4096, 16), (8, 4096, 128),
    (4096, 4096, 128)])
def test_wq_gemm_kernel_at_jamba_shapes(card, M, K, N, x_dtype):
    """jamba-v0.1-52b's int8 products, weights at the initializer's scale:
    an expert's gate / up (4096 -> 14336) and down at decode (M 8) and at
    the static prefill (M 640: 8 rows x capacity 80), and the mamba B / C
    (N 16) and dt (N 128) projections at decode and at the static prefill
    (M 8 x 512).  fp32 out within 2e-4 of the plain version (the JAX
    test's tolerance), bf16 x (served) and fp32 x (the parity checks')."""
    torch.backends.cuda.matmul.allow_tf32 = False
    g = torch.Generator(device=card).manual_seed(M + K + N)
    x = torch.randn((M, K), generator=g, device=card).to(x_dtype)
    q, s = wq_ref.quantize(torch.randn((K, N), generator=g, device=card)
                           * K ** -0.5)
    got = _counted(wq_kernel.wq_gemm, lambda: wq_ops.wq_gemm(
        x, q, s, out_dtype=torch.float32))
    want = wq_ref.wq_gemm(x, q, s, out_dtype=torch.float32)
    torch.testing.assert_close(got, want, rtol=2e-4, atol=2e-4)


def test_hybrid_engines_on_card_match_cpu(card):
    """Reduced jamba-v0.1-52b (one period: 1 attention and 7 mamba layers,
    MoE on 4) at head_dim 64, fp32, as the dense test above: the
    attention kernels once a forward, the SSD kernel 7 times a static
    prefill."""
    _engines_card_vs_cpu(card, reduced_config("jamba-v0.1-52b",
                                              head_dim=64))


def test_int8_hybrid_engines_on_card_match_cpu(card):
    """Reduced jamba-v0.1-52b quantized to int8, fp32 x: greedy tokens of
    the continuous and the static engine equal on the card and on the CPU
    (and each other's); every forward on the card launches the int8 GEMM
    107 times (4 + 3 attention, 7 x 6 mamba, 3 x 3 dense MLP and 4 x 3 x
    4 expert products, the unembed: the formula phase 6h holds the full
    width to, 1001)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = reduced_config("jamba-v0.1-52b", head_dim=64)
    params = quantize_params(LM(cfg, device="cpu").init_params(
        torch.Generator().manual_seed(0)))
    rng = np.random.default_rng(2)
    prompts = [rng.integers(1, cfg.vocab_size, size=n) for n in (15, 15, 7)]
    gens = [5, 4, 6]
    outs = []
    for dev in (card, torch.device("cpu")):
        model = LM(cfg, device=dev)
        p = _to(params, dev)
        before = wq_kernel.wq_gemm.launches
        eng = ContinuousBatchingEngine(model, p, n_slots=2, max_len=32,
                                       page_size=8, prefill_chunk=4,
                                       page_budget=4)
        rids = [eng.submit(pr, g) for pr, g in zip(prompts, gens)]
        res = eng.run()
        static = StaticBatchEngine(model, p, max_len=32, batch=1)
        st = [static.generate(pr[None], g)[0].tolist()
              for pr, g in zip(prompts, gens)]
        forwards = eng.stats.summary()["forwards"] + sum(gens)
        assert wq_kernel.wq_gemm.launches - before == (
            107 * forwards if dev.type == "cuda" else 0)
        cont = [res[r].tolist() for r in rids]
        assert cont == st
        outs.append(cont)
    assert outs[0] == outs[1]


# ---------------------------------------------------------------------------
# the cross-attention slice: llama-3.2-vision-90b and whisper-base
# ---------------------------------------------------------------------------
def _gated(params, value):
    for k, v in (params.items() if isinstance(params, dict)
                 else enumerate(params)):
        if k == "gate_attn":
            v.fill_(value)
        elif isinstance(v, (dict, list)):
            _gated(v, value)
    return params


@pytest.mark.parametrize("arch,per_fwd,per_install", [
    ("llama-3.2-vision-90b", 4 * 7 + 5 + 1, 2),
    ("whisper-base", 2 * (4 + 2 + 2) + 1, 2 * 6 + 2 * 2)])
def test_int8_cross_decode_forward_launch_counts(card, arch, per_fwd,
                                                 per_install):
    """Reduced llama-3.2-vision-90b (4 attention layers and the gated
    cross layer) and whisper-base (2 decoder layers, 2 encoder layers) in
    int8 on the card, gate_attn 0.5: one install launches the int8 GEMM
    per_install times (each cross layer's wk and wv over the context; the
    encoder's 4 + 2 a layer first); one decode forward (8 x 1) per_fwd
    times (a self-attention layer 4, a cross-attention 2: wq and wo, a
    SwiGLU MLP 3, a GELU MLP 2, the unembed), the flash-decode kernel
    once a layer (self and cross) on the dense-cache path, and with a
    page map the paged kernel once a self-attention layer and the
    flash-decode kernel once a cross layer; finite logits."""
    from repro_torch.models.attention import PagedDecodeState
    from repro_torch.models.decode_state import stub_context
    cfg = reduced_config(arch, head_dim=64)
    model = LM(cfg, device=card)
    params = _gated(model.init_params(
        torch.Generator(device=card).manual_seed(0), int8=True), 0.5)
    n_cross = cfg.n_layers // (cfg.cross_attn_period or 1)
    n_self = cfg.n_layers - (n_cross if cfg.cross_attn_period else 0)
    cache = model.init_cache(8, 64)
    for slot in range(8):
        before = wq_kernel.wq_gemm.launches
        model.install_slot_context(params, cache, slot, stub_context(
            cfg, np.random.default_rng(slot)))
        assert wq_kernel.wq_gemm.launches - before == per_install
    toks = torch.ones((8, 1), dtype=torch.long, device=card)
    pos = torch.full((8, 1), 20, dtype=torch.long, device=card)
    page_idx = torch.arange(8 * 8, dtype=torch.int32,
                            device=card).view(8, 8)
    for paged in (None, PagedDecodeState(page_idx, 8)):
        cache["self"]["pos"].fill_(20)
        before = (wq_kernel.wq_gemm.launches,
                  fa_kernel.flash_decode.launches,
                  pa_kernel.paged_flash_decode.launches)
        logits, _ = model.forward(params, toks, pos, cache=cache,
                                  paged=paged)
        torch.cuda.synchronize()
        got = (wq_kernel.wq_gemm.launches - before[0],
               fa_kernel.flash_decode.launches - before[1],
               pa_kernel.paged_flash_decode.launches - before[2])
        assert got == ((per_fwd, n_self + n_cross, 0) if paged is None
                       else (per_fwd, n_cross, n_self))
        assert bool(torch.isfinite(logits).all())


@pytest.mark.parametrize("arch", ["llama-3.2-vision-90b", "whisper-base"])
def test_cross_engines_on_card_match_cpu(card, arch):
    """Reduced llama-3.2-vision-90b and whisper-base at head_dim 64, fp32,
    gate_attn 0.5, on tests/test_serve_families.py's mix with a stub
    context a request (a preemption and its re-install, a mid-run
    admission): the continuous engine (paged kernel off and on) and the
    static engine give the same greedy tokens on the card as on the
    CPU."""
    from repro_torch.models.decode_state import stub_context
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = reduced_config(arch, head_dim=64)
    params = _gated(LM(cfg, device="cpu").init_params(
        torch.Generator().manual_seed(0)), 0.5)
    rng = np.random.default_rng(2)
    prompts = [rng.integers(1, cfg.vocab_size, size=n) for n in (15, 15, 7)]
    gens = [5, 4, 6]
    extras = [stub_context(cfg, rng, scale=0.05) for _ in prompts]
    aux = -(-LM(cfg, device="cpu").decode_state.context_tokens(cfg) // 8)
    outs = {}
    for dev in (card, torch.device("cpu")):
        model = LM(cfg, device=dev)
        p = _to(params, dev)
        for paged in (False, True):
            eng = ContinuousBatchingEngine(
                model, p, n_slots=2, max_len=32, page_size=8,
                prefill_chunk=4, page_budget=4 + 2 * aux, paged_kernel=paged)
            rids = [eng.submit(pr, g, extra=e)
                    for pr, g, e in zip(prompts, gens, extras)]
            res = eng.run()
            assert sum(r.n_preemptions for r in eng.requests()) >= 1
            outs[dev.type, paged] = [res[r].tolist() for r in rids]
        static = StaticBatchEngine(model, p, max_len=32, batch=1)
        outs[dev.type, "static"] = [
            static.generate(pr[None], g, extra={k: v[None] for k, v in
                                                e.items()})[0].tolist()
            for pr, g, e in zip(prompts, gens, extras)]
    first = outs["cuda", False]
    assert all(o == first for o in outs.values()), outs


# ---------------------------------------------------------------------------
# the serving features: the verify width, spec_decode, prefix_cache
# ---------------------------------------------------------------------------
VERIFY_SQ = 5                         # spec_k 4 + 1
VERIFY_N_VALID = (0, 1, 3, 5, 5, 3, 1, 0)
VERIFY_BEFORE = (0, 17, 64, 200, 0, 1, 250, 96)      # pos before the step


def _verify_rows(card):
    """Each row's position before the step, its fed width and its valid
    length after the ragged write (``pos + n_valid``)."""
    before = torch.tensor(VERIFY_BEFORE, dtype=torch.int32)
    n_valid = torch.tensor(VERIFY_N_VALID, dtype=torch.int32)
    return before.to(card), (before + n_valid).to(card)


@pytest.mark.parametrize("H,G,NKV,dtype", [
    (64, 4, 8, torch.bfloat16), (64, 4, 8, torch.float32),
    (128, 2, 8, torch.bfloat16), (128, 2, 8, torch.float32)])
def test_paged_kernel_at_the_verify_width(card, H, G, NKV, dtype):
    """B1 at the verify forward's shape: Sq 5, granite's (32/8, H 64) and
    qwen3's (16/8, H 128) heads, each row's queries at its positions
    ``pos + c`` with ``kv_valid = pos + n_valid`` (n_valid 0 to 5: the
    columns past it see every valid key and are discarded by the
    engine).  Partials and output against the plain version within 2e-3,
    all finite; a row with no valid key 0."""
    rng = np.random.default_rng(H + G)
    B, pps = len(VERIFY_N_VALID), 32
    before, kv_valid = _verify_rows(card)
    q = torch.from_numpy(rng.standard_normal(
        (B, VERIFY_SQ, NKV * G, H))).float().to(card)
    kp, vp = (torch.from_numpy(rng.standard_normal(
        (B * pps, PAGE, NKV, H))).to(card, dtype) for _ in range(2))
    idx = torch.from_numpy(rng.permutation(B * pps).reshape(B, pps).astype(
        np.int32)).to(card)
    pos = (before[:, None] + torch.arange(VERIFY_SQ, device=card)[None])
    args = [q, kp, vp, idx, pos.to(torch.int32), kv_valid]
    got = _counted(pa_kernel.paged_flash_decode,
                   lambda: pa_ops.paged_attention(*args, page_size=PAGE,
                                                  return_partials=True))
    want = pa_ops.paged_attention(*[a.cpu() for a in args], page_size=PAGE,
                                  return_partials=True)
    assert all(bool(torch.isfinite(t).all()) for t in got)
    live = want[1] > 0
    torch.testing.assert_close(got[0].cpu()[live], want[0][live], rtol=2e-3,
                               atol=2e-3)
    torch.testing.assert_close(got[1].cpu(), want[1], rtol=2e-3, atol=2e-3)
    torch.testing.assert_close(got[2].cpu(), want[2], rtol=2e-3, atol=2e-3)
    out = pa_ops.combine_partials([got]).cpu()
    assert bool(torch.isfinite(out).all()) and bool((out[0] == 0).all())
    torch.testing.assert_close(out, pa_ops.combine_partials([want]),
                               rtol=2e-3, atol=2e-3)


@pytest.mark.parametrize("H,G,dtype", [
    (64, 4, torch.bfloat16), (64, 4, torch.float32),
    (128, 2, torch.bfloat16), (128, 2, torch.float32)])
def test_flash_decode_kernel_at_the_verify_width(card, H, G, dtype):
    """B3 (``paged_kernel=False``) at the verify width: Sq 5, each query's
    valid length ``attention.query_lens`` of its position and the row's
    ``pos + n_valid``, over a strided cache view.  fp32 within 2e-4, bf16
    within one ulp; a query with no valid key 0."""
    from repro_torch.models.attention import query_lens
    rng = np.random.default_rng(H + G + 5)
    B, S, NKV = len(VERIFY_N_VALID), 256, 8
    before, kv_valid = _verify_rows(card)
    q = torch.from_numpy(rng.standard_normal(
        (B, VERIFY_SQ, NKV * G, H)).astype(np.float32)).to(card, dtype)
    wide = torch.from_numpy(rng.standard_normal(
        (2 * B, S, NKV, H)).astype(np.float32)).to(card, dtype)
    k, v = wide[::2], wide[1::2]
    pos = before[:, None].long() + torch.arange(VERIFY_SQ, device=card)[None]
    lens = query_lens(pos, kv_valid, S)
    got = _counted(fa_kernel.flash_decode, lambda: fa_ops.flash_decode(
        q, k, v, lens))
    want = fa_ref.flash_decode(q, k, v, lens)
    rtol, atol = (2e-4, 2e-4) if dtype == torch.float32 else (8e-3, 1e-4)
    torch.testing.assert_close(got.float(), want.float(), rtol=rtol,
                               atol=atol)
    assert bool(torch.isfinite(got.float()).all())
    assert bool((got[lens == 0] == 0).all())


@pytest.mark.parametrize("paged", [True, False])
def test_verify_forward_discarded_columns_are_finite(card, paged):
    """One verify-shaped decode forward of reduced granite-3-2b (H 64,
    fp32) on the card over a cache with rows of 0-40 tokens, n_valid 0,
    1, 3, 5: every logit finite (the columns past a row's n_valid too),
    the kept columns' logits equal the CPU's within 1e-4, each row's
    counter advanced by its n_valid, and the attention kernel (B1, or B3
    with the paged kernel off) launched once a layer."""
    from repro_torch.models.attention import PagedDecodeState
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = reduced_config("granite-3-2b", head_dim=64)
    params = LM(cfg, device="cpu").init_params(
        torch.Generator().manual_seed(0))
    rng = np.random.default_rng(4)
    B, L, W = 4, 48, VERIFY_SQ
    ctx = [0, 7, 23, 40]
    n_valid = torch.tensor([0, 1, 3, 5], dtype=torch.int32)
    toks = torch.from_numpy(rng.integers(1, cfg.vocab_size, size=(B, W)))
    prompts = [torch.from_numpy(rng.integers(1, cfg.vocab_size,
                                             size=(1, n))) for n in ctx]
    got = {}
    for dev in (card, torch.device("cpu")):
        model = LM(cfg, device=dev)
        p = _to(params, dev)
        cache = model.init_cache(B, L)
        for r, (n, prompt) in enumerate(zip(ctx, prompts)):
            if n:
                model.forward(p, prompt.to(dev),
                              torch.arange(n, device=dev)[None],
                              cache=model.cache_row(cache, r))
        pos = (torch.tensor(ctx)[:, None] + torch.arange(W)[None]).to(dev)
        ps = (PagedDecodeState(torch.arange(B * L // PAGE, dtype=torch.int32,
                                            device=dev).view(B, -1), PAGE)
              if paged else None)
        kern = (pa_kernel.paged_flash_decode if paged
                else fa_kernel.flash_decode)
        before = kern.launches
        logits, _ = model.forward(p, toks.to(dev), pos, cache=cache,
                                  n_valid=n_valid.to(dev), paged=ps)
        if dev.type == "cuda":
            torch.cuda.synchronize()
            assert kern.launches - before == cfg.n_layers
        assert bool(torch.isfinite(logits).all())
        assert cache["pos"].cpu().tolist() == [c + int(n) for c, n in
                                               zip(ctx, n_valid)]
        got[dev.type] = logits.cpu()
    for r, n in enumerate(n_valid.tolist()):
        torch.testing.assert_close(got["cuda"][r, :n], got["cpu"][r, :n],
                                   rtol=1e-4, atol=1e-4)


def _force_drafts(eng, vocab_size):
    """Draft on every greedy decode row: the n-gram proposal, else a
    deterministic filler from the history's last token (greedy
    acceptance keeps the tokens whatever is drafted)."""
    ngram = eng.drafter.propose

    def propose(rid, k=None):
        d = ngram(rid, k)
        if len(d):
            return d
        h = eng.drafter.history(rid)
        if not h:
            return np.zeros((0,), np.int32)
        return ((np.arange(1, 5) * 2654435761 + h[-1]) % (vocab_size - 1)
                + 1).astype(np.int32)

    eng.drafter.propose = propose
    eng.drafter.throttled = lambda *a, **kw: False


@pytest.mark.parametrize("feature", ["spec", "prefix"])
@pytest.mark.parametrize("paged", [True, False])
def test_serving_features_on_card_match_cpu(card, feature, paged):
    """Reduced granite-3-2b (H 64, fp32, TF32 off) with ``spec_decode``
    (drafts forced on every greedy row, spec_k 4) or ``prefix_cache`` (a
    shared 16-token prefix), the paged kernel on and off, under the
    shadow checker, on a mix that preempts: the card's greedy tokens
    equal the CPU's and the feature-off run's; drafts verified or
    prefix tokens hit; no error finding."""
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = reduced_config("granite-3-2b", head_dim=64)
    params = LM(cfg, device="cpu").init_params(
        torch.Generator().manual_seed(0))
    rng = np.random.default_rng(2)
    shared = np.tile(rng.integers(1, cfg.vocab_size, size=4), 4)
    prompts = [np.concatenate([shared, rng.integers(1, cfg.vocab_size,
                                                    size=n)])
               for n in (2, 5, 7, 3)]
    gens = [8, 6, 5, 7]
    on = (dict(spec_decode=True, spec_k=4) if feature == "spec"
          else dict(prefix_cache=True))
    outs = {}
    for dev in (card, torch.device("cpu")):
        model = LM(cfg, device=dev)
        p = _to(params, dev)
        for name, kw in (("on", on), ("off", {})):
            eng = ContinuousBatchingEngine(
                model, p, n_slots=2, max_len=32, page_size=PAGE,
                prefill_chunk=6, page_budget=6, paged_kernel=paged,
                check=True, **kw)
            if kw.get("spec_decode"):
                _force_drafts(eng, cfg.vocab_size)
            rids = [eng.submit(pr, g) for pr, g in zip(prompts, gens)]
            res = eng.run()
            assert not [f.format() for f in eng.check_findings]
            assert sum(r.n_preemptions for r in eng.requests()) >= 1
            outs[dev.type, name] = [res[r].tolist() for r in rids]
            if name == "on":
                s = eng.stats.summary()
                assert (s["drafted_tokens"] if feature == "spec"
                        else s["prefix_hit_tokens"]) > 0
    first = outs["cuda", "on"]
    assert all(o == first for o in outs.values()), outs


# ---------------------------------------------------------------------------
# the paper's measurement layer: the autotuner, B1's tuned split, the
# counters' kernel records
# ---------------------------------------------------------------------------
def _tune(tmp_path, retune=False):
    from repro_torch.core import autotune
    return autotune.tune_paged_attention(
        n_slots=4, max_len=256, page_size=16, n_kv_heads=2, n_q_heads=8,
        head_dim=64, dtype="bfloat16", retune=retune,
        cache_path=tmp_path / "cache.json")


def test_tune_paged_attention_measured_then_cached(card, tmp_path):
    """The sweep times every distinct split count on the card and writes
    a Report the validator accepts; the second call reads the cache, and
    ``retune`` measures again."""
    from repro_torch.core import autotune
    from repro_torch.perf import report
    first = _tune(tmp_path)
    assert first["source"] == "measured"
    assert f"s{first['splits']}" in first["medians_s"] and first["why"]
    assert (first["splits"], first["why"]) == autotune.pick_splits(
        first["samples_s"], first["plan_splits"])
    assert sorted(first["spread_s"]) == sorted(first["medians_s"])
    assert all(len(v) == first["reps"] for v in first["samples_s"].values())
    assert first["kv_valid"] == autotune.paged_kv_lens(4, 256)
    assert first["key"].endswith(autotune.PAGED_IMPL)
    assert all(t > 0 for t in first["medians_s"].values())
    assert not report.validate_path(tmp_path / "cache.json")
    second = _tune(tmp_path)
    assert second["source"] == "cache"
    assert second["splits"] == first["splits"]
    assert _tune(tmp_path, retune=True)["source"] == "measured"


def test_paged_kernel_bitwise_repeatable_at_tuned_split(card, tmp_path):
    """B1 at the tuned split count: two launches give the same bits, and
    the output is the plain version's within the tolerance."""
    splits = _tune(tmp_path)["splits"]
    args, sq = _grouped(_paged_inputs(card, 64, 1, False, torch.bfloat16,
                                      [256, 200, 17, 256], pps=16, NKV=2,
                                      G=4))
    a = pa_kernel.paged_flash_decode(*args, sq=sq, splits=splits)
    b = pa_kernel.paged_flash_decode(*args, sq=sq, splits=splits)
    for x, y in zip(a, b):
        assert torch.equal(x, y)
    want = pa_ref.paged_partials(*args, sq=sq)
    out = a[0] / a[2].clamp_min(1e-30)[..., None]
    ref_out = want[0] / want[2].clamp_min(1e-30)[..., None]
    torch.testing.assert_close(out, ref_out, rtol=2e-3, atol=2e-3)


def test_engine_decodes_at_the_tuned_split(card, tmp_path, monkeypatch):
    """The engine on the card tunes at construction (a fresh cache:
    measured; again: from the cache); its pure-decode forward launches
    B1 at the tuned count, the prefill rows at the plan's."""
    from collections import Counter

    from repro_torch.core import autotune
    monkeypatch.setattr(autotune, "AUTOTUNE_CACHE_PATH",
                        tmp_path / "cache.json")
    cfg = reduced_config("granite-3-2b", head_dim=64)
    model = LM(cfg, device=card)
    params = model.init_params(torch.Generator(device=card).manual_seed(0))
    eng = ContinuousBatchingEngine(model, params, n_slots=2, max_len=64,
                                   page_size=PAGE, prefill_chunk=8)
    assert eng.paged_meta["source"] == "measured"
    again = ContinuousBatchingEngine(model, params, n_slots=2, max_len=64,
                                     page_size=PAGE, prefill_chunk=8)
    assert again.paged_meta["source"] == "cache"
    tuned = eng.paged_meta["splits"]
    calls = Counter()

    class Spy:               # stands in for the kernel module in pa_ops
        @staticmethod
        def paged_flash_decode(*a, **kw):
            calls[kw.get("splits")] += 1
            return pa_kernel.paged_flash_decode(*a, **kw)

    monkeypatch.setattr(pa_ops, "K", Spy)
    for p, g in (([3, 5, 7, 9, 11], 6), ([2, 4, 6], 5)):
        eng.submit(np.asarray(p), g)
    eng.run()
    decode_fwds = sum(1 for s in eng.stats.steps if s.n_decode)
    assert calls[tuned] == cfg.n_layers * decode_fwds > 0
    assert sum(calls.values()) == cfg.n_layers * eng.stats.forwards


@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-4),
                                       (torch.float64, 1e-12)])
def test_gemm_sweep_every_multiplier_matches_plain(card, dtype, tol):
    """Fig 7 (b)'s sweep path: B6 at every block multiplier through
    ``autotune.measured_sweep``, each multiplier's output against the
    plain product."""
    from repro_torch.core import autotune
    rng = np.random.default_rng(5)
    a = torch.from_numpy(rng.random((384, 320))).to(card, dtype)
    b = torch.from_numpy(rng.random((320, 448))).to(card, dtype)
    want = gemm_ref.gemm(a, b)
    outs = {}

    def run(m):
        outs[m] = gemm_ops.gemm(a, b, block_multiplier=m)
        return outs[m]

    meds = autotune.measured_sweep(
        {f"m{m}": (lambda m=m: run(m), ()) for m in (1, 2, 4, 8)}, reps=2)
    assert sorted(meds) == ["m1", "m2", "m4", "m8"]
    for m, got in outs.items():
        torch.testing.assert_close(got, want, rtol=tol, atol=tol * 320)


def test_counters_on_the_card(card):
    """Table 1 on the card in a fresh process: the kernel records count
    the 8 eager kernels exactly and calibrate reliable, beside the CPU's
    verdicts; veceval's scalar row carries the dispatcher's ops, the
    compiled and kernel rows none, with the reason."""
    from repro_torch.core import veceval
    from repro_torch.figures import table1_counters
    rows = table1_counters.collect(table1_counters.spawn(
        "cuda", n=1 << 12, steps=4))
    by = table1_counters.verdicts(rows)
    assert by["flops_matmul"] and by["op_histogram"]
    assert not by["flops_straightline"]
    launch = [r for r in rows if r["channel"] == "kernel_launches"]
    assert len(launch) == 1
    assert launch[0]["reference"] == launch[0]["measured"] == 8
    assert by["kernel_launches"]
    rows = {r["version"]: r for r in veceval.evaluate_app(
        veceval.build_stream(1 << 14, device=card), measure=False)}
    assert rows["scalar"]["ops_source"] == "dispatch"
    assert rows["scalar"]["hlo_ops"] > 0
    for v in ("autovec", "kernel"):
        r = rows[v]
        assert r["hlo_ops"] is None and r["ops_note"]
        assert r["op_reduction_vs_scalar"] is None
