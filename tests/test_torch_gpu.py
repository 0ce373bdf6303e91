"""Tests of the port that need a Hopper card (marker ``gpu``): the CUDA
paged-attention kernel against its plain version, and the port's engine
on the card against the same engine on the CPU.  Without a card they
skip; on the card run them with

    PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_gpu.py

This module imports no jax, so it runs where only PyTorch is installed.
"""
import numpy as np
import pytest
import torch

from repro_torch.configs import reduced_config
from repro_torch.kernels.common import require_hopper
from repro_torch.kernels.paged_attention import kernel as pa_kernel
from repro_torch.kernels.paged_attention import ops as pa_ops
from repro_torch.models.model import LM
from repro_torch.serve.engine import ContinuousBatchingEngine

pytestmark = pytest.mark.gpu

PAGE = 8


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card of capability (9, 0)")
    dev = torch.device("cuda")
    require_hopper(dev)
    return dev


@pytest.mark.parametrize("H,sq,permuted,dtype", [
    (64, 1, True, torch.bfloat16), (128, 4, False, torch.bfloat16),
    (64, 4, True, torch.float32), (128, 1, True, torch.float32)])
def test_kernel_matches_plain(card, H, sq, permuted, dtype):
    """Partials and normalized output of the kernel against the plain
    version on the same card inputs: empty, single-token, page-boundary
    and partial-last-page rows.  Both compute in fp32 from the same
    inputs, so they differ only in summation order (2e-3)."""
    rng = np.random.default_rng(H + sq)
    B, NKV, G, pps = 4, 2, 4, 4
    q = torch.from_numpy(rng.standard_normal((B, sq, NKV * G, H))).float()
    kp = torch.from_numpy(rng.standard_normal((B * pps, PAGE, NKV, H)))
    vp = torch.from_numpy(rng.standard_normal((B * pps, PAGE, NKV, H)))
    idx = (rng.permutation(B * pps) if permuted else np.arange(B * pps))
    valid = np.array([0, 8, 17, 32], np.int32)
    pos = np.maximum(valid[:, None] - sq + np.arange(sq)[None], 0)
    args = [q.to(card), kp.to(card, dtype), vp.to(card, dtype),
            torch.from_numpy(idx.reshape(B, pps).astype(np.int32)).to(card),
            torch.from_numpy(pos.astype(np.int32)).to(card),
            torch.from_numpy(valid).to(card)]
    before = pa_kernel.paged_flash_decode.launches
    got = pa_ops.paged_attention(*args, page_size=PAGE, return_partials=True)
    assert pa_kernel.paged_flash_decode.launches == before + 1
    want = pa_ops.paged_attention(*[a.cpu() for a in args], page_size=PAGE,
                                  return_partials=True)
    torch.cuda.synchronize()
    for g, w in zip(got[1:], want[1:]):
        torch.testing.assert_close(g.cpu(), w, rtol=2e-3, atol=2e-3)
    out = pa_ops.combine_partials([got]).cpu()
    assert torch.isfinite(out).all() and (out[0] == 0).all()
    torch.testing.assert_close(out, pa_ops.combine_partials([want]),
                               rtol=2e-3, atol=2e-3)


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


def _to(tree, dev):
    if isinstance(tree, dict):
        return {k: _to(v, dev) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_to(v, dev) for v in tree]
    return tree.to(dev)
