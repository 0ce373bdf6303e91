"""Drive the PyTorch port on one NVIDIA Hopper card and check it end to end.

    python3 chip_smoke.py              # every phase; needs one sm_90 card
    python3 chip_smoke.py --profile    # also profile pure decode steps

Phases (one line each; any failure exits nonzero and prints no result):

1. device  — the card's name and power limit (nvidia-smi), capability
             (9, 0) required; there is no fallback to the CPU.
2. build   — nvcc builds the paged-attention kernel from the checkout.
3. kernel  — the CUDA kernel against its plain PyTorch version on the
             card, at granite-3-2b (H 64) and qwen3-1.7b (H 128) shapes:
             decode (Sq 1) and a prefill chunk (Sq 32), ragged kv_valid
             (0, 1, page boundaries, partial last pages, full), identity
             and permuted page maps.  Prints the kernel's time, the plain
             version's, the time of F.scaled_dot_product_attention on the
             gathered dense cache (a yardstick the port never calls) and
             the bound (bytes over the memory rate, or operations over
             the bf16 peak, whichever is larger).
4. parity  — the port on the card against the port on the CPU, reduced
             granite-3-2b in fp32 (TF32 off): greedy tokens identical.
5. serve   — the main path: full-width granite-3-2b in bf16 with random
             weights from a seeded generator, 16 requests through the
             ContinuousBatchingEngine (8 slots, mid-run admission).  The
             kernel's launch count must equal 40 x the forward passes.

The line before the last is the per-kernel JSON record; the last line is
``{"ok": true, "device": {...}}``.
"""
from __future__ import annotations

import argparse
import datetime
import json
import os
import subprocess
import sys

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(ROOT, "src"))

import torch  # noqa: E402
import torch.nn.functional as F  # noqa: E402

from repro_torch.configs import get_config, reduced_config  # noqa: E402
from repro_torch.kernels.common import REQUIRED_CAPABILITY  # noqa: E402
from repro_torch.kernels.paged_attention import kernel as pa_kernel  # noqa: E402
from repro_torch.kernels.paged_attention import ref as pa_ref  # noqa: E402
from repro_torch.models.model import LM  # noqa: E402
from repro_torch.serve.engine import ContinuousBatchingEngine  # noqa: E402

KERNEL_SOURCE = "src/repro_torch/kernels/paged_attention/csrc/paged_attention.cu"
REPLACES = "src/repro/kernels/paged_attention/kernel.py:40"
TOL = 2e-3          # atol = rtol: bf16 inputs, fp32 math in both versions

# (memory bytes/s, dense bf16 FLOP/s) per H100 variant, NVIDIA data sheets
RATES = {"PCIe": (2.0e12, 756e12), "NVL": (3.9e12, 835e12),
         "SXM": (3.35e12, 989e12)}


def log(phase, msg):
    print(f"[{phase}] {msg}", flush=True)


def rates_for(name):
    for key in ("PCIe", "NVL"):
        if key in name:
            return key, RATES[key]
    return "SXM", RATES["SXM"]


def time_ms(fn, reps, flush, cover_ms):
    """Median device ms of ``fn`` over ``reps`` launches, each between two
    CUDA events, with the L2 cache flushed before it (the main path finds
    a layer's K/V cold).  A spin kernel of ``cover_ms`` runs before the
    start event, so the host has enqueued all of ``fn`` by the time the
    card reaches it: the events see device time, not host overhead."""
    fn()
    torch.cuda.synchronize()
    out = []
    for _ in range(reps):
        flush.zero_()
        torch.cuda._sleep(int(cover_ms * 2e6))      # ~2e6 cycles per ms
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        out.append(start.elapsed_time(end))
    return float(np.median(out))


# ---------------------------------------------------------------------------
# phase 1 + 2
# ---------------------------------------------------------------------------
def phase_device():
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True)
    card = smi.stdout.strip().splitlines()[0]
    cap = torch.cuda.get_device_capability(0)
    log("device", f"{card} | capability {cap} | torch {torch.__version__} "
                  f"cuda {torch.version.cuda} | count "
                  f"{torch.cuda.device_count()}")
    if cap != REQUIRED_CAPABILITY:
        raise SystemExit(f"capability {cap} != {REQUIRED_CAPABILITY}")
    return card


def phase_build():
    t0 = datetime.datetime.now()
    pa_kernel.load_library()
    secs = (datetime.datetime.now() - t0).total_seconds()
    log("build", f"paged_attention built and loaded in {secs:.1f} s")


# ---------------------------------------------------------------------------
# phase 3: kernel vs plain
# ---------------------------------------------------------------------------
def make_case(*, B, NKV, G, H, page, max_len, sq, valid, permuted, seed,
              dev, dtype=torch.bfloat16):
    g = torch.Generator(device=dev).manual_seed(seed)
    pps = max_len // page
    P = B * pps
    q = torch.randn((B, sq, NKV * G, H), generator=g, device=dev)
    kp = torch.randn((P, page, NKV, H), generator=g, device=dev).to(dtype)
    vp = torch.randn((P, page, NKV, H), generator=g, device=dev).to(dtype)
    ids = (torch.randperm(P, generator=g, device=dev) if permuted
           else torch.arange(P, device=dev))
    page_idx = ids.to(torch.int32).view(B, pps).contiguous()
    kv_valid = torch.tensor(valid, dtype=torch.int32, device=dev)
    pos0 = (kv_valid - sq).clamp_min(0).to(torch.int32)
    qg = q.view(B, sq, NKV, G, H).permute(0, 2, 3, 1, 4)
    qg = qg.reshape(B, NKV, G * sq, H).contiguous()
    return dict(q=q, qg=qg, kp=kp, vp=vp, page_idx=page_idx, pos0=pos0,
                kv_valid=kv_valid, sq=sq)


def bound_ms(c, rates):
    """Least time for the function on these inputs: K/V of the valid
    tokens, the queries, the pages ids touched and the outputs moved once,
    against the operations of QK^T and PV at the bf16 peak."""
    B, NKV, R, H = c["qg"].shape
    valid = c["kv_valid"].double()
    elem = c["kp"].element_size()
    pages = torch.ceil(valid / c["kp"].shape[1])
    nbytes = float(2 * valid.sum() * NKV * H * elem
                   + c["qg"].numel() * 4 + pages.sum() * 4 + 2 * B * 4
                   + B * NKV * R * (H + 2) * 4)
    flops = float(4 * valid.sum() * NKV * R * H)
    mem_rate, flop_rate = rates
    t_bytes, t_ops = nbytes / mem_rate * 1e3, flops / flop_rate * 1e3
    return max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations"


def library_fn(c):
    """F.scaled_dot_product_attention over the gathered dense cache."""
    B, NKV, R, H = c["qg"].shape
    sq = c["sq"]
    k = c["kp"][c["page_idx"].long()].reshape(B, -1, NKV, H).transpose(1, 2)
    v = c["vp"][c["page_idx"].long()].reshape(B, -1, NKV, H).transpose(1, 2)
    k, v = k.contiguous(), v.contiguous()
    L = k.shape[2]
    q = c["q"].to(c["kp"].dtype).transpose(1, 2).contiguous()
    t = torch.arange(L, device=q.device)
    qpos = c["pos0"][:, None] + torch.arange(sq, device=q.device)[None]
    mask = ((t[None, None] <= qpos[..., None])
            & (t[None, None] < c["kv_valid"][:, None, None]))[:, None]
    return lambda: F.scaled_dot_product_attention(q, k, v, attn_mask=mask,
                                                  enable_gqa=True)


def phase_kernel(card, rates, flush):
    dev = torch.device("cuda")
    base = [0, 1, 16, 37, 256, 511, 777, 1024]       # ragged, 8 slots
    shapes = [("granite", 8, 4, 64), ("qwen3", 8, 2, 128)]
    cases = []
    for arch, NKV, G, H in shapes:
        for sq in (1, 32):
            for permuted in (False, True):
                cases.append((f"{arch} H{H} Sq{sq} "
                              f"{'permuted' if permuted else 'identity'}",
                              dict(B=8, NKV=NKV, G=G, H=H, page=16,
                                   max_len=1024, sq=sq, valid=base,
                                   permuted=permuted)))
    # the main path's decode shape (phase 5: 8 slots, max_len 512)
    main_valid = [64, 97, 150, 203, 256, 288, 300, 41]
    cases.append(("main-path decode: granite H64 Sq1 identity max_len512",
                  dict(B=8, NKV=8, G=4, H=64, page=16, max_len=512, sq=1,
                       valid=main_valid, permuted=False)))
    worst, main = 0.0, None
    for i, (name, kw) in enumerate(cases):
        c = make_case(**kw, seed=i, dev=dev)
        args = (c["qg"], c["kp"], c["vp"], c["page_idx"], c["pos0"],
                c["kv_valid"])
        got = pa_kernel.paged_flash_decode(*args, sq=c["sq"])
        want = pa_ref.paged_partials(*args, sq=c["sq"])
        torch.cuda.synchronize()
        for g_, w_, what in zip(got, want, ("acc", "m", "l")):
            if not torch.isfinite(g_).all():
                raise SystemExit(f"{name}: non-finite {what}")
            live = want[2] > 0
            if what == "m":
                g_, w_ = g_[live], w_[live]
            torch.testing.assert_close(g_, w_, atol=TOL, rtol=TOL,
                                       msg=lambda m: f"{name} {what}: {m}")
        out_k = got[0] / got[2].clamp_min(1e-30)[..., None]
        out_p = want[0] / want[2].clamp_min(1e-30)[..., None]
        torch.testing.assert_close(out_k, out_p, atol=TOL, rtol=TOL)
        err = float((out_k - out_p).abs().max())
        worst = max(worst, err)
        k_ms = time_ms(lambda: pa_kernel.paged_flash_decode(
            *args, sq=c["sq"]), 30, flush, 2)
        p_ms = time_ms(lambda: pa_ref.paged_partials(*args, sq=c["sq"]),
                       10, flush, 20)
        l_ms = time_ms(library_fn(c), 30, flush, 2)
        b_ms, b_by = bound_ms(c, rates)
        log("kernel", f"{name}: ok max_abs_err {err:.2e} | kernel_ms "
                      f"{k_ms:.4f} plain_ms {p_ms:.4f} library_ms "
                      f"{l_ms:.4f} bound_ms {b_ms:.4f} ({b_by}) | {card}")
        if name.startswith("main-path"):
            main = dict(ms=k_ms, plain_ms=p_ms, library_ms=l_ms,
                        bound_ms=b_ms, bound_by=b_by)
    return worst, main


# ---------------------------------------------------------------------------
# phase 4: port on card vs port on CPU
# ---------------------------------------------------------------------------
def serve_tokens(cfg, params_cpu, device, prompts, gens):
    model = LM(cfg, device=device)
    params = _to(params_cpu, model.device)
    eng = ContinuousBatchingEngine(model, params, n_slots=2, max_len=64,
                                   page_size=16, prefill_chunk=8)
    rids = [eng.submit(p, g) for p, g in zip(prompts, gens)]
    out = eng.run()
    return [out[r].tolist() for r in rids]


def _to(tree, dev):
    if isinstance(tree, dict):
        return {k: _to(v, dev) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_to(v, dev) for v in tree]
    return tree.to(dev)


def phase_parity():
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    # the kernel takes head_dim 64 or 128: the reduced config at H 64
    cfg = reduced_config("granite-3-2b", head_dim=64)
    gen = torch.Generator(device="cpu").manual_seed(0)
    params = LM(cfg, device="cpu").init_params(gen)
    rng = np.random.default_rng(0)
    prompts = [rng.integers(1, cfg.vocab_size, size=n)
               for n in (19, 7, 26, 12)]
    gens = [9, 14, 6, 11]
    before = pa_kernel.paged_flash_decode.launches
    card = serve_tokens(cfg, params, "cuda", prompts, gens)
    launched = pa_kernel.paged_flash_decode.launches - before
    cpu = serve_tokens(cfg, params, "cpu", prompts, gens)
    if card != cpu or launched == 0:
        raise SystemExit(f"card/CPU greedy tokens differ (kernel launches "
                         f"{launched}):\n card {card}\n cpu  {cpu}")
    log("parity", f"reduced granite-3-2b fp32 (H 64, 4 layers): "
                  f"{sum(map(len, card))} greedy tokens identical card vs "
                  f"CPU over {len(prompts)} requests; kernel launches "
                  f"{launched}")


# ---------------------------------------------------------------------------
# phase 5: serve at full width
# ---------------------------------------------------------------------------
def phase_serve(card, profile):
    cfg = get_config("granite-3-2b")
    model = LM(cfg)                                   # cuda, bf16
    gen = torch.Generator(device=model.device).manual_seed(0)
    params = model.init_params(gen)
    eng = ContinuousBatchingEngine(model, params, n_slots=8, max_len=512,
                                   page_size=16, prefill_chunk=32)
    rng = np.random.default_rng(0)
    n_req, n_new = 16, 32
    prompts = [rng.integers(1, cfg.vocab_size, size=int(n))
               for n in rng.integers(32, 257, size=n_req)]
    rids = [eng.submit(p, n_new) for p in prompts]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    pa_kernel.paged_flash_decode.launches = 0
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    out = eng.run()
    end.record()
    end.synchronize()
    launches = pa_kernel.paged_flash_decode.launches
    run_ms = start.elapsed_time(end)
    st = eng.stats.summary()
    reqs = eng.requests()
    if sorted(r.rid for r in reqs) != sorted(rids):
        raise SystemExit("not every request finished")
    for rid in rids:
        toks = out[rid]
        if len(toks) != n_new or toks.min() < 0 or \
                toks.max() >= cfg.padded_vocab:
            raise SystemExit(f"request {rid}: bad tokens {toks.tolist()}")
    if launches != cfg.n_layers * st["forwards"] or launches == 0:
        raise SystemExit(f"kernel launches {launches} != {cfg.n_layers} x "
                         f"{st['forwards']} forward passes")
    admitted_late = sum(r.admit_step > 0 for r in reqs)
    decode_ms = sorted(s.device_ms() for s in eng.stats.steps
                       if s.n_decode and not s.n_prefill_tokens)
    p50 = decode_ms[len(decode_ms) // 2] if decode_ms else float("nan")
    peak_gib = torch.cuda.max_memory_allocated() / 2 ** 30
    # finite logits of the expected shape on the card, through the kernel
    cache = model.init_cache(1, 512)
    p0 = torch.as_tensor(prompts[0], device=model.device)[None]
    logits, _ = model.forward(params, p0,
                              torch.arange(p0.shape[1],
                                           device=model.device)[None],
                              cache=cache)
    if logits.shape != (1, p0.shape[1], cfg.padded_vocab) or \
            not torch.isfinite(logits).all():
        raise SystemExit(f"bad logits {tuple(logits.shape)}")
    gen_tok = st["generated_tokens"]
    log("serve", f"granite-3-2b bf16 full width: {n_req} requests "
                 f"({admitted_late} admitted mid-run), {gen_tok} tokens in "
                 f"{st['steps']} steps / {st['forwards']} forward passes | "
                 f"{gen_tok / (run_ms / 1e3):.1f} tok/s over {run_ms:.1f} "
                 f"ms | step p50 {st['step_ms_p50']:.3f} ms, pure-decode "
                 f"step p50 {p50:.3f} ms ({len(decode_ms)} steps) | kernel "
                 f"launches {launches} = {cfg.n_layers} x "
                 f"{st['forwards']} | peak {peak_gib:.2f} GiB | {card}")
    if profile:
        profile_decode(model, params, eng, card)
    return launches


def profile_decode(model, params, eng, card):
    """Device-busy share of pure batched decode forwards (8 rows, 288
    tokens of context) under torch.profiler."""
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.models.attention import PagedDecodeState
    cache = model.init_cache(8, 512)
    cache["pos"].fill_(288)
    toks = torch.ones((8, 1), dtype=torch.long, device=model.device)
    pos = torch.full((8, 1), 288, dtype=torch.long, device=model.device)
    paged = PagedDecodeState(eng._page_idx, 16)

    def step():
        cache["pos"].fill_(288)
        model.forward(params, toks, pos, cache=cache, paged=paged)

    for _ in range(3):
        step()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        start.record()
        for _ in range(5):
            step()
        end.record()
        end.synchronize()
    wall = start.elapsed_time(end) / 5
    def dev_us(e):
        for attr in ("self_device_time_total", "self_cuda_time_total"):
            if hasattr(e, attr):
                return getattr(e, attr)
        raise AttributeError("profiler event has no device time field")

    rows = [(e.key, dev_us(e) / 1e3 / 5, e.count // 5)
            for e in prof.key_averages()]
    busy = sum(r[1] for r in rows)
    log("profile", f"decode forward (8 x 1, ctx 288): {wall:.3f} ms "
                   f"between events, device busy {busy:.3f} ms "
                   f"({100 * busy / wall:.1f}%) | {card}")
    for key, ms, n in sorted(rows, key=lambda r: -r[1])[:8]:
        log("profile", f"  {ms:.4f} ms/forward  x{n}  {key[:70]}")


# ---------------------------------------------------------------------------
def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--profile", action="store_true",
                    help="also profile pure decode forwards")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs on the card",
              file=sys.stderr)
        return 1
    card = phase_device()
    phase_build()
    variant, rates = rates_for(card)
    flush = torch.empty(256 * 2 ** 20, dtype=torch.uint8, device="cuda")
    log("kernel", f"bound rates: H100 {variant} {rates[0] / 1e12:.2f} TB/s, "
                  f"{rates[1] / 1e12:.0f} TFLOP/s bf16 dense")
    worst, main_case = phase_kernel(card, rates, flush)
    del flush
    phase_parity()
    launches = phase_serve(card, args.profile)
    record = {"kernels": [dict(
        name="paged_partials", route="cuda", source=KERNEL_SOURCE,
        replaces=REPLACES, launches=launches, max_abs_err=worst,
        **main_case)]}
    print(json.dumps(record))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
