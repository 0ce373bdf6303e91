"""Serving launcher: continuous batching, or the fixed-batch baseline.

  PYTHONPATH=src python -m repro_torch.launch.serve --arch mamba2-780m \\
      --static --slots 8 --prompt-len 2048 --gen-len 32
  PYTHONPATH=src python -m repro_torch.launch.serve --arch mamba2-780m \\
      --reduced --device cpu --slots 2 --requests 4 --prompt-len 16
  PYTHONPATH=src python -m repro_torch.launch.serve --arch granite-3-2b \\
      --int8 --static --slots 8 --prompt-len 512
  PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen3-1.7b \\
      --static --slots 8 --prompt-len 2048
  PYTHONPATH=src python -m repro_torch.launch.serve \\
      --arch phi3.5-moe-42b-a6.6b --int8 --static --slots 8 --prompt-len 512
  PYTHONPATH=src python -m repro_torch.launch.serve \\
      --arch phi3.5-moe-42b-a6.6b --reduced --device cpu --int8
  PYTHONPATH=src python -m repro_torch.launch.serve --arch grok-1-314b \\
      --layers 4 --int8 --static --slots 8 --prompt-len 512
  PYTHONPATH=src python -m repro_torch.launch.serve \\
      --arch jamba-v0.1-52b --int8 --static --slots 8 --prompt-len 512
  PYTHONPATH=src python -m repro_torch.launch.serve \\
      --arch llama-3.2-vision-90b --layers 10 --int8 --static --slots 8 \\
      --prompt-len 512
  PYTHONPATH=src python -m repro_torch.launch.serve --arch whisper-base \\
      --static --slots 8 --prompt-len 128 --gen-len 64
  PYTHONPATH=src python -m repro_torch.launch.serve --arch whisper-base \\
      --reduced --device cpu --slots 2 --requests 4 --prompt-len 16

The counterpart of ``repro.launch.serve`` for every family (dense, moe,
ssm, hybrid, vlm, audio).  By default requests go through the
``ContinuousBatchingEngine``; ``--static`` selects the
``StaticBatchEngine`` baseline (one prefill forward over the batch, then
a decode loop; an attention layer's prefill is causal attention over the
prompts and its decode the dense-cache flash-decode kernel, a mamba
layer's prefill the SSD kernel).  Weights are random, drawn
from a seeded generator; prompts come from a seeded numpy generator as in
the reference, and so does a cross-attention family's stub context
(``decode_state.stub_context``: vlm image embeddings, audio frames),
drawn in the reference's order (batched before the static prompts, one
after each continuous request's prompt), so a seed gives the JAX
launcher's contexts and continuous prompts.  ``--int8`` draws the weights layer by layer and quantizes
each before the next is drawn (``LM.init_params(int8=True)``, weight-only
int8: the bits of ``models.quant.quantize_params`` of the whole tree, but
the tree is never held in bf16, so phi3.5-moe-42b and jamba-v0.1-52b fit
one card): every matmul of the served tree then runs the int8 GEMM
kernel.  ``--layers`` cuts the depth (a model too deep for the card, as
grok-1-314b and llama-3.2-vision-90b; a multiple of the period: 8 for
jamba-v0.1-52b, 5 for llama-3.2-vision-90b).  Runs on
``cuda`` unless ``--device`` names another device.  Times are device times from CUDA
events; on the CPU none are reported.

The continuous engine's serving features: ``--prefix-cache`` (with
``--prefix-pool`` entries; the families whose state is a token prefix,
the ssm and hybrid serve with the pool off) and ``--speculative`` (the
n-gram drafter, up to ``--spec-k`` tokens a greedy row a step); each
prints its counts (prefix hits; drafted and accepted tokens).  The
static engine has neither and refuses them.

  PYTHONPATH=src python -m repro_torch.launch.serve --arch granite-3-2b \\
      --reduced --device cpu --prefix-cache --speculative --spec-k 4

Not ported yet, each raising ``NotImplementedError`` with its ROADMAP
item: ``--mesh``, ``--sp-kv``, ``--open-loop`` and ``--chunk-policy
stall_free``.
"""
from __future__ import annotations

import argparse
from typing import Any, Dict, Optional

import numpy as np
import torch

from repro_torch.configs import ARCH_IDS, get_config, reduced_config
from repro_torch.models.decode_state import stub_context
from repro_torch.models.model import LM
from repro_torch.models.quant import param_bytes
from repro_torch.serve.engine import ContinuousBatchingEngine, StaticBatchEngine

# option -> (the value that means "off", the ROADMAP item that ports it)
NOT_PORTED = {
    "mesh": (None, "A10: the device mesh"),
    "sp_kv": (False, "A10: the sequence-parallel KV cache"),
    "open_loop": (False, "A7: the open-loop front end"),
    "chunk_policy": ("fixed", "A7: the stall_free chunk policy"),
}


def _p50(ms):
    ms = sorted(ms)
    return ms[len(ms) // 2] if ms else None


def run(arch: str = "granite-3-2b", *, reduced: bool = False,
        slots: int = 4, requests: int = 0, prompt_len: int = 32,
        gen_len: int = 32, prefill_chunk: int = 8, page_size: int = 16,
        temperature: float = 0.0, static: bool = False, int8: bool = False,
        layers: Optional[int] = None, device=None,
        prefix_cache: bool = False, prefix_pool: int = 8,
        speculative: bool = False, spec_k: int = 4,
        **options) -> Dict[str, Any]:
    """Serve ``requests`` (default 2 x ``slots``; ``slots`` with
    ``static``) random prompts and return what the launcher prints: the
    prompts and generated tokens, counts, the bytes of the tree in the
    param dtype (``init_param_bytes``, reckoned from the shapes: with
    ``int8`` it is never allocated) and of the served tree
    (``param_bytes``), the device's peak after init (``init_peak_gib``),
    and on the card the
    CUDA-event times (``run_ms``, ``tokens_per_s``, ``prefill_ms`` for
    ``static``, ``step_ms_p50``) and ``peak_gib``, the peak device memory
    of serving (after the quantization).  ``prefix_cache`` /
    ``prefix_pool`` and ``speculative`` / ``spec_k`` are the continuous
    engine's; the result then also holds its ``prefix_cache`` (False
    for a family that cannot share a prefix), ``prefix_hit_tokens``,
    ``prefix_hit_rate``, ``drafted_tokens``, ``accepted_draft_tokens``
    and ``accept_rate``."""
    for name, value in options.items():
        if name not in NOT_PORTED:
            raise TypeError(f"unexpected keyword argument {name!r}")
        off, item = NOT_PORTED[name]
        if value != off:
            raise NotImplementedError(
                f"{name}={value!r} is not ported yet (ROADMAP {item})")
    if static and (prefix_cache or speculative):
        raise ValueError("the static engine has no prefix cache and no "
                         "speculative decoding: drop --static")
    depth = {} if layers is None else {"n_layers": layers}
    cfg = (reduced_config(arch, **depth) if reduced
           else get_config(arch, **depth))
    model = LM(cfg, device=device)
    dev = model.device
    on_card = dev.type == "cuda"
    if on_card:
        torch.cuda.reset_peak_memory_stats(dev)
    params = model.init_params(torch.Generator(device=dev).manual_seed(0),
                               int8=int8)
    init_peak = (torch.cuda.max_memory_allocated(dev) / 2 ** 30
                 if on_card else None)
    rng = np.random.default_rng(1)
    if on_card:
        torch.cuda.synchronize(dev)
        torch.cuda.reset_peak_memory_stats(dev)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)

    max_len = prompt_len + gen_len + 8
    if static:
        engine = StaticBatchEngine(model, params, max_len=max_len,
                                   batch=slots,
                                   sample_temperature=temperature)
        extra = stub_context(cfg, rng, batch=slots)
        prompts = rng.integers(1, cfg.vocab_size, size=(slots, prompt_len))
        if on_card:
            start.record()
        out = engine.generate(prompts, n_steps=gen_len, extra=extra)
        tokens = {i: row for i, row in enumerate(out.cpu().numpy())}
        prompts = list(prompts)
        n_req = slots
    else:
        max_len = -(-max_len // page_size) * page_size    # whole pages
        engine = ContinuousBatchingEngine(
            model, params, n_slots=slots, max_len=max_len,
            page_size=page_size, prefill_chunk=prefill_chunk,
            prefix_cache=prefix_cache, prefix_pool=prefix_pool,
            spec_decode=speculative, spec_k=spec_k)
        n_req = requests or 2 * slots
        prompts = []
        for _ in range(n_req):
            prompts.append(rng.integers(1, cfg.vocab_size, size=int(
                rng.integers(max(1, prompt_len // 2), prompt_len + 1))))
            engine.submit(prompts[-1], gen_len, temperature=temperature,
                          extra=stub_context(cfg, rng))
        if on_card:
            start.record()
        tokens = engine.run()
    if on_card:
        end.record()        # serving only: not the byte reckoning below
    st = engine.stats.summary()
    res: Dict[str, Any] = dict(
        arch=arch, family=cfg.family, engine="static" if static else
        "continuous", int8=int8, device=str(dev), requests=n_req,
        prompts=prompts, tokens=tokens,
        init_param_bytes=model.init_param_bytes(),
        param_bytes=param_bytes(params), init_peak_gib=init_peak,
        generated_tokens=st["generated_tokens"], steps=st["steps"],
        forwards=st["forwards"], run_ms=None, tokens_per_s=None,
        prefill_ms=None, step_ms_p50=None, peak_gib=None)
    if not static:
        res["prefix_cache"] = engine.prefix_cache
        res["speculative"] = engine.spec_decode
        res.update({k: st[k] for k in (
            "prefix_hit_tokens", "prefix_hit_rate", "drafted_tokens",
            "accepted_draft_tokens", "accept_rate")})
    if on_card:
        end.synchronize()
        res["run_ms"] = start.elapsed_time(end)
        res["tokens_per_s"] = st["generated_tokens"] / (res["run_ms"] / 1e3)
        res["peak_gib"] = torch.cuda.max_memory_allocated(dev) / 2 ** 30
        ms = [s.device_ms() for s in engine.stats.steps]
        if static:
            res["prefill_ms"] = ms[0]
            res["step_ms_p50"] = _p50(ms[1:])
        else:
            res["step_ms_p50"] = st["step_ms_p50"]
    return res


def report(res: Dict[str, Any]) -> str:
    """The launcher's summary line."""
    first = next(iter(res["tokens"].values()))
    line = (f"[serve] {res['arch']} ({res['family']}) {res['engine']}"
            f"{' int8' if res['int8'] else ''} on {res['device']}: "
            f"{res['requests']} request(s), {res['generated_tokens']} tokens "
            f"in {res['steps']} steps | params "
            f"{res['init_param_bytes'] / 1e9:.3f} GB")
    if res["int8"]:
        line += f" -> int8 {res['param_bytes'] / 1e9:.3f} GB"
    if res["run_ms"] is not None:
        line += (f" | {res['tokens_per_s']:.1f} tok/s over "
                 f"{res['run_ms']:.1f} ms, step p50 "
                 f"{res['step_ms_p50']:.3f} ms")
        if res["prefill_ms"] is not None:
            line += f", prefill {res['prefill_ms']:.3f} ms"
        line += f", peak {res['peak_gib']:.2f} GiB"
    if res.get("prefix_cache"):
        line += (f" | prefix cache: {res['prefix_hit_tokens']} prompt "
                 f"tokens served (hit rate {res['prefix_hit_rate']:.2f})")
    if res.get("speculative"):
        line += (f" | speculative: accept_rate {res['accept_rate']:.2f} "
                 f"({res['accepted_draft_tokens']}/"
                 f"{res['drafted_tokens']} drafted tokens)")
    return line + f" | sample: {list(map(int, first[:12]))}"


def main(argv: Optional[list] = None) -> Dict[str, Any]:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", default="granite-3-2b", choices=ARCH_IDS)
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--slots", "--batch", dest="slots", type=int, default=4)
    ap.add_argument("--requests", type=int, default=0,
                    help="queued requests (default: 2x slots)")
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--gen-len", type=int, default=32)
    ap.add_argument("--prefill-chunk", type=int, default=8)
    ap.add_argument("--page-size", type=int, default=16)
    ap.add_argument("--temperature", type=float, default=0.0)
    ap.add_argument("--static", action="store_true",
                    help="fixed-batch StaticBatchEngine baseline")
    ap.add_argument("--device", default="cuda",
                    help="torch device (default cuda; cpu runs the plain "
                         "versions of the kernels)")
    ap.add_argument("--int8", action="store_true",
                    help="weight-only int8 (the int8 GEMM kernel), drawn "
                         "and quantized layer by layer")
    ap.add_argument("--layers", type=int, default=None,
                    help="cut the depth to this many layers")
    ap.add_argument("--prefix-cache", action="store_true",
                    help="page-table-keyed prefix caching: shared "
                         "page-aligned prompt prefixes are copied from "
                         "pooled donor rows instead of prefilled "
                         "(token-addressable families only)")
    ap.add_argument("--prefix-pool", type=int, default=8,
                    help="max pooled prefix entries (LRU bound)")
    ap.add_argument("--mesh", default=None, help="not ported (A10)")
    ap.add_argument("--sp-kv", action="store_true", help="not ported (A10)")
    ap.add_argument("--open-loop", action="store_true",
                    help="not ported (A7)")
    ap.add_argument("--speculative", action="store_true",
                    help="n-gram draft-verify speculative decoding: "
                         "verify up to --spec-k drafted tokens a greedy "
                         "row a step (identical tokens, fewer steps)")
    ap.add_argument("--spec-k", type=int, default=4,
                    help="max draft tokens verified a row a step")
    ap.add_argument("--chunk-policy", default="fixed",
                    choices=("fixed", "stall_free"),
                    help="stall_free is not ported (A7)")
    args = ap.parse_args(argv)
    res = run(args.arch, reduced=args.reduced, slots=args.slots,
              requests=args.requests, prompt_len=args.prompt_len,
              gen_len=args.gen_len, prefill_chunk=args.prefill_chunk,
              page_size=args.page_size, temperature=args.temperature,
              static=args.static, device=args.device, int8=args.int8,
              layers=args.layers,
              prefix_cache=args.prefix_cache, prefix_pool=args.prefix_pool,
              speculative=args.speculative, spec_k=args.spec_k,
              mesh=args.mesh, sp_kv=args.sp_kv, open_loop=args.open_loop,
              chunk_policy=args.chunk_policy)
    print(report(res), flush=True)
    return res


if __name__ == "__main__":
    main()
