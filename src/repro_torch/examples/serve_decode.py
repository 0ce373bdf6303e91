"""Continuous-batching serving example: more requests than slots, mixed
prompt and generation lengths, for any model family.  The counterpart of
``examples/serve_decode.py``.  Queued requests are admitted into slots
the moment earlier requests finish: the admission log shows a request
entering a recycled slot mid-run.  The cross-context families (vlm,
audio) bring their image or audio context with each request.

    python -m repro_torch.examples.serve_decode --arch granite-3-2b
    python -m repro_torch.examples.serve_decode --arch mamba2-780m --device cpu

Open loop (requests arrive on a clock; each request's TTFT and worst TBT
and the latency summary; the CPU has only the cost model's clock):

    python -m repro_torch.examples.serve_decode --open-loop --rate 20
    python -m repro_torch.examples.serve_decode --device cpu --open-loop \\
        --clock model --rate 2000

Speculative decoding (n-gram draft and verify; greedy output is the plain
engine's, only the step count and tok/s change):

    python -m repro_torch.examples.serve_decode --arch whisper-base \\
        --speculative --spec-k 6

Times are CUDA-event times of the engine's steps on the card; on the CPU
nothing is timed.  ``--mesh`` and ``--sp-kv`` (sharded serving) raise
``NotImplementedError``: the device mesh is ROADMAP A10.
"""
import argparse

import numpy as np
import torch

from repro_torch.configs import ARCH_IDS
from repro_torch.examples.quickstart import example_config
from repro_torch.kernels.common import resolve_device
from repro_torch.models.decode_state import stub_context
from repro_torch.models.model import LM
from repro_torch.serve import (SLO, ContinuousBatchingEngine,
                               OpenLoopFrontend, poisson_arrivals)


def _ms(s):
    return "   --  " if s is None else f"{s * 1e3:7.1f}ms"


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", default="granite-3-2b", choices=ARCH_IDS)
    ap.add_argument("--device", default=None)
    ap.add_argument("--slots", type=int, default=3)
    ap.add_argument("--requests", type=int, default=6)
    ap.add_argument("--max-len", type=int, default=96)
    ap.add_argument("--prefill-chunk", type=int, default=8)
    ap.add_argument("--page-size", type=int, default=8)
    ap.add_argument("--temperature", type=float, default=0.0)
    ap.add_argument("--prefix-cache", action="store_true",
                    help="reuse shared page-aligned prompt prefixes from "
                         "released requests' pooled pages")
    ap.add_argument("--mesh", default=None,
                    help="shard the decode slots over a device mesh "
                         "(not ported: ROADMAP A10)")
    ap.add_argument("--sp-kv", action="store_true",
                    help="shard the KV cache's sequence axis (not "
                         "ported: ROADMAP A10)")
    ap.add_argument("--open-loop", action="store_true",
                    help="requests arrive as a Poisson process through "
                         "the open-loop front end")
    ap.add_argument("--rate", type=float, default=20.0,
                    help="open-loop arrival rate (requests/s)")
    ap.add_argument("--clock", choices=("wall", "model"), default=None,
                    help="the front end's clock: CUDA events on the card "
                         "(wall, the default there) or the cost model's "
                         "step times (model, the only one on the CPU)")
    ap.add_argument("--speculative", action="store_true",
                    help="n-gram draft-verify speculative decoding")
    ap.add_argument("--spec-k", type=int, default=4,
                    help="max draft tokens per verify step")
    args = ap.parse_args(argv)
    if args.mesh is not None or args.sp_kv:
        raise NotImplementedError(
            "sharded serving (--mesh, --sp-kv) is not ported yet (ROADMAP "
            "A10: the device mesh)")
    dev = resolve_device(args.device)

    cfg = example_config(args.arch, dev)
    model = LM(cfg, device=dev)
    params = model.init_params(torch.Generator(device=dev).manual_seed(0))
    engine = ContinuousBatchingEngine(
        model, params, n_slots=args.slots, max_len=args.max_len,
        page_size=args.page_size, prefill_chunk=args.prefill_chunk,
        prefix_cache=args.prefix_cache, spec_decode=args.speculative,
        spec_k=args.spec_k)
    print(f"family={cfg.family} on {dev}: continuous batching via "
          f"DecodeState"
          + (" + prefix cache" if engine.prefix_cache else "")
          + (f" + speculative k={args.spec_k}" if args.speculative else "")
          + f" | paged kernel: {engine.paged_meta}")

    # a shared system-prompt prefix (so --prefix-cache has something to
    # hit) + per-request tails of 5..29 tokens, generation lengths 6..16;
    # one shared read-only context (prefix keys are seeded with its hash)
    rng = np.random.default_rng(0)
    system_prompt = rng.integers(1, cfg.vocab_size, size=2 * args.page_size)
    shared_ctx = stub_context(cfg, rng)
    items = []
    for _ in range(args.requests):
        plen = int(rng.integers(5, 30))
        glen = int(rng.integers(6, 17))
        items.append((np.concatenate(
            [system_prompt, rng.integers(1, cfg.vocab_size, size=plen)]),
            glen))

    if args.open_loop:
        clock = args.clock or ("wall" if dev.type == "cuda" else "model")
        arr = poisson_arrivals(items, args.rate, seed=1,
                               temperature=args.temperature,
                               extra=shared_ctx)
        for a in arr:
            print(f"arrival t={a.arrival_s * 1e3:7.1f}ms "
                  f"prompt_len={len(a.prompt)} gen_len={a.max_new_tokens}")
        res = OpenLoopFrontend(engine, clock=clock).run(arr)
        print()
        for ev in res.events:
            print(f"rid={ev.rid} arrived@{ev.arrival_s * 1e3:7.1f}ms "
                  f"ttft={_ms(ev.ttft_s)} worst_tbt={_ms(ev.max_tbt_s)} "
                  f"tokens={ev.n_generated} ({ev.finish_reason})")
        lat = res.summary()
        slo = SLO(ttft_s=max(3 * lat["ttft_s"]["p50"], 1e-9),
                  tbt_s=max(3 * lat["tbt_s"]["p50"], 1e-9))
        lat = res.summary(slo=slo)
        q = lat["queue_depth"]
        print(f"\nopen-loop @ {args.rate}/s ({clock} clock): "
              f"ttft p50={lat['ttft_s']['p50'] * 1e3:.1f}ms "
              f"p99={lat['ttft_s']['p99'] * 1e3:.1f}ms  "
              f"tbt p99={lat['tbt_s']['p99'] * 1e3:.2f}ms  "
              f"queue mean={q['mean']:.2f} max={q['max']}")
        print(f"goodput under SLO(3x p50): {lat['goodput_tok_s']:.1f} "
              f"tok/s (attainment {lat['slo']['attainment']:.2f})")
        return {"latency": lat, "engine": engine}

    for prompt, glen in items:
        rid = engine.submit(prompt, glen, temperature=args.temperature,
                            extra=shared_ctx)
        print(f"submit rid={rid} prompt_len={len(prompt)} gen_len={glen}")
    results = engine.run()
    for req in engine.requests():
        print(f"rid={req.rid} slot-admitted@step {req.admit_step:3d} "
              f"first-token@{req.first_token_step:3d} "
              f"finished@{req.finish_step:3d} ({req.finish_reason}) "
              f"tokens={results[req.rid][:8].tolist()}...")
    late = [r for r in engine.requests() if r.admit_step > 0]
    if late:
        print(f"\n{len(late)} request(s) admitted into recycled slots "
              f"mid-run (steps {[r.admit_step for r in late]})")
    s = engine.stats.summary()
    timed = (f"{s['tok_per_s']:.1f} tok/s generated (CUDA events), "
             f"p50={s['step_ms_p50']:.1f}ms p95={s['step_ms_p95']:.1f}ms"
             if s["tok_per_s"] is not None else "no step timed on the CPU")
    print(f"\n{s['generated_tokens']} tokens in {s['steps']} steps: {timed}"
          f"  occupancy={s['mean_occupancy']:.2f}")
    if engine.prefix_cache:
        print(f"prefix cache: {s['prefix_hit_tokens']} prompt tokens "
              f"copied from pooled donor rows instead of re-prefilled "
              f"(hit rate {s['prefix_hit_rate']:.2f})")
    if args.speculative:
        print(f"speculative: {s['accepted_draft_tokens']} of "
              f"{s['drafted_tokens']} drafted tokens accepted "
              f"(accept_rate {s['accept_rate']:.2f})")
    return {"results": results, "engine": engine}


if __name__ == "__main__":
    main()
