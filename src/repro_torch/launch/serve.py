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

``--open-loop`` routes the workload through the open-loop front end
(``serve.frontend.OpenLoopFrontend``): requests arrive on a clock
instead of being queued up front, and the run prints TTFT, TBT and E2E
percentiles, the queue depth, the makespan, and SLO attainment and
goodput under a TTFT + TBT SLO (``--slo-ttft``, ``--slo-tbt``; by
default 3x the run's p50s).  ``--rate`` sets the arrival rate in
requests/s (0: every request at t=0, through the front end),
``--arrival poisson|gamma|trace`` the process (``--cv``: gamma's
burstiness), ``--trace`` replays a ``repro.serve.trace`` JSON workload
and ``--record-trace`` writes the run's completed arrivals as one.
``--clock wall`` (the default) advances the front end's clock by each
step's time between CUDA events, so it needs the card; ``--clock
model`` advances it by the cost model's step times against the card's
ceilings (``engine.modeled_step_time``), deterministic and the only
clock on the CPU.  ``--chunk-policy stall_free --tbt-target S`` makes
the scheduler's prefill chunk a per-step decision sized to keep the
time between decode tokens under S seconds (fed by each step's CUDA-event
time, or under ``--clock model`` the modeled one; on the CPU it needs
``--open-loop --clock model``).

  PYTHONPATH=src python -m repro_torch.launch.serve --arch granite-3-2b \\
      --reduced --device cpu --open-loop --clock model --rate 2000 \\
      --requests 8 --prompt-len 16 --gen-len 8
  PYTHONPATH=src python -m repro_torch.launch.serve --arch granite-3-2b \\
      --slots 8 --requests 32 --prompt-len 256 --min-prompt-len 32 \\
      --prefill-chunk 32 --open-loop --rate 1.0 --arrival gamma --cv 2

``--min-prompt-len`` is the shortest prompt drawn (by default half of
``--prompt-len``, the reference's band).

``--mesh N|NxM|NxMxK`` serves sharded (the dense, moe, ssm and hybrid
families; the vlm and audio raise ``NotImplementedError``): the launcher
spawns the mesh's ranks on this host, one process a position, or joins
``torchrun``'s world when its environment is set; each rank draws the
same seeded weights layer by layer and keeps its blocks (with
``--int8``, each layer quantized before it is cut), serves the same
requests, and rank 0's results print once.  The decode slots shard over
the ``data`` axes; heads, the MLP, the vocabulary, the experts (or each
expert's d_ff where their count does not divide the axis) and the mamba
mixer's heads over ``model``; ``--sp-kv`` shards the attention cache's
sequence axis over ``model`` instead of its heads (it needs a model
axis; an attention-free family serves without it, as the reference's
rules strip it).  On the card the ranks use NCCL where each has a card
of its own, ``gloo`` where they share one; on the CPU ``gloo``.

  PYTHONPATH=src python -m repro_torch.launch.serve --arch granite-3-2b \
      --reduced --device cpu --mesh 2x2 --sp-kv
  PYTHONPATH=src python -m repro_torch.launch.serve \
      --arch jamba-v0.1-52b --reduced --device cpu --mesh 1x2 --int8
  PYTHONPATH=src python -m repro_torch.launch.serve --arch granite-3-2b \
      --mesh 2x2 --sp-kv --slots 8 --prompt-len 256
  PYTHONPATH=src python -m repro_torch.launch.serve \
      --arch phi3.5-moe-42b-a6.6b --mesh 1x2 --int8 --layers 4 --slots 4
"""
from __future__ import annotations

import argparse
import math
import os
from typing import Any, Dict, Optional

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.configs import ARCH_IDS, get_config, reduced_config
from repro_torch.launch import mesh as mesh_lib
from repro_torch.models.decode_state import stub_context
from repro_torch.models.model import LM, MESH_FAMILIES
from repro_torch.models.quant import param_bytes
from repro_torch.parallel import axes as paxes
from repro_torch.parallel.sharding import rules_for
from repro_torch.serve.arrivals import (closed_loop_arrivals,
                                        gamma_arrivals, poisson_arrivals,
                                        save_trace, trace_arrivals)
from repro_torch.serve.engine import ContinuousBatchingEngine, StaticBatchEngine
from repro_torch.serve.frontend import CLOCKS, OpenLoopFrontend
from repro_torch.serve.slo import SLO

# how long a spawned world of ranks may serve before it is killed
RANK_TIMEOUT_S = 3600.0


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
        chunk_policy: str = "fixed", tbt_target: Optional[float] = None,
        open_loop: bool = False, clock: str = "wall", rate: float = 0.0,
        arrival: str = "poisson", cv: float = 2.0,
        trace: Optional[str] = None, slo_ttft: Optional[float] = None,
        slo_tbt: Optional[float] = None,
        record_trace: Optional[str] = None,
        min_prompt_len: Optional[int] = None,
        mesh: Optional[str] = None, sp_kv: bool = False) -> Dict[str, Any]:
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
    and ``accept_rate``.  Every run returns the engine's summary
    (``engine_summary``: counts, the modeled ``model_flops`` and
    ``model_bytes``, on the card the times).  ``chunk_policy`` /
    ``tbt_target`` are the continuous engine's chunk policy; with
    ``open_loop`` the requests go through ``OpenLoopFrontend`` on
    ``clock`` (``rate``, ``arrival``, ``cv``, ``trace``: see the module
    docstring) and the result also holds ``latency`` (the front end's
    ``latency_summary`` under the SLO of ``slo_ttft`` / ``slo_tbt``, by
    default 3x the run's p50s), ``slo``, ``arrivals`` (the process's
    label), ``makespan_s`` and ``completed_arrivals``; ``record_trace``
    writes those as a replayable trace.  Prompts are ``min_prompt_len``
    (default ``prompt_len // 2``) to ``prompt_len`` tokens.

    ``mesh`` (a ``parse_mesh`` spec) and ``sp_kv`` serve sharded (see the
    module docstring): every rank's result is the same; rank 0's is
    returned, with ``mesh`` (the engine's ``sharding_meta``) and
    ``rank_param_bytes`` (each rank's bytes of the served tree)."""
    kw = dict(locals())
    dims = mesh_lib.parse_mesh_dims(mesh)
    if dims is not None or sp_kv:
        _check_mesh_options(kw, dims)
        world = math.prod(dims[0])
        if world > 1 and not dist.is_initialized():
            if "WORLD_SIZE" not in os.environ:
                device_type = "cpu" if str(device) == "cpu" else "cuda"
                res = mesh_lib.spawn_ranks(
                    _serve_rank, world, (kw,), device_type=device_type,
                    timeout=RANK_TIMEOUT_S,
                    threads=(max(1, (os.cpu_count() or 1) // world)
                             if device_type == "cpu" else 0))
                first = res[0]["tokens"]
                if any(sorted(r["tokens"]) != sorted(first) or not all(
                        np.array_equal(r["tokens"][k], first[k])
                        for k in first) for r in res):
                    raise RuntimeError("the ranks returned different tokens")
                res[0]["rank_param_bytes"] = [r["param_bytes"] for r in res]
                return res[0]
            mesh_lib.init_process_group(
                int(os.environ["RANK"]), int(os.environ["WORLD_SIZE"]),
                device_type="cpu" if str(device) == "cpu" else "cuda",
                init_method="env://")
        res = _serve(**kw)
        res["rank_param_bytes"] = [res["param_bytes"]]
        return res
    return _serve(**kw)


def _check_mesh_options(kw: Dict[str, Any], dims) -> None:
    """The launcher's refusals of a sharded run, before any rank starts."""
    cfg = (reduced_config(kw["arch"]) if kw["reduced"]
           else get_config(kw["arch"]))
    if cfg.family not in MESH_FAMILIES:
        raise NotImplementedError(
            f"--mesh / --sp-kv for the {cfg.family} family: not ported yet "
            f"(ROADMAP A10, item 6 left 1: sharded serving covers the "
            f"{', '.join(MESH_FAMILIES)} families)")
    if kw["sp_kv"] and (dims is None or "model" not in dims[1]):
        raise SystemExit("--sp-kv needs --mesh with a model axis "
                         "(e.g. --mesh 2x2)")
    if kw["static"]:
        raise ValueError("the static engine serves unsharded: drop --static")
    for flag, on in (("--open-loop", kw["open_loop"]),
                     ("--speculative", kw["speculative"]),
                     ("--chunk-policy stall_free",
                      kw["chunk_policy"] != "fixed")):
        if on:
            raise NotImplementedError(
                f"{flag} under --mesh: not ported yet (ROADMAP A10)")


def _serve_rank(rank: int, kw: Dict[str, Any]) -> Dict[str, Any]:
    """A spawned rank's run: the launcher's serving with its mesh."""
    return _serve(**kw)


def _serve(arch, *, reduced, slots, requests, prompt_len, gen_len,
           prefill_chunk, page_size, temperature, static, int8, layers,
           device, prefix_cache, prefix_pool, speculative, spec_k,
           chunk_policy, tbt_target, open_loop, clock, rate, arrival, cv,
           trace, slo_ttft, slo_tbt, record_trace, min_prompt_len, mesh,
           sp_kv) -> Dict[str, Any]:
    """``run``'s serving, in this process (a rank of ``mesh``'s world when
    one is given)."""
    if static and (prefix_cache or speculative):
        raise ValueError("the static engine has no prefix cache and no "
                         "speculative decoding: drop --static")
    if static and (open_loop or chunk_policy != "fixed"):
        raise ValueError("the static engine has no open-loop front end "
                         "and no chunk policy: drop --static")
    if record_trace and not open_loop:
        raise ValueError("--record-trace needs --open-loop (it records "
                         "the front end's completed arrivals)")
    if chunk_policy == "stall_free" and not tbt_target:
        raise ValueError("--chunk-policy stall_free needs --tbt-target "
                         "(seconds between decode tokens)")
    if open_loop and arrival == "trace" and not trace:
        raise ValueError("--arrival trace needs --trace FILE")
    p_min = (max(1, prompt_len // 2) if min_prompt_len is None
             else min_prompt_len)
    depth = {} if layers is None else {"n_layers": layers}
    cfg = (reduced_config(arch, **depth) if reduced
           else get_config(arch, **depth))
    grid = mesh_lib.parse_mesh(mesh, device="cpu" if str(device) == "cpu"
                               else None)
    model = LM(cfg, device=device if grid is None else grid.device)
    dev = model.device
    on_card = dev.type == "cuda"
    if on_card:
        torch.cuda.reset_peak_memory_stats(dev)
    shard = None
    if grid is not None:
        # each layer cut to this rank's blocks as it is drawn
        rules = rules_for(cfg, grid, sp_kv=sp_kv)
        shard = (lambda tree, specs:  # noqa: E731
                 paxes.shard_tree(tree, specs, grid, rules))
    params = model.init_params(torch.Generator(device=dev).manual_seed(0),
                               int8=int8, shard=shard)
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
            chunk_policy=chunk_policy, tbt_target_s=tbt_target,
            prefix_cache=prefix_cache, prefix_pool=prefix_pool,
            spec_decode=speculative, spec_k=spec_k, mesh=grid,
            sp_kv=sp_kv)
        n_req = requests or 2 * slots
        if open_loop:
            front = OpenLoopFrontend(engine, clock=clock)
            arr, label = _arrivals(cfg, rng, n_req, p_min, prompt_len,
                                   gen_len, temperature, rate, arrival, cv,
                                   trace)
            prompts = [a.prompt for a in arr]
            n_req = len(arr)
            if on_card:
                start.record()
            ol = front.run(arr)
            tokens = ol.results
        else:
            prompts = []
            for _ in range(n_req):
                prompts.append(rng.integers(1, cfg.vocab_size, size=int(
                    rng.integers(p_min, prompt_len + 1))))
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
        prefill_ms=None, step_ms_p50=None, peak_gib=None,
        engine_summary=st, open_loop=open_loop, latency=None,
        mesh=None if static else engine.sharding_meta)
    if not static:
        res["prefix_cache"] = engine.prefix_cache
        res["speculative"] = engine.spec_decode
        res["chunk_policy"] = chunk_policy
        res["last_chunk_width"] = engine.sched.last_chunk_width
        res["paged_meta"] = engine.paged_meta
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
    if res["open_loop"]:
        res.update(clock=clock, arrivals=label, makespan_s=ol.makespan_s,
                   completed_arrivals=ol.completed_arrivals,
                   **_latency(ol, slo_ttft, slo_tbt))
        if record_trace:
            save_trace(record_trace, ol.completed_arrivals)
            res["record_trace"] = record_trace
    return res


def _arrivals(cfg, rng, n_req, p_min, prompt_len, gen_len, temperature,
              rate, arrival, cv, trace):
    """The open-loop workload and its label, drawn as the reference
    launcher draws it: one stub context for every request (a
    cross-attention family's), then each prompt's length and tokens;
    arrivals seeded 2."""
    extra = stub_context(cfg, rng)
    if trace or arrival == "trace":
        return (trace_arrivals(trace, vocab_size=cfg.vocab_size,
                               extra=extra), f"trace {trace}")
    items = []
    for _ in range(n_req):
        plen = int(rng.integers(p_min, prompt_len + 1))
        items.append((rng.integers(1, cfg.vocab_size, size=plen), gen_len))
    if rate <= 0:
        return (closed_loop_arrivals(items, temperature=temperature,
                                     extra=extra),
                "closed-loop (all at t=0)")
    if arrival == "gamma":
        return (gamma_arrivals(items, rate, cv=cv, seed=2,
                               temperature=temperature, extra=extra),
                f"gamma rate={rate}/s cv={cv}")
    return (poisson_arrivals(items, rate, seed=2, temperature=temperature,
                             extra=extra), f"poisson rate={rate}/s")


def _latency(ol, slo_ttft, slo_tbt) -> Dict[str, Any]:
    """The run's latency block under its SLO (each bound by default 3x
    the run's p50; no SLO where a bound would be 0)."""
    lat = ol.summary()
    ttft = slo_ttft if slo_ttft is not None else 3 * lat["ttft_s"]["p50"]
    tbt = slo_tbt if slo_tbt is not None else 3 * lat["tbt_s"]["p50"]
    slo = SLO(ttft_s=ttft, tbt_s=tbt) if ttft > 0 and tbt > 0 else None
    if slo is not None:
        lat = ol.summary(slo=slo)
    return {"latency": lat, "slo": slo}


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
    if res.get("mesh"):
        sm = res["mesh"]
        line += (f" | mesh {sm['mesh']}: {sm.get('slot_shards', 1)} slot "
                 f"shard(s), sp_kv={sm['sp_kv']}, rank params "
                 f"{[round(b / 1e9, 3) for b in res['rank_param_bytes']]} GB"
                 + (f"; forced replication: {sm['forced_replication']}"
                    if sm["forced_replication"] else ""))
    line += f" | sample: {list(map(int, first[:12]))}"
    if res["open_loop"]:
        line += "\n" + _open_loop_lines(res)
    return line


def _open_loop_lines(res: Dict[str, Any]) -> str:
    """The reference launcher's open-loop printout."""
    lat, slo = res["latency"], res["slo"]
    out = [f"[serve] open-loop {res['arch']} ({res['family']}) "
           f"requests={lat['requests']} completed={lat['completed']}: "
           f"{res['arrivals']}, clock={res['clock']}"]
    for key, name in (("ttft_s", "TTFT"), ("tbt_s", "TBT"),
                      ("e2e_s", "E2E")):
        d = lat[key]
        out.append(f"[serve]   {name}: p50={d['p50'] * 1e3:.2f}ms "
                   f"p90={d['p90'] * 1e3:.2f}ms "
                   f"p99={d['p99'] * 1e3:.2f}ms (n={d['n']})")
    q = lat["queue_depth"]
    out.append(f"[serve]   queue depth: mean={q['mean']:.2f} "
               f"max={q['max']}; makespan={lat['makespan_s'] * 1e3:.1f}ms")
    if slo is not None:
        out.append(f"[serve]   SLO(ttft<={slo.ttft_s * 1e3:.1f}ms, "
                   f"tbt<={slo.tbt_s * 1e3:.1f}ms): "
                   f"attainment={lat['slo']['attainment']:.2f} "
                   f"goodput={lat['goodput_tok_s']:.1f} tok/s")
    if res["chunk_policy"] == "stall_free":
        out.append(f"[serve]   stall-free chunks: last width "
                   f"{res['last_chunk_width']}")
    if "record_trace" in res:
        out.append(f"[serve]   recorded {len(res['completed_arrivals'])} "
                   f"completed arrival(s) -> {res['record_trace']} (replay "
                   f"with --arrival trace --trace {res['record_trace']})")
    return "\n".join(out)


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
    ap.add_argument("--mesh", default=None,
                    help="serve sharded over a mesh of ranks: N (data), "
                         "NxM (data x model) or NxMxK (pod x data x "
                         "model); decode slots shard over (pod, data); "
                         "the dense, moe, ssm and hybrid families")
    ap.add_argument("--sp-kv", action="store_true",
                    help="also shard the KV cache's sequence axis over "
                         "'model' (sequence-parallel flash decoding); "
                         "needs a mesh with a model axis")
    ap.add_argument("--min-prompt-len", type=int, default=None,
                    help="shortest prompt drawn (default: half of "
                         "--prompt-len)")
    ap.add_argument("--open-loop", action="store_true",
                    help="serve through the open-loop front end: "
                         "requests arrive on a clock; prints TTFT/TBT/"
                         "E2E percentiles and goodput under the SLO")
    ap.add_argument("--clock", default="wall", choices=CLOCKS,
                    help="open-loop clock: wall (each step between CUDA "
                         "events; the card only) or model (the cost "
                         "model's step times; required on the CPU)")
    ap.add_argument("--rate", type=float, default=0.0,
                    help="open-loop arrival rate in requests/s "
                         "(0 = all requests arrive at t=0)")
    ap.add_argument("--arrival", default="poisson",
                    choices=("poisson", "gamma", "trace"),
                    help="open-loop arrival process (gamma: see --cv; "
                         "trace: see --trace)")
    ap.add_argument("--cv", type=float, default=2.0,
                    help="gamma arrivals: inter-arrival coefficient of "
                         "variation (>1 = burstier than Poisson)")
    ap.add_argument("--trace", default=None,
                    help="replay a repro.serve.trace JSON workload file "
                         "(implies --arrival trace)")
    ap.add_argument("--slo-ttft", type=float, default=None,
                    help="SLO: max seconds to first token (default: "
                         "3x the run's p50 TTFT)")
    ap.add_argument("--slo-tbt", type=float, default=None,
                    help="SLO: max seconds between tokens (default: "
                         "3x the run's p50 TBT)")
    ap.add_argument("--tbt-target", type=float, default=None,
                    help="stall_free chunk policy: the decode "
                         "time-between-tokens bound (seconds) chunks "
                         "are sized against")
    ap.add_argument("--record-trace", default=None, metavar="PATH",
                    help="open-loop only: write the run's completed "
                         "arrivals as a replayable repro.serve.trace "
                         "JSON workload file (replay with --trace PATH)")
    ap.add_argument("--speculative", action="store_true",
                    help="n-gram draft-verify speculative decoding: "
                         "verify up to --spec-k drafted tokens a greedy "
                         "row a step (identical tokens, fewer steps)")
    ap.add_argument("--spec-k", type=int, default=4,
                    help="max draft tokens verified a row a step")
    ap.add_argument("--chunk-policy", default="fixed",
                    choices=("fixed", "stall_free"),
                    help="prefill chunking: fixed constant-width chunks "
                         "or per-step stall-free widths tuned to "
                         "--tbt-target")
    args = ap.parse_args(argv)
    res = run(args.arch, reduced=args.reduced, slots=args.slots,
              requests=args.requests, prompt_len=args.prompt_len,
              gen_len=args.gen_len, prefill_chunk=args.prefill_chunk,
              page_size=args.page_size, temperature=args.temperature,
              static=args.static, device=args.device, int8=args.int8,
              layers=args.layers,
              prefix_cache=args.prefix_cache, prefix_pool=args.prefix_pool,
              speculative=args.speculative, spec_k=args.spec_k,
              chunk_policy=args.chunk_policy, tbt_target=args.tbt_target,
              open_loop=args.open_loop, clock=args.clock, rate=args.rate,
              arrival=args.arrival, cv=args.cv, trace=args.trace,
              slo_ttft=args.slo_ttft, slo_tbt=args.slo_tbt,
              record_trace=args.record_trace,
              min_prompt_len=args.min_prompt_len,
              mesh=args.mesh, sp_kv=args.sp_kv)
    if not dist.is_initialized() or dist.get_rank() == 0:
        print(report(res), flush=True)
    return res


if __name__ == "__main__":
    main()
