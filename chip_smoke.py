"""Drive the PyTorch port on one NVIDIA Hopper card and check it end to end.

    python3 chip_smoke.py              # every phase; needs one sm_90 card
    python3 chip_smoke.py --profile    # also profile decode and train steps

Phases (one line each; any failure exits nonzero and prints no result):

1. device  — the card's name and power limit (nvidia-smi), capability
             (9, 0) required; there is no fallback to the CPU.
2. build   — nvcc builds the twelve kernel libraries from the checkout,
             all at once (paged attention, STREAM, SpMV (both idioms), GEMM,
             conv2d, strided gather, tail mask, Qsim gate, flash attention,
             flash decode, SSD scan, int8 GEMM).
   sass    — cuobjdump's counts of the matrix instructions in the flash
             attention (HMMA or HGMMA required), GEMM (DMMA required) and
             SSD scan (TF32 HMMA required: its 3xTF32 products) libraries,
             and of the copy instructions in the SpMV library (UBLKCP or
             LDGSTS required: the take kernel's bulk-copied ring).
3. kernel  — the paged-attention kernel against its plain PyTorch version
             on the card, at granite-3-2b (H 64), qwen3-1.7b (H 128),
             phi3-medium-14b (10 KV heads), grok-1-314b (G 6),
             whisper-base (G 1, H 64) and llama-3.2-vision-90b (G 8, H
             128) shapes:
             decode (Sq 1) and a prefill chunk (Sq 32), ragged
             kv_valid (0, 1, page boundaries, partial last pages, full),
             identity and permuted page maps, without and with softcap 30
             (the queries scaled by 30 for it: scores of ~30, where the
             cap moves the output).  Prints the kernel's time,
             the plain version's, the time of
             F.scaled_dot_product_attention on the gathered dense cache (a
             yardstick the port never calls) and the bound (bytes over the
             memory rate, or operations over the bf16 peak, whichever is
             larger), and the KV split the wrapper launched
             (kernel.split_plan: splits x tokens, grid, block mode).  On
             the identity-map cases the kernel is also timed at 1, 2, 3, 4
             and 8 splits forced (the sweep the plan's rule is read
             against).  Then the verify forward of speculative decoding
             (spec_k 4): Sq 5, each row fed 0, 1, 3 or 5 tokens after its
             position (the columns past the feed must come out finite),
             at granite's and qwen3's heads, bf16 and fp32 K/V; the
             granite bf16 case timed as the others.  Times come from
             repro_torch.perf.measure.
4. kernels-veceval — the STREAM, SpMV, GEMM and conv2d kernels against
             their plain versions on the card: ragged shapes, the JAX
             package's default sizes and the card sizes past the 50 MB L2.
             At the card size each prints kernel, plain, library (a PyTorch
             call the port never makes: torch.add, cuSPARSE through a CSR
             tensor, torch.matmul, F.conv2d) and bound ms.  TF32 is off.
             The GEMM at every block multiplier in both dtypes (ragged,
             512^3 and 4096^3 checked; 4096^3 timed: Fig 7 on the card).
             The conv2d's tile (kernel.plan) at each card-size layer, and
             two layers timed: 64 -> 64 (alexnet's largest) and yolov3's
             8 -> 32, both 3x3 at 224^2.
             The take SpMV on both paths (kernel.take_plan: the vector
             path's persistent ring, the general path), every block
             multiplier, K 1 to 64, columns at -1 and at C (they add
             nothing), a misaligned view (the general path), at 2^14 and
             2^22 rows; timed at 2^22 x 16 against C 2^22: both paths at
             every block multiplier beside the plain version and cuSPARSE,
             and three probes on the same bytes that part the costs (unit-
             stride columns: the DRAM stream; random within the first 2^14
             columns: the gather from L1; within the first 2^20: from L2);
             both paths also at the JAX size (2^14 x 16).
             The one-hot SpMV: tests/test_kernels_fused.py's shapes, ragged
             rows and nonzeros, columns at -1 and at C (they contribute 0);
             timed at the JAX veceval size (2^14 rows x 16, C 2^14: 2^32
             compare-selects) against cuSPARSE, with its compare-selects a
             second and the idiom's issue bound (one issue slot each, 128 a
             clock an SM, at the card's highest SM clock) beside the bytes
             bound; the card size (2.8e14 compare-selects) is left out.
   kernels-paper — the strided-gather (both idioms), tail-mask (both
             idioms) and Qsim gate kernels against their plain versions:
             ragged rows (stride not dividing rows, remainders 0, 1, 7),
             every block multiplier, qubits 0, 1, 4, 5, 12 and n-1, the
             JAX sizes and the card sizes (2^21 x 128 rows, 28 qubits).
             Library yardsticks: x[::s].contiguous(), F.silu(x).mul_(2)
             (two calls) and torch.matmul of the complex gate with the
             state viewed as (outer, 2, 2^q).
   kernels-train — the flash-attention forward against its plain version:
             the two shapes the train phase gives it (qwen3-1.7b, bf16,
             causal, at batch 8 x seq 128 and batch 1 x seq 4096), then
             S 1, 63, 200 and 4096, G 1, 2 and 8, H 64 and 128 (and 32 at
             the short lengths), softcap 0 and 30, causal and full, fp32
             and bf16; out and lse both checked (ref.FLASH_TOL: bf16 out
             within one bf16 ulp of the value, rtol 8e-3, atol 1e-4).  At
             both train shapes (16/8 heads, H 128, bf16, causal): two
             launches give the same bits, and kernel, plain and
             F.scaled_dot_product_attention(is_causal=True,
             enable_gqa=True) (a yardstick the port never calls) are
             timed; the JSON line carries B 1 x S 4096.  Then
             whisper-base's train shapes (8/8 heads, H 64, bf16, B 8):
             the encoder's non-causal attention over 1500 frames (no
             multiple of a tile) and the decoder's causal S 128, out and
             lse against the plain version, timed beside SDPA.
   kernels-ssm — the SSD chunked-scan kernel against ref.ssd_chunked: y and
             h_final within 2e-3 (the JAX kernel test's tolerance) for every
             P (16, 32, 64), N (16 to 128) and chunk (16 to 256) it takes,
             at S 1, 200 and 2048 (b 8 at S 200), then at mamba2-780m's
             layer (b 8, S 2048, 48 heads, P 64, N 128, chunk 256) and
             jamba-v0.1-52b's (b 8, S 512, 128 heads, P 64, N 16, chunk
             256), where kernel and plain are timed (no PyTorch call
             computes the SSD, so no library time) and the bound is
             printed: the operations
             at the fp32 CUDA-core rate (the record's), and three times
             them at the TF32 tensor-core rate (the kernel's 3xTF32), and
             the device time of each of the call's four kernels
             (torch.profiler).  Then the kernel under autograd
             (``ops.SSDChunked``: the kernel's forward, the plain scan's
             gradient) at mamba2-780m's and jamba-v0.1-52b's layers, b 1 x
             S 4096: every input's gradient against autograd through
             ref.ssd_chunked (within 1e-5 of its largest element), and the
             forward kernel, the Function's backward and the plain
             backward timed.
   kernels-int8 — the weight-only int8 GEMM against its plain version:
             tests/test_quant.py's shapes ((128, 256, 128), (256, 128, 384)),
             ragged M 1, 7, 8, 9, 16, 33, 64, 65 and 256 with K and N off
             every tile (byte loads and 16-byte loads), both layouts (q (K,
             N) and the tied unembed's (N, K) at N 49408), fp32 x (within
             2e-4, the JAX test's tolerance) and bf16 x (fp32 out within
             2e-4; bf16 out, the fp32 sum rounded once, within half a bf16
             ulp plus that fp32 difference).  Timed at granite-3-2b's decode
             (M 8: 2048 -> 8192, 8192 -> 2048, the transposed 2048 -> 49408
             unembed), the continuous engine's mixed step (M 256, 2048 ->
             8192) and a static prefill (M 4096: 2048 -> 8192 and the
             logits through the (V, d) table), and the GEMV at four times
             the decode's bytes (8192 -> 8192: its streaming rate and fixed
             cost), and jamba-v0.1-52b's expert products (4096 -> 14336
             and back at M 8 and M 640; its mamba B / C and dt
             projections, N 16 and 128 at M 8 and 4096, are checked
             only), and llama-3.2-vision-90b's MLP (8192 -> 28672 and
             back) and (N, K) unembed (8192 -> 128256) at M 8 and its
             cross K/V install (M 1601, 8192 -> 1024), bf16 x: kernel, plain, library (bf16 torch.matmul of
             the same weights dequantized beforehand, a call the port
             never makes) and bound (int8
             weights, x and y once at the memory rate, or the operations at
             the bf16 peak, whichever is larger); then the host time of a
             decode call.
   kernels-serve-dense — the dense-cache flash-decode kernel against its
             plain version: H 32/64/128, G 1/2/4/8, and the served
             groups G 6 (grok-1) and NKV 10 (phi3-medium), kv_valid 0, 1,
             a tile edge, ragged and the whole cache, Sq 1 and the
             per-query lengths of a 32-column prefill row, softcap 0 and
             30 (the queries scaled by 30, as phase 3's), fp32
             (2e-4, the JAX test's) and bf16 (one bf16 ulp), the cache a
             strided view in every other case; queries with no valid key
             exactly 0.  Timed at qwen3-1.7b's static decode (B 8, S_cache
             2088, kv_valid 2080, 16/8 heads, H 128), granite-3-2b's 6c
             shape (B 8, 552, 520, 32/8, H 64), qwen3's at 64 slots,
             the 6f and 6g shapes (B 8, 552, 520: 48/8 and 40/10, H 128),
             and the cross-attention decode over installed K/V, every key
             valid (6i: B 8, 1601 image tokens, 64/8 heads of 128; 6j: B
             8, 1500 frames, 8/8 of 64; each at Sq 1 and 32), bf16: kernel, plain, library (F.scaled_dot_product_attention
             with the valid-length mask on the dense cache laid out heads
             first, a call the port never makes) and bound, with the KV
             split the wrapper launched (kernel.decode_plan), and the
             kernel at 1, 2, 4 and 8 splits forced and the plan's, beside
             SDPA (the sweep the plan's rule is read against); the plan's
             and SDPA also without the L2 flush.  Then the verify width
             of speculative decoding with ``paged_kernel=False``: Sq 5,
             rows fed 0, 1, 3, 5 tokens (each query's length
             ``attention.query_lens``), 32/8 H64 and 16/8 H128, softcap 0
             and 30, fp32 and bf16; granite's bf16 shape timed beside
             SDPA and its bound.
5. parity  — the port on the card against the port on the CPU, reduced
             granite-3-2b in fp32 (TF32 off): greedy tokens identical; and
             one train step of reduced qwen3-1.7b with the flash kernel
             (fp32): loss and grad norm within 1e-4 relative.  Then reduced
             mamba2-780m in fp32 on tests/test_serve_families.py's request
             mix (a preemption, a mid-run admission): the continuous and
             the static engine's greedy tokens identical to each other and
             on the card and the CPU; the static prefills launch the SSD
             kernel once a layer.  Then weight-only int8: reduced
             granite-3-2b (H 64) and mamba2-780m, quantized, fp32, on the
             same mix: both engines' greedy tokens identical to each other
             and on the card and the CPU; the int8 GEMM launched (7 or 6) x
             n_layers + 1 times a forward on the card (reduced phi3.5-moe
             too: 4 + 3 x 4 a layer).  Then the dense-cache decode: reduced
             granite-3-2b, qwen3-1.7b, phi3.5-moe and grok-1 (softcap 30,
             6/1 heads: G 6) (H 64), fp32, on the same mix: the continuous
             engine with paged_kernel=False and True and the static engine
             give identical greedy tokens, on the card and the CPU; with
             False the flash-decode kernel launches n_layers times a
             forward and the paged kernel never, with True the reverse,
             and the static decode the flash-decode kernel.  Then reduced
             jamba-v0.1-52b (one period: 1 attention and 7 mamba layers,
             MoE on 4; H 64) in fp32 and in int8 (quantized on the CPU) on
             the same mix and engines: tokens identical, the attention
             kernels once a forward as above, the SSD kernel 7 times a
             static prefill and never in the continuous engine, the int8
             GEMM 107 times a forward in int8.  Then the cross-attention
             families: reduced llama-3.2-vision-90b (one period: 4
             attention layers and the gated cross layer over 16 image
             tokens, G 4) and whisper-base (2 encoder and 2 decoder
             layers over 24 frames, G 1), H 64, every gate_attn 0.5, fp32
             and int8, on the same mix with a stub context a request:
             tokens identical; the cross layers' decode one flash-decode
             launch each a forward, the self-attention layers as above;
             in int8 the GEMM's launches a forward, a static prefill (the
             context's K/V and the encoder too) and an admission's
             install, each counted from the config.
             Then the serving features, every engine with check=True (the
             shadow-state checker; no error finding): reduced granite,
             mamba2, phi3.5-moe, jamba, llama-3.2-vision and whisper (H
             64, fp32, gate_attn 0.5) with ``spec_decode=True, spec_k=4``
             (drafts from the spec-off run's tokens, every other one
             wrong: made, accepted and rejected on every family; the
             recurrent families verify in two passes) against it off on
             tests/test_serve_spec.py's mix, and ``prefix_cache=True``
             against it off on tests/test_serve_prefix.py's (a shared
             prefix), each with a preemption: identical greedy tokens, an
             accept rate above 0, prefix hits for the families that can
             share a prefix (none for ssm and hybrid).
6. serve   — the serving path: full-width granite-3-2b in bf16 with random
             weights from a seeded generator, 16 requests through the
             ContinuousBatchingEngine (8 slots, mid-run admission).  The
             paged kernel's launch count must equal 40 x the forward passes.
6b. serve-ssm — the ssm serving path: full-width mamba2-780m in bf16 with
             random weights from a seeded generator.  (a)
             ``launch.serve.run(static=True)``: 8 prompts of 2048 tokens,
             32 new tokens each; the prefill runs the SSD kernel, 48
             launches (one a layer).  (b) the ContinuousBatchingEngine on
             8 requests drawn as phase 6's (8 slots, 32-256 prompt
             tokens, 32 new, prefill chunk 32), the model cut to 16 of
             its 48 layers (the script's time): its prefill
             is the token-by-token recurrence, so 0 SSD launches.  Each prints
             tokens/s, step p50 (and the static prefill ms) from CUDA
             events and peak memory.  (c) the first 1024 tokens of (a)'s
             first prompt through the recurrence in one decode forward
             against the kernel's
             prefill, in bf16 and then in fp32 (the same weights before
             rounding): each layer's max relative error of h and whether
             the first greedy token agrees, reported only.
6c. serve-int8 — the int8 serving path: full-width granite-3-2b, weights
             drawn in bf16 from a seeded generator.  (a)
             ``launch.serve.run(static=True)``: 8 prompts of 512 tokens, 32
             new; first in bf16 (the dense prefill mode at full width, no
             int8 launch), then with ``int8=True`` (the weights quantized,
             the bf16 tree freed): the int8 GEMM launched 7 x 40 + 1 = 281
             times a forward; both decode through the dense-cache
             flash-decode kernel, 40 launches a decode forward, and never
             the paged kernel.  (b) the ContinuousBatchingEngine in int8 at
             phase 6's request mix, 281 launches a forward.  Each prints
             tokens/s, step p50 (and the static prefill ms) from CUDA
             events, peak memory and both trees' bytes; (a) also the share
             of int8 greedy tokens equal to the bf16 run's (reported only).
6d. serve-dense — the dense-cache decode: full-width qwen3-1.7b in bf16,
             weights random from a seeded generator.  (a)
             ``launch.serve.run(static=True)``: 8 prompts of 2048 tokens, 32
             new; the flash-decode kernel launched 28 x 31 decode forwards,
             none in the prefill, the paged kernel never.  (b) the
             ContinuousBatchingEngine at phase 6's request mix with
             paged_kernel=False (the flash-decode kernel only, 28 a
             forward) and True (the paged kernel only).  Each prints
             tokens/s, step p50 (and the static prefill ms) from CUDA
             events and peak memory; (b) also the share of greedy tokens the
             two runs share (reported only: in bf16 the kernels round
             differently).
6e. serve-moe — phi3.5-moe-42b-a6.6b at full width (32 layers, 16
             experts top-2 of d_ff 6400), weight-only int8 drawn and
             quantized layer by layer (the 84 GB bf16 tree is never
             held): (a) ``launch.serve.run(static=True, int8=True)``, 8 x
             512 prompt tokens, 32 new, the decode through the
             flash-decode kernel; (b) the ContinuousBatchingEngine at
             phase 6's request mix, through the paged kernel; every
             forward launches the int8 GEMM 32 x (4 + 3 x 16) + 1 = 1665
             times (one an expert and projection), checked on one decode
             forward.  Prints prefill ms, step p50, tokens/s, the int8
             tree's bytes and the peak after init and in serving.
6f. serve-grok — grok-1-314b at full width (48/8 heads of 128: G 6,
             softcap 30, 8 experts of d_ff 32768) cut to 4 of its 64
             layers, int8: static 8 x 512 + 32 (the flash-decode kernel
             at G 6, softcap 30), then 8 requests drawn as phase 6's (the
             paged kernel; a 32-column chunk is 192 query rows).
6g. serve-phi3m — phi3-medium-14b at full width in bf16 (40/10 heads:
             B x NKV = 80), static 8 x 512 + 32 through the flash-decode
             kernel.
6h. serve-hybrid — jamba-v0.1-52b at full width (4 periods of 1 attention
             and 7 mamba layers, 16 experts top-2 of d_ff 14336 on the odd
             layers, no RoPE), weight-only int8 drawn and quantized
             sub-layer by sub-layer (the 103 GB bf16 tree is never held;
             the int8 tree under 53 GB and the peak after init under 70 GB,
             checked): (a) ``launch.serve.run(static=True, int8=True)``,
             8 x 512 + 32, the prefill through the SSD kernel (28
             launches) and the decode through the flash-decode kernel (4 a
             forward); (b) 8 requests drawn as phase 6's through the paged
             kernel, the model cut to 2 of its 4 periods (16 layers) for
             the script's time; one decode forward launches the int8 GEMM
             exactly 2 x (4 + 3 + 7 x 6 + 3 x 3 + 4 x 3 x 16) + 1 = 501
             times, checked; (c) 8 prompts of 64 tokens through both
             engines: the share of greedy tokens alike; (d) those prompts
             through one prefill-mode (SSD kernel) and one decode-mode
             (recurrence) forward, in bf16 and in fp32 (one period at
             full width): argmaxes alike, the logits' difference and the
             top-2 gap (all reported only).
6i. serve-vlm — llama-3.2-vision-90b at full width (64/8 heads of 128,
             d_ff 28672, 1601 image tokens) cut to 10 of its 100 layers (2
             periods of 4 attention layers and a gated cross layer), int8
             drawn layer by layer, every gate_attn set to 1.0 after the
             draw (test data): (a) static 8 x 512 + 32 through
             ``launch.serve.run`` with its stub image embeds (the decode
             through the flash-decode kernel, 8 self and 2 cross launches
             a forward); (b) 8 requests drawn as phase 6's, a stub image
             each, through the paged kernel (self) and the flash-decode
             kernel (cross); one decode forward launches the int8 GEMM 67
             times and one install 4, checked; the int8 tree (10.66 GB;
             all 100 layers reckoned on the meta device) under 11.5 GB and
             the peak after init under 20 GB; the CUDA-event ms of one
             admission's install.
6j. serve-audio — whisper-base whole in bf16 (6 encoder and 6 decoder
             layers, 8/8 heads of 64, 1500 frames): (a) static 8 x 128 +
             64 over stub frames through ``launch.serve.run``; (b) 16
             requests at phase 6's mix, stub frames each; the launches a
             decode forward (6 self and 6 cross flash-decode), and the
             CUDA-event ms of one install and of the encoder in it.
6k. serve-features — the serving features at full width, every engine
             with check=True (no error finding): (a) granite-3-2b bf16
             cut to 5 of its 40 layers (for the script's time), 16
             requests sharing a 256-token prefix plus 16-128 own
             tokens at phase 6's mix, ``prefix_cache`` off then on:
             identical tokens, prefix hits > 0; (b) granite-3-2b, 8
             requests repeating a 32-token phrase 4-8 times, 64 new,
             ``spec_decode`` off then on (spec_k 4): the paged kernel 5
             launches a forward, verify forwards included; (c)
             mamba2-780m at full width cut to 8 of its 48 layers (its
             prefill runs token by token), as (b): the two-pass verify's
             snapshot (its bytes checked against the config's), accept
             rate; then again with drafts from the off run's tokens
             (every other one wrong), so the replay runs at full width
             whatever the drafter finds.  Each prints tokens/s, step p50
             and p95, hits, drafts, verify and plain-decode steps, peak
             memory; (b) and (c) the share of greedy tokens alike on and
             off (reported only: bf16).
6l. serve-open-loop — the open-loop front end, granite-3-2b bf16 at
             full width cut to 5 of its 40 layers (for the script's
             time) and phase 6's engine shape, every run through
             the paged kernel (5 launches a forward, checked): (a) 16
             requests through ``engine.run()``, then ``reset()`` and the
             same requests through ``OpenLoopFrontend(clock="wall")``
             over closed-loop arrivals: identical tokens and steps, both
             runs' tok/s, and lambda_max = requests / the closed-loop
             time; (c) (a) again on the model clock against the card's
             HWSpec, step events recorded: the modeled flops and bytes,
             model_tflops_per_s, and modeled over measured step time,
             all steps and pure-decode steps (the served step's share of
             its bound); (d) a 64-token request (128 new) and a
             448-token one (1 new) arriving about 10 decode steps later,
             ``chunk_policy`` fixed then stall_free at 1.2x (a)'s
             pure-decode p50 under wall feedback: request 0's worst, p99
             and p50 TBT, prefill steps, chunk widths; request 0's
             tokens identical under the fixed policy with stall-free's
             chunks forced as under stall-free, and under both policies
             where they chunked its prompt alike; (b)
             ``launch.serve.run(open_loop=True)``, 32 requests of 32-256
             prompt tokens and 32 new, Poisson at 0.5 and 0.9 lambda_max
             and gamma at 0.9 (cv 2): TTFT, TBT, E2E percentiles, queue
             depth, makespan, SLO attainment and
             goodput under the launcher's default SLO; the last run's
             recorded trace (written to a temporary directory) replayed
             through the launcher to identical tokens.
6m. serve-mesh — sharded serving over spawned ranks that share the
             one card through ``gloo`` (NCCL refuses two ranks on one
             device; the script prints each mesh and its backend).  First
             B1 at the shard shapes: ``decode_partials`` (B1 over one
             rank's slice of the cache at its ``kv_offset``) against a
             plain masked softmax over the slice, granite's heads at 8
             slots, the second half of (a)'s 256-token cache at Sq 1 and
             (a)'s 128-token prefill chunk, and of a 512- and a 400-token
             cache (a 200-key slice, a partial last tile) at Sq 1 and 32:
             rows whose keys all lie before the slice (a fully masked
             shard), chunks crossing its start (a negative shifted
             position), bf16 and fp32, softcap 0 and 30, at 2e-3; (a)'s
             128-key slice in bf16 timed beside SDPA over the slice and
             the bytes bound.  (a) granite-3-2b at full width
             in fp32, mesh 2x2 with SP-KV and the prefix cache: 8
             requests of 32-200 tokens sharing a 32-token prefix on 4
             slots, 16 greedy tokens: every rank's tokens identical to
             the unsharded engine's on the card (same seeded weights,
             each rank drawing them layer by layer and keeping its
             blocks); prints ``sharding_meta``, each rank's parameter
             bytes against the whole tree's, B1's launches on each rank
             (all in the ``kv_offset`` mode, > 0 on every rank).  (b)
             granite-3-2b bf16 cut to 5 of its 40 layers, mesh 1x2 (the
             heads, the MLP and the vocabulary split): the first prefill
             chunk's max |dlogit| against the unsharded forward, held
             within 0.25, which the same chunk with wo's sum over the
             model axis dropped (a planted fault) must exceed; 4
             requests with the pure-decode step's p50 on rank 0 and the
             share of it inside the collectives (CUDA events), beside
             the unsharded engine's p50 (two ranks time-sharing one card
             say nothing of a deployment over cards).  (c) granite-3-2b
             cut to 5 layers in int8 with fp32 compute, mesh 1x2, 4
             requests of 8 tokens: tokens identical to the unsharded int8
             engine's, B5 launched on both ranks.  Then, in the same
             2-rank world, the moe, ssm and hybrid families at full width
             in fp32 compute on 1x2, each rank drawing its blocks layer
             by layer, 4 requests of 32-128 tokens on 4 slots, 16 greedy
             tokens, every rank's tokens identical to the unsharded
             engine's on the card (else the first step that differs, its
             max |dlogit| and the unsharded top-2 gap there, and the
             phase fails): (d) phi3.5-moe-42b in int8 cut to 4 of 32
             layers (expert-parallel: 8 of 16 experts a rank), B5
             launched 113 times in one decode forward on each rank (209
             unsharded), B1 on both ranks, a rank's parameter bytes at
             most 0.55 of the whole tree's; (e) mamba2-780m cut to 8 of
             48 layers (24 of 48 heads a rank), each rank's h and conv
             window bytes a slot and layer as the config reckons them
             for its heads; (f) jamba-v0.1-52b in int8, one period (8 of
             32 layers: 1 attention, 7 mamba, MoE on 4), B5 155 a decode
             forward on each rank (251 unsharded), B1 on both ranks, and
             the pure-decode p50 on rank 0 with its share inside the
             collectives beside the unsharded p50 (reported).  Any rank's
             failure or timeout fails the phase.
7. train   — the train path: ``repro_torch.launch.train.run`` on
             full-width qwen3-1.7b (bf16 params, fp32 AdamW moments,
             remat full) with attention_impl "pallas", at the JAX
             launcher's batch 8 x seq 128: 3 steps ending in a checkpoint
             (restored bitwise), then a run resumed from it to step 6;
             then 2 steps at batch 1 x seq 4096 without checkpoints.  Per
             step: CUDA-event ms, tokens/s, loss, flash launches (2 x 28 per
             step: the checkpointed forward runs again in the backward);
             peak memory; the loss finite and lower at the end, steps 0
             and 5 within 2e-3 of the CUDA-core forward's, every loss
             printed in full for a bitwise comparison between runs.
7b. train-families — the rest of the train stack at full width: (a)
             mamba2-780m (bf16, remat full) through ``launch.train.run``
             at both phase 7 shapes, 2 steps each: B4 96 launches a step
             (the checkpointed forward runs again; the gradient is the
             plain scan's, ``ops.SSDChunked``), the first run's checkpoint
             restored bitwise; (b) whisper-base whole at B 8 x S 128 over
             8 x 1500 frames (the stream's ``audio_frames``) with
             attention_impl "pallas": B2 24 launches a step (6 encoder + 6
             decoder layers, twice); (c) qwen3-1.7b cut to 14 of its 28
             layers (the script's time) at B 1 x S 4096, three
             steps each built through ``make_train_step``: remat full,
             ``fused_xent``, ``grad_compression="int8_ef"`` (grad_err 4
             bytes a parameter, checked), remat none, save_blocks and
             dots.  Each first takes the loss and its gradient alone at
             the initial parameters on step 0's batch (its peak, no
             optimizer): the gradient within 1e-3 of remat full's, leaf
             by leaf, where it is the same computation (the remat modes,
             int8_ef before its round trip).  Step 0's and step 2's
             losses (the updates move the loss by more than 1) within
             2e-3 of remat full's, step 0's grad_norm within 1e-3 (fused_xent:
             2e-2); int8_ef's step 2 loss is reported only (its updates
             differ by design), and after its step 0 the residual's
             elements are within half a quantization step of the
             largest gradient element and grad_norm within the
             residual's norm of the gradient's.  fused_xent's bf16
             gradient against full's is reported; in fp32 at the same
             shape its gradient is within 1e-3 of the plain loss's,
             leaf by leaf.
             Each step's ms, tokens/s over steps 1-2 and the peak, with
             the card's name and power limit.  ``--profile`` adds a mamba2
             train step at each shape under torch.profiler (the
             device-side span of the plain backwards' ranges).
8. veceval — the proxy-app path: ``repro_torch.core.veceval`` over its six
             apps at the default sizes and at the card sizes; scalar,
             torch.compile and kernel versions timed interleaved, held
             against each other, each app's kernel launched, and each
             version the dispatcher sees (the scalar loop) counted once,
             untimed.
   Then the one-hot SpMV's path, ``kernels.spmv.ops.spmv_ell(idiom=
             "onehot")`` at the JAX veceval size: one launch, held against
             the take idiom.
9. paper   — the paper layer's path: ``figures.fig9_qsim`` (Qsim, §6) at
             16 qubits depth 6 (the JAX size) and 28 qubits depth 2 (1 GiB
             a plane): nonvec, torch.compile'd interleaved and planar, and
             the kernel version, held together by fidelity and norm, the
             gate kernel's launches equal to the uncontrolled gates times
             the calls, peak memory under 40 GiB.  Then
             ``figures.fig2_strided`` and ``fig3_tail`` at the JAX sizes
             and 2^21 x 128 rows, and ``core.microbench.run_suite``.
10. measure — the paper's measurement layer: (a) Table 1
             (``figures.table1_counters``) on the card, with the profiler's
             ``kernel_launches`` channel, in a fresh process started with
             the script (the card's kernel records are whole only early
             in a process): every record with its reference value and
             verdict, kernel_launches exact; the same channel read in
             this process, reported only; (b) Fig 6
             (``figures.fig6_breakdown``) from phase 8's rows at the JAX
             sizes: the scalar loop's aten ops by class (the dispatcher;
             it cannot see the compiled and kernel versions, whose rows
             say so); (c) Fig 7 (``figures.fig7_lmul``): the cost
             model's multiplier sweep and pick, B6 at m 1, 2, 4, 8 in fp32
             and fp64 at 4096^3 and ``chunked_attention``'s kv_chunk
             measured, the model's spill flags against ``cuobjdump
             -res-usage`` of the GEMM library (a disagreement is printed);
             Fig 8 (``figures.fig8_pressure``): B9 triad at 2^26 at each m,
             the model against the measurement; (d) granite-3-2b at
             phase 6's engine shape on a fresh autotune cache file:
             ``ContinuousBatchingEngine`` three times, ``paged_meta``
             "measured", then "cache", then "measured" again with
             ``retune=True`` (each split count's median and spread, the
             count chosen, ``split_plan``'s and why), B1 at the chosen
             count against its plain version, and 8 requests at phase
             6's mix: the paged
             kernel 40 launches a forward, every pure-decode launch at
             the tuned count; (e) the four examples
             (``repro_torch.examples``) at reduced configs on the card.

After each phase a
``[wall]`` line gives the seconds since the start.
The line before the last is the per-kernel JSON record (after the card's
name and power limit); the last line is ``{"ok": true, "device": {...}}``.
"""
from __future__ import annotations

import argparse
import collections
import concurrent.futures
import datetime
import json
import os
import pathlib
import re
import shutil
import statistics
import subprocess
import sys
import tempfile
import warnings

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(ROOT, "src"))
# Inductor compiles in this process: no pool of compile workers to outlive it
os.environ.setdefault("TORCHINDUCTOR_COMPILE_THREADS", "1")

import torch  # noqa: E402
import torch.nn.functional as F  # noqa: E402

from repro_torch.configs import get_config, reduced_config  # noqa: E402
from repro_torch.core import microbench, veceval  # noqa: E402
from repro_torch.core.costmodel import hw_for  # noqa: E402
from repro_torch.kernels.common import (  # noqa: E402
    REQUIRED_CAPABILITY, cuda_tool, library_path, sm_count)
from repro_torch.kernels.conv2d import kernel as conv_kernel  # noqa: E402
from repro_torch.kernels.conv2d import ref as conv_ref  # noqa: E402
from repro_torch.kernels.flash_attention import kernel as fa_kernel  # noqa: E402
from repro_torch.kernels.flash_attention import ops as fa_ops  # noqa: E402
from repro_torch.kernels.flash_attention import ref as fa_ref  # noqa: E402
from repro_torch.kernels.gemm import kernel as gemm_kernel  # noqa: E402
from repro_torch.kernels.gemm import ref as gemm_ref  # noqa: E402
from repro_torch.kernels.paged_attention import kernel as pa_kernel  # noqa: E402
from repro_torch.kernels.paged_attention import ops as pa_ops  # noqa: E402
from repro_torch.kernels.paged_attention import ref as pa_ref  # noqa: E402
from repro_torch.kernels.qsim_gate import kernel as gate_kernel  # noqa: E402
from repro_torch.kernels.qsim_gate import ref as gate_ref  # noqa: E402
from repro_torch.kernels.spmv import kernel as spmv_kernel  # noqa: E402
from repro_torch.kernels.spmv import ops as spmv_ops  # noqa: E402
from repro_torch.kernels.spmv import ref as spmv_ref  # noqa: E402
from repro_torch.kernels.ssd_scan import kernel as ssd_kernel  # noqa: E402
from repro_torch.kernels.ssd_scan import ops as ssd_ops  # noqa: E402
from repro_torch.kernels.ssd_scan import ref as ssd_ref  # noqa: E402
from repro_torch.kernels.stream import kernel as stream_kernel  # noqa: E402
from repro_torch.kernels.stream import ref as stream_ref  # noqa: E402
from repro_torch.kernels.strided import kernel as strided_kernel  # noqa: E402
from repro_torch.kernels.strided import ref as strided_ref  # noqa: E402
from repro_torch.kernels.tailmask import kernel as tail_kernel  # noqa: E402
from repro_torch.kernels.tailmask import ref as tail_ref  # noqa: E402
from repro_torch.kernels.wq_gemm import kernel as wq_kernel  # noqa: E402
from repro_torch.kernels.wq_gemm import ops as wq_ops  # noqa: E402
from repro_torch.kernels.wq_gemm import ref as wq_ref  # noqa: E402
from repro_torch.figures import fig2_strided, fig3_tail, fig9_qsim  # noqa: E402
from repro_torch.figures import (fig6_breakdown, fig7_lmul,  # noqa: E402
                                 fig8_pressure, table1_counters)
from repro_torch.core import autotune  # noqa: E402
from repro_torch.examples import autotune_demo as ex_autotune_demo  # noqa: E402
from repro_torch.examples import qsim_demo as ex_qsim_demo  # noqa: E402
from repro_torch.examples import quickstart as ex_quickstart  # noqa: E402
from repro_torch.examples import serve_decode as ex_serve_decode  # noqa: E402
from repro_torch.checkpoint import Checkpointer  # noqa: E402
from repro_torch.data import SyntheticLMStream  # noqa: E402
from repro_torch.launch import mesh as mesh_lib  # noqa: E402
from repro_torch.launch import serve as launch_serve  # noqa: E402
from repro_torch.launch import train as launch_train  # noqa: E402
from repro_torch.models import blocks  # noqa: E402
from repro_torch.models.attention import query_lens  # noqa: E402
from repro_torch.models.decode_state import (  # noqa: E402
    get_adapter, stub_context)
from repro_torch.models import layers as model_layers  # noqa: E402
from repro_torch.models.layers import dtype_of  # noqa: E402
from repro_torch.models.model import LM  # noqa: E402
from repro_torch.models.quant import matmul_q, quantize_params  # noqa: E402
from repro_torch.models.quant import param_bytes as quant_bytes  # noqa: E402
from repro_torch.optim import AdamWConfig, global_norm  # noqa: E402
from repro_torch.optim import warmup_cosine  # noqa: E402
from repro_torch.train import (  # noqa: E402
    init_train_state, make_loss_fn, make_train_step, value_and_grad)
from repro_torch.train.parity import (  # noqa: E402
    card_step_matches_cpu, train_launches)
from repro_torch.parallel import axes as paxes  # noqa: E402
from repro_torch.parallel.sharding import rules_for  # noqa: E402
from repro_torch.tree import tree_leaves  # noqa: E402
from repro_torch.quantum import gates  # noqa: E402
from repro_torch.perf.measure import measure, measure_group  # noqa: E402
from repro_torch.serve.arrivals import (  # noqa: E402
    ArrivalRequest, closed_loop_arrivals)
from repro_torch.serve.engine import (  # noqa: E402
    ContinuousBatchingEngine, StaticBatchEngine)
from repro_torch.serve.frontend import OpenLoopFrontend  # noqa: E402

TOL = 2e-3          # atol = rtol: bf16 inputs, fp32 math in both versions


def _lib(module, wrappers, replaces):
    """A kernel whose library is its module's ``load_library`` over
    ``SOURCES``."""
    return (module.load_library, module.SOURCES[0], wrappers, replaces)


# each kernel: the loader that builds its library, its source, its
# wrappers (which count their launches: one per idiom) and the TPU kernel
# it replaces
KERNELS = {
    "paged_partials": _lib(pa_kernel, (pa_kernel.paged_flash_decode,),
                           "src/repro/kernels/paged_attention/kernel.py:40"),
    "stream": _lib(stream_kernel, (stream_kernel.stream_call,),
                   "src/repro/kernels/stream/kernel.py:30"),
    "spmv_ell": _lib(spmv_kernel, (spmv_kernel.spmv_ell,),
                     "src/repro/kernels/spmv/kernel.py:24"),
    "spmv_ell_onehot": _lib(spmv_kernel, (spmv_kernel.spmv_ell_onehot,),
                            "src/repro/kernels/spmv/kernel.py:32"),
    "gemm": _lib(gemm_kernel, (gemm_kernel.gemm,),
                 "src/repro/kernels/gemm/kernel.py:24"),
    "conv2d_same": _lib(conv_kernel, (conv_kernel.conv2d_same,),
                        "src/repro/kernels/conv2d/kernel.py:21"),
    "strided": _lib(strided_kernel, (strided_kernel.strided_rowwise,
                                     strided_kernel.overfetch_select),
                    "src/repro/kernels/strided/kernel.py:24"),
    "tailmask": _lib(tail_kernel, (tail_kernel.exact_tail,
                                   tail_kernel.masked_full),
                     "src/repro/kernels/tailmask/kernel.py:33"),
    "qsim_gate": _lib(gate_kernel, (gate_kernel.apply_gate_planar,),
                      "src/repro/kernels/qsim_gate/kernel.py:26"),
    "flash_attention": _lib(fa_kernel, (fa_kernel.flash_fwd,),
                            "src/repro/kernels/flash_attention/kernel.py:32"),
    "flash_decode": (fa_kernel.load_decode_library,
                     fa_kernel.DECODE_SOURCES[0], (fa_kernel.flash_decode,),
                     "src/repro/kernels/flash_attention/kernel.py:132"),
    "ssd_scan": _lib(ssd_kernel, (ssd_kernel.ssd_scan_fwd,),
                     "src/repro/kernels/ssd_scan/kernel.py:25"),
    "wq_gemm": _lib(wq_kernel, (wq_kernel.wq_gemm,),
                    "src/repro/kernels/wq_gemm/kernel.py:22"),
}
WRAPPERS = {name: k[2] for name, k in KERNELS.items()}
# veceval at card sizes: every array past the 50 MB L2 or the work
# operation-bound (builders' own size arguments)
CARD_SIZES = {
    "stream": dict(n=1 << 26),
    "spmv": dict(rows=1 << 22, cols=1 << 22, nnz=16),
    "sgemm": dict(M=4096, K=4096, N=4096),
    "dgemm": dict(M=4096, K=4096, N=4096),
    "alexnet": dict(H=224, W=224, Cin=16),
    "yolov3": dict(H=224, W=224, Cin=16),
}
APP_KERNEL = {"stream": "stream", "spmv": "spmv_ell", "sgemm": "gemm",
              "dgemm": "gemm", "alexnet": "conv2d_same",
              "yolov3": "conv2d_same"}
SCALAR_MAX_ITERS = 4096       # at card sizes; a longer loop times the host
CARD_ROWS = 1 << 21           # (rows, 128) fp32: 1 GiB, past the 50 MB L2
# Qsim (qubits, depth): the JAX figure's size, then 1 GiB a plane
QSIM_SIZES = ((16, 6), (28, 2))
PEAK_LIMIT_GIB = 40.0         # the Qsim path's device memory
# the train path: full-width qwen3-1.7b through the flash kernel
TRAIN_ARCH = "qwen3-1.7b"
TRAIN_SHAPES = ((8, 128), (1, 4096))    # (batch, seq): the JAX launcher's
# defaults, then qwen3's long context
TRAIN_CKPT = os.path.join(ROOT, "checkpoints", "chip_smoke_train")
# the loss at steps 0 and 5 of B8 x S128 with the forward on the CUDA cores
# (fp32 FMAs), which every run repeated bit for bit; the tensor-core forward
# sums in another order and must stay within TRAIN_LOSS_RTOL of it
TRAIN_LOSS_BEFORE = (12.5657, 11.3390)
TRAIN_LOSS_RTOL = 2e-3
# the ssm serving path: full-width mamba2-780m
SSM_ARCH = "mamba2-780m"
SSM_STATIC = dict(slots=8, prompt_len=2048, gen_len=32)
# the continuous engine's requests (its prefill runs token by token) and
# the recurrence check's prompt: cut from 16 and 2048 (then 1024, for
# phase 6l's time) to keep the script near its time budget
SSM_MIX_REQUESTS = 8
# 6b (b)'s continuous engine: cut from 48 layers for the script's time
# (its forwards are the host's: ~450 ms each at 48 layers)
SSM_MIX_LAYERS = 16
SSM_RECURRENCE_LEN = 512
# the int8 serving path: full-width granite-3-2b, weight-only int8
INT8_ARCH = "granite-3-2b"
INT8_STATIC = dict(slots=8, prompt_len=512, gen_len=32)
# the dense-cache decode: full-width qwen3-1.7b at long prompts
DENSE_ARCH = "qwen3-1.7b"
DENSE_STATIC = dict(slots=8, prompt_len=2048, gen_len=32)
# the moe family: phi3.5-moe-42b at full width in int8 (6e); grok-1-314b
# at full width, cut to GROK_LAYERS of its 64 layers, in int8 (6f); and
# the dense phi3-medium-14b at full width in bf16 (6g)
MOE_ARCH = "phi3.5-moe-42b-a6.6b"
GROK_ARCH = "grok-1-314b"
GROK_LAYERS = 4
PHI3M_ARCH = "phi3-medium-14b"
MOE_STATIC = dict(slots=8, prompt_len=512, gen_len=32)
# phi3.5-moe's d_model and expert d_ff; an expert's rows at its static
# prefill: 8 groups x capacity ceil(2 x 512 / 16 x 1.25) = 80
MOE_D, MOE_FF, MOE_ROWS = 4096, 6400, 640
# phase 6's request mix (8 slots, 16 requests of 32-256 prompt tokens, 32
# new, max_len 512, page 16, chunk 32), and grok-1's 8 of them
MIX = dict(n_slots=8, max_len=512, page_size=16, prefill_chunk=32)
MIX_NEW = 32
# phases 6k's and 6l's granite-3-2b, cut from 40 layers for the script's
# time budget (host-bound steps; 6l's open-loop runs are paced by them,
# and phase 6m shares the budget)
OPEN_LOOP_LAYERS = 5
# the hybrid family: jamba-v0.1-52b at full width in int8 (6h), static at
# MOE_STATIC and 8 requests drawn as phase 6's; its expert d_ff, its
# mamba projections' widths (B and C: d_state 16; dt: 128 heads) and the
# bounds its int8 tree and the peak after its init must stay under
HYBRID_ARCH = "jamba-v0.1-52b"
HYBRID_FF = 14336
HYBRID_MAMBA_N = (16, 128)
HYBRID_INT8_MAX_GB = 53.0
HYBRID_INIT_PEAK_MAX_GB = 70.0
# (c)'s prompts: 8 of this length through both engines, this many new
HYBRID_SHARE = dict(prompt_len=64, gen_len=16)
# (b)-(d)'s model: 2 of the 4 periods, cut for the script's time ((a)
# keeps all 32 layers)
HYBRID_MIX_LAYERS = 16
# the cross-attention families: llama-3.2-vision-90b at full width in
# int8, cut to VLM_LAYERS of its 100 layers (6i; the continuous run's
# gate_attn set to VLM_GATE), static at MOE_STATIC and 8 requests drawn as
# phase 6's; whisper-base whole in bf16 (6j), static at AUDIO_STATIC and
# 16 requests at phase 6's mix.  The bounds 6i's int8 tree and its peak
# after init must stay under
VLM_ARCH = "llama-3.2-vision-90b"
VLM_LAYERS = 10
VLM_GATE = 1.0
VLM_INT8_MAX_GB = 11.5
# its d_model, d_ff, padded vocabulary, image tokens and K/V width
VLM_D, VLM_FF, VLM_V, VLM_IMAGE, VLM_KV = 8192, 28672, 128256, 1601, 1024
VLM_INIT_PEAK_MAX_GB = 20.0
AUDIO_ARCH = "whisper-base"
AUDIO_STATIC = dict(slots=8, prompt_len=128, gen_len=64)
# phase 7b: the train stack's other families and options; whisper-base's
# (batch, seq) over its 1500 frames, the checkpoint of mamba2-780m's run
AUDIO_TRAIN = (8, 128)
TRAIN_SSM_CKPT = os.path.join(ROOT, "checkpoints", "chip_smoke_train_ssm")
# 7b (c): step 0's gradient against remat full's, leaf by leaf (relative
# error), where it is the same computation (the remat modes; int8_ef
# before its round trip), and the slack on the int8_ef bounds; fused_xent
# (the table's gradient summed in another order and precision): its bf16
# grad_norm, then its fp32 gradient against the plain loss's leaf by leaf
GRAD_RTOL = 1e-3
FUSED_NORM_RTOL = 2e-2
FUSED_FP32_RTOL = 1e-3


def reset_launches(names):
    for name in names:
        for w in WRAPPERS[name]:
            w.launches = 0


def launches_of(name) -> int:
    return sum(w.launches for w in WRAPPERS[name])


def require_launched(names, what):
    """Exit unless every wrapper of every kernel named launched."""
    idle = [w.__name__ for name in names for w in WRAPPERS[name]
            if w.launches == 0]
    if idle:
        raise SystemExit(f"{what}: no launch of {', '.join(idle)}")


def log(phase, msg):
    print(f"[{phase}] {msg}", flush=True)


def time_three(fns):
    """Median device ms of kernel, plain and (where there is one) library
    over 30 rounds, timed interleaved by repro_torch.perf.measure with the
    L2 flushed before each call.  The plain version issues many ops, so
    its spin cover is longer."""
    ms = measure_group(fns, reps=30, flush_l2=True,
                       cover_ms={"kernel": 2.0, "plain": 20.0,
                                 "library": 2.0})
    return {name: m.median_s * 1e3 for name, m in ms.items()}


def _ms(x):
    return "—" if x is None else f"{x:.4f}"


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
    """nvcc for each kernel source, all started together."""
    t0 = datetime.datetime.now()
    loaders = list(dict.fromkeys(k[0] for k in KERNELS.values()))
    with concurrent.futures.ThreadPoolExecutor(len(loaders)) as pool:
        for fut in [pool.submit(load) for load in loaders]:
            fut.result()
    secs = (datetime.datetime.now() - t0).total_seconds()
    log("build", f"{len(loaders)} libraries ({', '.join(WRAPPERS)}) built "
                 f"and loaded in {secs:.1f} s")


# the matrix or copy instructions a library's SASS must hold: (library
# name, its sources, a pattern one of its opcodes must match)
SASS_REQUIRED = (("flash_attention", fa_kernel.SOURCES, r"H?G?MMA\..*"),
                 ("gemm", gemm_kernel.SOURCES, r"DMMA\..*"),
                 ("ssd_scan", ssd_kernel.SOURCES, r"HMMA\..*TF32.*"),
                 ("spmv", spmv_kernel.SOURCES, r"(?:UBLKCP|LDGSTS)\..*"))


def phase_sass():
    """Counts of the matrix instructions (HMMA, HGMMA, DMMA) in the SASS of
    the flash-attention, GEMM and SSD libraries and of the copy
    instructions (UBLKCP, LDGSTS) in the SpMV library, by cuobjdump;
    exits unless each holds its opcode."""
    for name, sources, need in SASS_REQUIRED:
        sass = subprocess.run(
            [cuda_tool("cuobjdump"), "-sass",
             str(library_path(name, sources))],
            capture_output=True, text=True, check=True).stdout
        counts = collections.Counter(
            re.findall(r"\b((?:HMMA|HGMMA|DMMA|UBLKCP|LDGSTS)[.\w]*)", sass))
        log("sass", f"{name}: " + (", ".join(
            f"{op} x{n}" for op, n in sorted(counts.items())) or "none"))
        if not any(re.fullmatch(need, op) for op in counts):
            raise SystemExit(f"{name}: no opcode matching {need} in the "
                             f"SASS")


# ---------------------------------------------------------------------------
# phase 3: kernel vs plain
# ---------------------------------------------------------------------------
def make_case(*, B, NKV, G, H, page, max_len, sq, valid, permuted, seed,
              dev, dtype=torch.bfloat16, fed=None):
    """``valid``: each row's kv_valid, its queries ending there; with
    ``fed`` (the verify forward of speculative decoding), each row's
    position before the step, its Sq queries at ``valid + c`` and its
    kv_valid ``valid + fed`` (the columns past ``fed`` are discarded by
    the engine, and must come out finite)."""
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
    if fed is not None:
        pos0 = kv_valid
        kv_valid = kv_valid + torch.tensor(fed, dtype=torch.int32,
                                           device=dev)
    qg = q.view(B, sq, NKV, G, H).permute(0, 2, 3, 1, 4)
    qg = qg.reshape(B, NKV, G * sq, H).contiguous()
    return dict(q=q, qg=qg, kp=kp, vp=vp, page_idx=page_idx, pos0=pos0,
                kv_valid=kv_valid, sq=sq)


def bound_ms(c, hw):
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
    s, by = hw.bound_s(flops, nbytes, torch.bfloat16)
    return s * 1e3, by


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


def _split_plan(c):
    """The KV split the wrapper launches for a case (kernel.split_plan)."""
    B, NKV, R, H = c["qg"].shape
    p = pa_kernel.split_plan(
        B, NKV, R, c["page_idx"].shape[1] * c["kp"].shape[1],
        torch.cuda.get_device_properties(0).multi_processor_count,
        head_dim=H, kv_bytes=c["kp"].element_size())
    return (f"plan: {p.splits} splits x {p.tokens_per_split} tokens, grid "
            f"{p.grid}, mode (KV warps, rows a warp) {p.mode}")


SWEEP_SPLITS = (1, 2, 3, 4, 8)
SOFTCAP, SOFTCAP_Q_SCALE = 30.0, 30.0
# the verify forward (spec_k 4): 5 columns, each row's fed width (0: an
# idle slot, 1: no draft, 3, 5: drafts) and its position before the step
VERIFY_SQ = 5
VERIFY_FED = (0, 1, 3, 5, 5, 3, 1, 0)
VERIFY_BEFORE = (64, 97, 150, 203, 256, 288, 300, 0)


def check_partials(name, args, sq, softcap):
    """The kernel's partials against the plain version's on the same card
    inputs (acc, l everywhere, m where a row has a valid key, all finite)
    and the normalized outputs, within TOL; returns the outputs' max abs
    error."""
    got = pa_kernel.paged_flash_decode(*args, sq=sq, softcap=softcap)
    want = pa_ref.paged_partials(*args, sq=sq, softcap=softcap)
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
    return float((out_k - out_p).abs().max())


def split_sweep(args, sq):
    """The kernel's median ms at each forced split count, timed
    interleaved (as time_three)."""
    fns = {f"s{n}": (lambda n=n: pa_kernel.paged_flash_decode(
        *args, sq=sq, splits=n)) for n in SWEEP_SPLITS}
    ms = measure_group(fns, reps=30, flush_l2=True, cover_ms=2.0)
    return " ".join(f"{k} {m.median_s * 1e3:.4f}" for k, m in ms.items())


def phase_kernel(card, hw):
    dev = torch.device("cuda")
    base = [0, 1, 16, 37, 256, 511, 777, 1024]       # ragged, 8 slots
    # (arch, NKV, G, H): the served configs' head groups; phi3-medium's 10
    # KV heads (B x NKV = 80, not a power of two), grok-1's G 6, whisper's
    # G 1 (MHA) and llama-3.2-vision's G 8
    shapes = [("granite", 8, 4, 64), ("qwen3", 8, 2, 128),
              ("phi3-medium", 10, 4, 128), ("grok-1", 8, 6, 128),
              ("whisper", 8, 1, 64), ("llama-vision", 8, 8, 128)]
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
    # the verify forward of speculative decoding (6k (b): spec_k 4, 8
    # slots, max_len 512): Sq 5, each row fed 0, 1, 3 or 5 tokens after
    # its position; granite's and qwen3's heads, bf16 and fp32 K/V (the
    # granite bf16 case timed)
    for arch, NKV, G, H in (("granite", 8, 4, 64), ("qwen3", 8, 2, 128)):
        for dtype in (torch.bfloat16, torch.float32):
            cases.append((f"verify {arch} H{H} Sq{VERIFY_SQ} ragged "
                          f"n_valid {list(VERIFY_FED)} "
                          f"{str(dtype)[6:]} identity max_len512",
                          dict(B=8, NKV=NKV, G=G, H=H, page=16, max_len=512,
                               sq=VERIFY_SQ, valid=VERIFY_BEFORE,
                               fed=VERIFY_FED, permuted=False, dtype=dtype)))
    worst, worst_cap, main = 0.0, 0.0, None
    for i, (name, kw) in enumerate(cases):
        c = make_case(**kw, seed=i, dev=dev)
        args = (c["qg"], c["kp"], c["vp"], c["page_idx"], c["pos0"],
                c["kv_valid"])
        err = check_partials(name, args, c["sq"], 0.0)
        worst = max(worst, err)
        # softcap 30 over queries scaled by 30: scores of ~30, where the
        # cap moves the output (at ~1 it would be within TOL of no cap)
        cap_args = (c["qg"] * SOFTCAP_Q_SCALE, *args[1:])
        worst_cap = max(worst_cap, check_partials(
            f"{name} softcap {SOFTCAP:g}", cap_args, c["sq"], SOFTCAP))
        if name.startswith("verify") and not (
                name.startswith("verify granite") and "bfloat16" in name):
            log("kernel", f"{name}: ok max_abs_err {err:.2e} (checked, "
                          f"not timed) | {_split_plan(c)} | {card}")
            continue
        t = time_three({
            "kernel": lambda: pa_kernel.paged_flash_decode(*args,
                                                           sq=c["sq"]),
            "plain": lambda: pa_ref.paged_partials(*args, sq=c["sq"]),
            "library": library_fn(c)})
        k_ms, p_ms, l_ms = t["kernel"], t["plain"], t["library"]
        b_ms, b_by = bound_ms(c, hw)
        log("kernel", f"{name}: ok max_abs_err {err:.2e} | kernel_ms "
                      f"{k_ms:.4f} plain_ms {p_ms:.4f} library_ms "
                      f"{l_ms:.4f} bound_ms {b_ms:.4f} ({b_by}) | "
                      f"{_split_plan(c)} | {card}")
        if not kw["permuted"]:
            log("kernel", f"{name}: kernel_ms at forced splits "
                          f"{split_sweep(args, c['sq'])} | {card}")
        if name.startswith("main-path"):
            main = dict(ms=k_ms, plain_ms=p_ms, library_ms=l_ms,
                        bound_ms=b_ms, bound_by=b_by)
    log("kernel", f"paged_partials: {len(cases)} cases ok at softcap 0 "
                  f"(max abs err {worst:.2e}) and {SOFTCAP:g} (queries x "
                  f"{SOFTCAP_Q_SCALE:g}, max abs err {worst_cap:.2e})")
    return max(worst, worst_cap), main


# ---------------------------------------------------------------------------
# phase 4: the veceval kernels vs plain
# ---------------------------------------------------------------------------
def check(what, got, want, rtol, atol, scale=None):
    """Max |got - want|; exits unless every element is finite and within
    atol + rtol * scale (scale: |want| unless given)."""
    torch.cuda.synchronize()
    if got.shape != want.shape or not bool(torch.isfinite(got).all()):
        raise SystemExit(f"{what}: shape {tuple(got.shape)} vs "
                         f"{tuple(want.shape)} or non-finite output")
    err = (got.double() - want.double()).abs()
    lim = atol + rtol * (want.double().abs() if scale is None
                         else scale.double())
    if not bool((err <= lim).all()):
        raise SystemExit(f"{what}: {int((err > lim).sum())} elements past "
                         f"rtol {rtol} atol {atol}, max abs err "
                         f"{float(err.max()):.3e}")
    return float(err.max()) if err.numel() else 0.0


def timed_record(what, fns, flops, nbytes, dtype, hw, card, err,
                 phase="kernels-veceval"):
    t = time_three(fns)
    s, by = hw.bound_s(flops, nbytes, dtype)
    rec = dict(max_abs_err=err, ms=t["kernel"], plain_ms=t["plain"],
               library_ms=t.get("library"), bound_ms=s * 1e3, bound_by=by)
    log(phase,
        f"{what}: kernel_ms {rec['ms']:.4f} plain_ms {rec['plain_ms']:.4f} "
        f"library_ms {_ms(rec['library_ms'])} bound_ms "
        f"{rec['bound_ms']:.4f} ({by}) | {card}")
    return rec


def kernels_stream(g, hw, card):
    dev = torch.device("cuda")
    worst = 0.0
    for shape in [(1001, 127), (37, 128)]:          # ragged: a scalar tail
        x = torch.randn(shape, generator=g, device=dev)
        y = torch.randn(shape, generator=g, device=dev)
        for kind in stream_kernel.KINDS:
            for alpha in (2.0, 0.3):
                for m in (1, 2, 4, 8):
                    got = stream_kernel.stream_call(kind, x, y, alpha,
                                                    block_multiplier=m)
                    worst = max(worst, check(
                        f"stream {kind} {shape} alpha {alpha} m{m}", got,
                        stream_ref.stream(kind, x, y, alpha), 1e-6, 0.0))
    for rows in (1 << 14, 1 << 19):                 # default, card
        x = torch.rand((rows, 128), generator=g, device=dev)
        y = torch.rand((rows, 128), generator=g, device=dev)
        worst = max(worst, check(
            f"stream triad ({rows}, 128)",
            stream_kernel.stream_call("triad", x, y, 2.0),
            stream_ref.stream_triad(x, y, 2.0), 1e-6, 0.0))
    n = x.numel()
    log("kernels-veceval", f"stream: all kinds ok, max abs err {worst:.2e}")
    return timed_record(
        f"stream triad n=2^{n.bit_length() - 1} fp32", {
            "kernel": lambda: stream_kernel.stream_call("triad", x, y, 2.0),
            "plain": lambda: stream_ref.stream_triad(x, y, 2.0),
            "library": lambda: torch.add(x, y, alpha=2.0)},
        2.0 * n, 12.0 * n, torch.float32, hw, card, worst)


def _ell(R, C, K, g, dev):
    vals = torch.randn((R, K), generator=g, device=dev)
    cols = torch.randint(0, C, (R, K), generator=g, device=dev,
                         dtype=torch.int32)
    x = torch.rand((C,), generator=g, device=dev)
    return vals, cols, x


def _check_spmv(what, vals, cols, x, m=1, path=None):
    """The take kernel against the plain version over the in-range
    nonzeros (a column outside [0, C) adds nothing), each row within 1e-6
    of its sum of |terms|."""
    got = spmv_kernel.spmv_ell(vals, cols, x, block_multiplier=m, path=path)
    C = x.shape[0]
    inside = (cols >= 0) & (cols < C)
    kept, at = vals * inside, cols.clamp(0, C - 1)
    scale = (kept * x[at]).abs().sum(-1, keepdim=True)
    return check(what, got, spmv_ref.spmv_ell(kept, at, x), 1e-6, 0.0,
                 scale)


def _spmv_paths(vals, cols, m):
    """The paths a take check forces: both where the vector path applies
    (K a multiple of 4, aligned operands, a ring that fits), else the
    general one."""
    R, K = vals.shape
    try:
        spmv_kernel.take_plan(R, K, m, sm_count(0), vals.data_ptr() % 16 == 0
                              and cols.data_ptr() % 16 == 0, "vector")
    except ValueError:
        return ("general",)
    return ("vector", "general")


# the window probes: random columns within the first 2^14 (x's 64 KB stays
# in L1) and within the first 2^20 (4 MB: in L2, not L1)
SPMV_WINDOWS = (1 << 14, 1 << 20)


def kernels_spmv(g, hw, card):
    """The take kernel on both paths (each forced where the vector path
    applies), every block multiplier: 1000 x 777 at K 1 to 64 with columns
    at -1 and at C, a view one float past a 16-byte boundary (the plan's
    general path), 2^14 and 2^22 rows x 16.  Timed at 2^22 x 16 against C
    2^22, L2 flushed: both paths at every block multiplier beside the
    plain version and cuSPARSE in one group; then the probes, each path
    on the same bytes with other columns (unit-stride, and random within
    each of SPMV_WINDOWS); then both paths at the JAX size.  Returns the
    record of the plan's path at block multiplier 1 (veceval's)."""
    dev = torch.device("cuda")
    worst = 0.0
    for K in (1, 4, 5, 13, 16, 32, 33, 64):         # ragged rows and nnz
        vals, cols, x = _ell(1000, 777, K, g, dev)
        cols[::7, 0] = -1                           # add nothing
        cols[3::7, -1] = 777
        for m in (1, 2, 4, 8):
            for path in _spmv_paths(vals, cols, m):
                worst = max(worst, _check_spmv(
                    f"spmv 1000x777 nnz {K} m{m} {path}", vals, cols, x, m,
                    path))
    view = torch.empty(vals.numel() + 1, device=dev)[1:].view(vals.shape)
    view.copy_(vals)
    if _spmv_paths(view, cols, 1) != ("general",):
        raise SystemExit("spmv: a misaligned view must take the general "
                         "path")
    for m in (1, 2, 4, 8):
        worst = max(worst, _check_spmv(f"spmv misaligned view nnz "
                                       f"{vals.shape[1]} m{m}", view, cols,
                                       x, m))
    for R in (1 << 14, 1 << 22):                    # default, card
        vals, cols, x = _ell(R, R, 16, g, dev)
        for m in (1, 2, 4, 8):
            for path in _spmv_paths(vals, cols, m):
                worst = max(worst, _check_spmv(
                    f"spmv {R} nnz 16 m{m} {path}", vals, cols, x, m, path))
    log("kernels-veceval", f"spmv: ok on both paths, max abs err "
                           f"{worst:.2e}")
    # cuSPARSE through a CSR tensor built beforehand (columns sorted per row)
    R, K = vals.shape
    cs, perm = cols.sort(dim=1)
    with warnings.catch_warnings():                 # "beta" notices
        warnings.simplefilter("ignore", UserWarning)
        csr = torch.sparse_csr_tensor(
            torch.arange(0, R * K + 1, K, dtype=torch.int32, device=dev),
            cs.reshape(-1).contiguous(), vals.gather(1, perm).reshape(-1),
            size=(R, R), check_invariants=False)
    check("spmv cuSPARSE yardstick", torch.mv(csr, x)[:, None],
          spmv_ref.spmv_ell(vals, cols, x), 1e-5, 1e-5)
    flops, nbytes = 2.0 * R * K, R * K * 8.0 + R * 4.0 + R * 4.0
    plan_path = spmv_kernel.take_plan(R, K, 1, sm_count(0), True).path

    def take(c, m, path):
        return lambda: spmv_kernel.spmv_ell(vals, c, x, block_multiplier=m,
                                            path=path)

    fns = {"kernel": take(cols, 1, None),
           "plain": lambda: spmv_ref.spmv_ell(vals, cols, x),
           "library": lambda: torch.mv(csr, x),
           "general m1": take(cols, 1, "general")}
    for m in (2, 4, 8):
        for path in _spmv_paths(vals, cols, m):
            fns[f"{path} m{m}"] = take(cols, m, path)
    ms = {k: v.median_s * 1e3 for k, v in measure_group(
        fns, reps=30, flush_l2=True,
        cover_ms={k: 20.0 if k == "plain" else 2.0 for k in fns}).items()}
    bound_s, bound_by = hw.bound_s(flops, nbytes, torch.float32)
    bound = bound_s * 1e3
    log("kernels-veceval", f"spmv rows=cols=2^22 nnz 16 random columns, "
        f"bound {bound:.4f} ms: " + ", ".join(
            f"{k} {v:.4f} ({100 * bound / v:.1f}%)" for k, v in ms.items())
        + f" | {card}")
    # the costs apart: the same kernel and bytes with unit-stride columns,
    # cols[r, k] = (16 r + k) mod C (the DRAM stream), and random within a
    # window of x (the gather from L1, then from L2)
    probes = {"unit-stride": (torch.arange(R * K, device=dev) % R).to(
        torch.int32).view(R, K)}
    for w in SPMV_WINDOWS:
        probes[f"window 2^{w.bit_length() - 1}"] = torch.randint(
            0, w, (R, K), generator=g, device=dev, dtype=torch.int32)
    fns = {}
    for name, c in probes.items():
        worst = max(worst, _check_spmv(f"spmv probe {name}", vals, c, x))
        for m in (1, 2, 4, 8):
            for path in _spmv_paths(vals, cols, m):
                fns[f"{name} {path} m{m}"] = take(c, m, path)
    probe_ms = measure_group(fns, reps=30, flush_l2=True, cover_ms=2.0)
    for name in probes:
        log("kernels-veceval", f"spmv probe {name} (same bytes, bound "
            f"{bound:.4f} ms): " + ", ".join(
                f"{k[len(name) + 1:]} {v.median_s * 1e3:.4f}"
                for k, v in probe_ms.items() if k.startswith(name + " "))
            + f" | {card}")
    vs, cs_, xs = _ell(1 << 14, 1 << 14, 16, g, dev)
    small_path = spmv_kernel.take_plan(1 << 14, 16, 1, sm_count(0),
                                       True).path
    fns = {f"plan ({small_path}) m1": lambda: spmv_kernel.spmv_ell(vs, cs_,
                                                                   xs)}
    for m in (1, 2, 4, 8):
        fns[f"vector m{m}"] = (lambda m=m: spmv_kernel.spmv_ell(
            vs, cs_, xs, block_multiplier=m, path="vector"))
    small = measure_group(fns, reps=100, flush_l2=True, cover_ms=2.0)
    log("kernels-veceval", "spmv JAX size 2^14 x 16, C 2^14: " + ", ".join(
        f"{k} {v.median_s * 1e3:.4f}" for k, v in small.items())
        + f" | {card}")
    rec = dict(max_abs_err=worst, ms=ms["kernel"], plain_ms=ms["plain"],
               library_ms=ms["library"], bound_ms=bound, bound_by=bound_by)
    log("kernels-veceval",
        f"spmv rows=cols=2^22 nnz 16 fp32 ({plan_path} path): kernel_ms "
        f"{rec['ms']:.4f} plain_ms {rec['plain_ms']:.4f} library_ms "
        f"{rec['library_ms']:.4f} bound_ms {bound:.4f} ({bound_by}) | "
        f"{card}")
    return rec


def kernels_spmv_onehot(g, hw, card):
    """The one-hot idiom against its plain version: test_kernels_fused.py's
    shapes, ragged rows and nonzeros, columns at -1 and at C (they
    contribute 0, checked also against the take idiom over the in-range
    nonzeros); rtol 1e-5 of the row's sum of |terms| (fp32 sums of up to
    33 terms in another order).  Timed at the JAX veceval size (2^14 rows
    x 16, C 2^14), where the idiom does 2^32 compare-selects; the card
    size (2^22 x 16 against C 2^22, 2.8e14 of them) is left out."""
    dev = torch.device("cuda")
    worst = 0.0
    for R, C, K in ((64, 256, 16), (128, 512, 8), (1000, 777, 13),
                    (37, 50, 33), (9, 512, 1)):
        vals, cols, x = _ell(R, C, K, g, dev)
        cols[::5, 0] = -1
        cols[2::5, -1] = C
        got = spmv_kernel.spmv_ell_onehot(vals, cols, x)
        inside = (cols >= 0) & (cols < C)
        scale = (vals.abs() * inside).sum(-1, keepdim=True) * x.abs().max()
        worst = max(worst, check(
            f"spmv onehot {R}x{C} nnz {K}", got,
            spmv_ref.spmv_ell_onehot(vals, cols, x), 1e-5, 0.0, scale))
        check(f"spmv onehot {R}x{C} nnz {K} vs take over in-range columns",
              got, spmv_ref.spmv_ell(vals * inside, cols.clamp(0, C - 1), x),
              1e-5, 0.0, scale)
    R = C = 1 << 14
    K = 16
    vals, cols, x = _ell(R, C, K, g, dev)
    scale = (vals * x[cols]).abs().sum(-1, keepdim=True)
    worst = max(worst, check(f"spmv onehot {R} nnz {K}",
                             spmv_kernel.spmv_ell_onehot(vals, cols, x),
                             spmv_ref.spmv_ell_onehot(vals, cols, x), 1e-5,
                             0.0, scale))
    log("kernels-veceval", f"spmv onehot: ok, max abs err {worst:.2e}; "
                           f"{R * K * C:.3e} compare-selects at {R} x {K} "
                           f"against C {C}")
    cs, perm = cols.sort(dim=1)
    with warnings.catch_warnings():                 # "beta" notices
        warnings.simplefilter("ignore", UserWarning)
        csr = torch.sparse_csr_tensor(
            torch.arange(0, R * K + 1, K, dtype=torch.int32, device=dev),
            cs.reshape(-1).contiguous(), vals.gather(1, perm).reshape(-1),
            size=(R, C), check_invariants=False)
    check("spmv onehot cuSPARSE yardstick", torch.mv(csr, x)[:, None],
          spmv_ref.spmv_ell(vals, cols, x), 1e-5, 1e-5)
    rec = timed_record(
        f"spmv onehot rows=C=2^14 nnz 16 fp32 ({R * K * C} compare-selects)",
        {"kernel": lambda: spmv_kernel.spmv_ell_onehot(vals, cols, x),
         "plain": lambda: spmv_ref.spmv_ell_onehot(vals, cols, x),
         "library": lambda: torch.mv(csr, x)},
        2.0 * R * K, R * K * 8.0 + C * 4.0 + R * 4.0, torch.float32, hw,
        card, worst)
    # the idiom's own bound: one issue slot a compare-select, 128 slots a
    # clock an SM, at the card's highest SM clock
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    mhz = float(subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm",
         "--format=csv,noheader,nounits"], capture_output=True, text=True,
        check=True).stdout.split()[0])
    issue_ms = R * K * C / (128.0 * sms * mhz * 1e6) * 1e3
    log("kernels-veceval",
        f"spmv onehot: {R * K * C / (rec['ms'] * 1e-3) / 1e12:.2f} T "
        f"compare-selects/s; issue bound {issue_ms:.4f} ms (one slot each, "
        f"128 a clock, {sms} SMs, {mhz:.0f} MHz), bytes bound "
        f"{rec['bound_ms']:.4f} ms; kernel {rec['ms'] / issue_ms:.2f}x the "
        f"issue bound | {card}")
    return rec


def kernels_gemm(g, hw, card):
    """Every block multiplier in both dtypes against ref.gemm (ragged M, N
    and K, then 512^3 and 4096^3), each timed at 4096^3 (Fig 7's LMUL axis
    on the card).  Returns the record of fp32 m2, veceval's sgemm."""
    dev = torch.device("cuda")
    tol = {torch.float32: 1e-4, torch.float64: 1e-12}
    worst = 0.0
    for dtype in (torch.float32, torch.float64):    # ragged M, N and K
        a = torch.randn((1000, 515), generator=g, device=dev, dtype=dtype)
        b = torch.randn((515, 777), generator=g, device=dev, dtype=dtype)
        want = gemm_ref.gemm(a, b)
        for m in (1, 2, 4, 8):
            worst = max(worst, check(
                f"gemm 1000x515x777 {dtype} m{m}",
                gemm_kernel.gemm(a, b, block_multiplier=m), want, tol[dtype],
                tol[dtype]))
    recs = {}
    for dtype in (torch.float32, torch.float64):
        for n in (512, 4096):                       # default, card
            a = torch.rand((n, n), generator=g, device=dev, dtype=dtype)
            b = torch.rand((n, n), generator=g, device=dev, dtype=dtype)
            want = gemm_ref.gemm(a, b)
            for m in (1, 2, 4, 8):
                worst = max(worst, check(
                    f"gemm {n}^3 {dtype} m{m}",
                    gemm_kernel.gemm(a, b, block_multiplier=m), want,
                    tol[dtype], tol[dtype]))
        for m in (1, 2, 4, 8):
            plan = gemm_kernel.plan(n, n, n, dtype, m)
            recs[dtype, m] = timed_record(
                f"gemm 4096^3 m{m} {dtype} ({plan.path}, tile "
                f"{plan.tile[0]}x{plan.tile[1]})", {
                    "kernel": lambda: gemm_kernel.gemm(a, b,
                                                       block_multiplier=m),
                    "plain": lambda: gemm_ref.gemm(a, b),
                    "library": lambda: torch.matmul(a, b)},
                2.0 * n ** 3, 3.0 * n * n * a.element_size(), dtype, hw,
                card, None)
        del a, b, want
    log("kernels-veceval", f"gemm: ok, max abs err {worst:.2e}")
    rec = recs[torch.float32, 2]                    # the JSON line: sgemm
    rec["max_abs_err"] = worst
    return rec


def _conv_plan(x, w):
    """The tile the wrapper launches for x, w (conv2d.kernel.plan)."""
    N, H, W, Cin = x.shape
    kh, kw, _, Cout = w.shape
    p = conv_kernel.plan(
        N, H, W, Cin, Cout, kh, kw,
        torch.cuda.get_device_properties(0).multi_processor_count)
    return (f"plan: {conv_kernel.TILE_H}x{conv_kernel.TILE_W} pixels x "
            f"{p.bn} channels a block ({p.tc} a "
            f"thread, {p.threads} threads), kw template {p.kw_max}, grid "
            f"{p.grid}, smem {p.smem} B")


def kernels_conv2d(g, hw, card):
    dev = torch.device("cuda")
    worst = 0.0
    for k in (1, 2, 3, 5, 7):                       # ragged W, Cin, Cout
        x = torch.randn((2, 24, 37, 5), generator=g, device=dev)
        w = torch.randn((k, k, 5, 33), generator=g, device=dev) * 0.1
        want = conv_ref.conv2d_same(x, w)
        for bh in (4, 8, 12, 24):
            worst = max(worst, check(
                f"conv2d 2x24x37x5->33 k{k} block_h {bh}",
                conv_kernel.conv2d_same(x, w, bh=bh), want, 1e-4, 1e-4))
    for hw_side in (32, 224):                       # default, card
        for specs in (veceval.ALEXNET_SPECS, veceval.YOLOV3_SPECS):
            cin = 16
            for k, cout in specs:
                x = torch.rand((1, hw_side, hw_side, cin), generator=g,
                               device=dev)
                w = torch.rand((k, k, cin, cout), generator=g,
                               device=dev) * 0.1
                worst = max(worst, check(
                    f"conv2d {hw_side}^2 {cin}->{cout} k{k}",
                    conv_kernel.conv2d_same(x, w, bh=8),
                    conv_ref.conv2d_same(x, w), 1e-4, 1e-4))
                if hw_side == 224:
                    log("kernels-veceval", f"conv2d 224^2 {cin}->{cout} "
                                           f"k{k}: {_conv_plan(x, w)}")
                cin = cout
    log("kernels-veceval", f"conv2d: ok, max abs err {worst:.2e}")
    # a yolov3 layer at the card size: 224^2, 8 -> 32, 3x3
    x = torch.rand((1, 224, 224, 8), generator=g, device=dev)
    w = torch.rand((3, 3, 8, 32), generator=g, device=dev) * 0.1
    xn, wn = x.permute(0, 3, 1, 2), w.permute(3, 2, 0, 1)
    err = check("conv2d 224^2 8->32 3x3", conv_kernel.conv2d_same(x, w, bh=8),
                conv_ref.conv2d_same(x, w), 1e-4, 1e-4)
    worst = max(worst, err)
    timed_record(
        "conv2d 224^2 8->32 3x3 fp32 (yolov3)", {
            "kernel": lambda: conv_kernel.conv2d_same(x, w, bh=8),
            "plain": lambda: conv_ref.conv2d_same(x, w),
            "library": lambda: F.conv2d(xn, wn, padding=1)},
        2.0 * 224 * 224 * 9 * 8 * 32,
        4.0 * (x.numel() + w.numel() + 224 * 224 * 32), torch.float32, hw,
        card, err)
    # the largest layer of the card-size AlexNet stack: 224^2, 64 -> 64, 3x3
    x = torch.rand((1, 224, 224, 64), generator=g, device=dev)
    w = torch.rand((3, 3, 64, 64), generator=g, device=dev) * 0.1
    xn, wn = x.permute(0, 3, 1, 2), w.permute(3, 2, 0, 1)
    check("conv2d F.conv2d yardstick", F.conv2d(xn, wn, padding=1)
          .permute(0, 2, 3, 1), conv_ref.conv2d_same(x, w), 1e-4, 1e-4)
    log("kernels-veceval", f"conv2d 224^2 64->64 3x3: {_conv_plan(x, w)}")
    return timed_record(
        "conv2d 224^2 64->64 3x3 fp32", {
            "kernel": lambda: conv_kernel.conv2d_same(x, w, bh=8),
            "plain": lambda: conv_ref.conv2d_same(x, w),
            "library": lambda: F.conv2d(xn, wn, padding=1)},
        2.0 * 224 * 224 * 9 * 64 * 64,
        4.0 * (x.numel() + w.numel() + x.numel()), torch.float32, hw, card,
        worst)


def phase_kernels_veceval(card, hw):
    g = torch.Generator(device="cuda").manual_seed(0)
    return {"stream": kernels_stream(g, hw, card),
            "spmv_ell": kernels_spmv(g, hw, card),
            "spmv_ell_onehot": kernels_spmv_onehot(g, hw, card),
            "gemm": kernels_gemm(g, hw, card),
            "conv2d_same": kernels_conv2d(g, hw, card)}


# ---------------------------------------------------------------------------
# phase 4, continued: the paper layer's kernels vs plain
# ---------------------------------------------------------------------------
def kernels_strided(g, hw, card):
    """Both idioms exact against the plain gather: ragged rows (remainders
    0, 1 and 7 for stride 8; stride not dividing rows), rows of 127 floats
    (the one-float path), every block multiplier; then the JAX size and
    the card size."""
    dev = torch.device("cuda")
    for rows in (1000, 1001, 1007):
        for cols in (128, 127):
            x = torch.randn((rows, cols), generator=g, device=dev)
            for s in (2, 3, 4, 8):
                check(f"strided_rowwise {rows}x{cols} s{s}",
                      strided_kernel.strided_rowwise(x, s),
                      strided_ref.strided_gather(x, s), 0.0, 0.0)
                for m in (1, 2, 4, 8):
                    check(f"overfetch_select {rows}x{cols} s{s} m{m}",
                          strided_kernel.overfetch_select(
                              x, s, block_multiplier=m),
                          strided_ref.strided_gather(x, s, rows // s),
                          0.0, 0.0)
    for rows in (fig2_strided.ROWS, CARD_ROWS):
        x = torch.rand((rows, 128), generator=g, device=dev)
        for s in fig2_strided.STRIDES:
            check(f"strided_rowwise ({rows}, 128) s{s}",
                  strided_kernel.strided_rowwise(x, s),
                  strided_ref.strided_gather(x, s), 0.0, 0.0)
            check(f"overfetch_select ({rows}, 128) s{s}",
                  strided_kernel.overfetch_select(x, s),
                  strided_ref.strided_gather(x, s, rows // s), 0.0, 0.0)
    log("kernels-paper", "strided: both idioms exact on every shape")
    for s in fig2_strided.STRIDES:
        t = measure_group({"kernel": lambda: strided_kernel.overfetch_select(
            x, s)}, reps=30, flush_l2=True, cover_ms=2.0)
        log("kernels-paper", f"overfetch_select ({rows}, 128) s{s}: "
                             f"kernel_ms {t['kernel'].median_s * 1e3:.4f} | "
                             f"{card}")
        rec = timed_record(
            f"strided_rowwise ({rows}, 128) s{s}", {
                "kernel": lambda: strided_kernel.strided_rowwise(x, s),
                "plain": lambda: strided_ref.strided_gather(x, s),
                "library": lambda: x[::s].contiguous()},
            0.0, 8.0 * (rows // s) * 128, torch.float32, hw, card, 0.0,
            "kernels-paper")
        if s == 2:
            kept = rec
    return kept


def kernels_tailmask(g, hw, card):
    """exact_tail and masked_full within rtol 1e-6 of F.silu(x) * 2:
    remainders of 0, 1 and 7 rows, tiles of 8 and 16 rows, n_valid from 0
    past the end; then the JAX size and the card size."""
    dev = torch.device("cuda")
    worst = 0.0
    for rows in (1000, 1001, 1007):
        for cols in (128, 127):
            x = torch.randn((rows, cols), generator=g, device=dev) * 4
            for br in (8, 16):
                worst = max(worst, check(
                    f"exact_tail {rows}x{cols} br{br}",
                    tail_kernel.exact_tail(x, block_rows=br),
                    tail_ref.compute(x), 1e-6, 0.0))
                xp = x[: rows // br * br]
                for nv in (0, 1, 4000, xp.numel() - 3, xp.numel() + 9):
                    worst = max(worst, check(
                        f"masked_full {tuple(xp.shape)} br{br} n_valid {nv}",
                        tail_kernel.masked_full(xp, nv, block_rows=br),
                        tail_ref.compute_masked(xp, nv), 1e-6, 0.0))
    for rows in (fig3_tail.ROWS, CARD_ROWS):
        x = torch.randn((rows, 128), generator=g, device=dev) * 4
        for r in (rows, rows - 7):
            worst = max(worst, check(
                f"exact_tail ({r}, 128)", tail_kernel.exact_tail(x[:r]),
                tail_ref.compute(x[:r]), 1e-6, 0.0))
        nv = int(rows * 0.9) * 128
        worst = max(worst, check(
            f"masked_full ({rows}, 128) n_valid {nv}",
            tail_kernel.masked_full(x, nv), tail_ref.compute_masked(x, nv),
            1e-6, 0.0))
    log("kernels-paper", f"tailmask: ok, max abs err {worst:.2e}")
    t = measure_group({"kernel": lambda: tail_kernel.masked_full(x, nv)},
                      reps=30, flush_l2=True, cover_ms=2.0)
    log("kernels-paper", f"masked_full ({rows}, 128) frac 0.9: kernel_ms "
                         f"{t['kernel'].median_s * 1e3:.4f} | {card}")
    # the library yardstick is two PyTorch calls (silu, then an in-place
    # multiply): no single call computes silu(x) * 2
    return timed_record(
        f"exact_tail ({rows}, 128)", {
            "kernel": lambda: tail_kernel.exact_tail(x),
            "plain": lambda: tail_ref.compute(x),
            "library": lambda: F.silu(x).mul_(2)},
        fig3_tail.FLOPS_PER_ELEM * x.numel(), 8.0 * x.numel(),
        torch.float32, hw, card, worst, "kernels-paper")


def _gate():
    return (gates.rx(0.83) @ gates.rz(2.1) @ gates.H).astype(np.complex64)


def kernels_qsim_gate(g, hw, card):
    """The gate kernel against the plain planar gate at qubits 0, 1, 4, 5,
    12 and n-1 of a random normalised state, at 16 qubits (the JAX size)
    and 28: within 1e-6 of max |amplitude|."""
    dev = torch.device("cuda")
    gate = _gate()
    coeffs = gate_ref.gate_coeffs(gate)
    worst = 0.0
    for n, _ in QSIM_SIZES:
        re = torch.randn((1 << n,), generator=g, device=dev)
        im = torch.randn((1 << n,), generator=g, device=dev)
        scale = float((re.double().square().sum()
                       + im.double().square().sum()).sqrt())
        re.div_(scale)
        im.div_(scale)
        amp = float(torch.maximum(re.abs().max(), im.abs().max()))
        for q in (0, 1, 4, 5, 12, n - 1):
            got = gate_kernel.apply_gate_planar(re, im, coeffs, q)
            want = gate_ref.apply_gate_planar(re, im, gate, q)
            for gp, wp, part in zip(got, want, ("re", "im")):
                worst = max(worst, check(f"qsim_gate {n}q q{q} {part}", gp,
                                         wp, 0.0, 1e-6 * amp))
            del got, want
    log("kernels-paper", f"qsim_gate: ok, max abs err {worst:.2e} "
                         f"(amplitudes up to {amp:.2e})")
    psi = torch.complex(re, im)
    G = torch.as_tensor(gate, device=dev)
    # (q = 0 would make torch.matmul expand the gate over 2^27 batches)
    for q in (14, n - 1):
        view = psi.view(-1, 2, 1 << q)
        lib = torch.matmul(G, view).reshape(-1)
        check(f"qsim_gate torch.matmul yardstick q{q}",
              torch.view_as_real(lib),
              torch.stack(gate_ref.apply_gate_planar(re, im, gate, q), -1),
              1e-6, 1e-6 * amp)
        del lib
        rec = timed_record(
            f"qsim_gate {n}q q{q}", {
                "kernel": lambda: gate_kernel.apply_gate_planar(re, im,
                                                                coeffs, q),
                "plain": lambda: gate_ref.apply_gate_planar(re, im, gate, q),
                "library": lambda: torch.matmul(G, view)},
            14.0 * (1 << n), 16.0 * (1 << n), torch.float32, hw, card, worst,
            "kernels-paper")
        if q == 14:
            kept = rec
    return kept


def phase_kernels_paper(card, hw):
    g = torch.Generator(device="cuda").manual_seed(1)
    names = ("strided", "tailmask", "qsim_gate")
    reset_launches(names)
    recs = {"strided": kernels_strided(g, hw, card),
            "tailmask": kernels_tailmask(g, hw, card),
            "qsim_gate": kernels_qsim_gate(g, hw, card)}
    log("kernels-paper", "launches in this phase (checks and timing): "
        + ", ".join(f"{w.__name__} {w.launches}" for name in names
                    for w in WRAPPERS[name]))
    torch.cuda.empty_cache()
    return recs


# ---------------------------------------------------------------------------
# phase 4, continued: the train path's flash-attention kernel vs plain
# ---------------------------------------------------------------------------
def _flash_cases():
    """(BN, S, G, H, softcap, causal, dtype).  First the two shapes the
    train phase gives the kernel (qwen3-1.7b, bf16, causal: BN = batch x
    8 KV heads, G 2, H 128, at batch 8 x seq 128 and batch 1 x seq 4096).
    Then every combination of the four lengths, three group sizes, both
    caps, both masks and both dtypes at H 64 and 128, and at H 32 (the
    reduced configs) for the short ones, over 3 KV heads (2 at S 4096)."""
    cfg = get_config(TRAIN_ARCH)
    for B, S in TRAIN_SHAPES:
        yield (B * cfg.n_kv_heads, S, cfg.n_heads // cfg.n_kv_heads,
               cfg.resolved_head_dim, cfg.attn_logit_softcap, True,
               torch.bfloat16)
    for S in (1, 63, 200, 4096):
        for H in ((32, 64, 128) if S < 4096 else (64, 128)):
            for G in (1, 2, 8):
                for softcap in (0.0, 30.0):
                    for causal in (True, False):
                        for dtype in (torch.float32, torch.bfloat16):
                            yield (2 if S == 4096 else 3, S, G, H, softcap,
                                   causal, dtype)


def kernels_flash(g, hw, card):
    """The flash forward against ref.flash_fwd on the same card inputs:
    out within FLASH_TOL of its dtype, lse within LSE_TOL.  Then, at both
    of the train phase's shapes (qwen3-1.7b, 16/8 heads, H 128, bf16,
    causal): the same bits from two launches, and kernel, plain and SDPA
    timed.  Returns the record of the long-context shape (B1 x S4096)."""
    dev = torch.device("cuda")
    worst = {torch.float32: 0.0, torch.bfloat16: 0.0}
    n = 0
    for BN, S, G, H, softcap, causal, dtype in _flash_cases():
        q = torch.randn((BN, G * S, H), generator=g, device=dev).to(dtype)
        k = torch.randn((BN, S, H), generator=g, device=dev).to(dtype)
        v = torch.randn((BN, S, H), generator=g, device=dev).to(dtype)
        what = (f"flash BN{BN} S{S} G{G} H{H} cap{softcap:g} "
                f"{'causal' if causal else 'full'} {dtype}")
        out, lse = fa_kernel.flash_fwd(q, k, v, causal=causal,
                                       softcap=softcap, sq_real=S)
        w_out, w_lse = fa_ref.flash_fwd(q, k, v, causal=causal,
                                        softcap=softcap, sq_real=S)
        rtol, atol = fa_ref.FLASH_TOL[dtype]
        worst[dtype] = max(worst[dtype], check(
            f"{what} out", out.float(), w_out.float(), rtol, atol))
        check(f"{what} lse", lse, w_lse, *fa_ref.LSE_TOL)
        n += 1
        del q, k, v, out, lse, w_out, w_lse
    torch.cuda.empty_cache()
    log("kernels-train", f"flash_attention: {n} cases ok (the train "
                         f"phase's two shapes among them), max abs err of "
                         f"out fp32 {worst[torch.float32]:.2e}, bf16 "
                         f"{worst[torch.bfloat16]:.2e}")
    cfg = get_config(TRAIN_ARCH)
    NQ, NKV, H = cfg.n_heads, cfg.n_kv_heads, cfg.resolved_head_dim
    G = NQ // NKV
    for B, S in TRAIN_SHAPES:
        q = torch.randn((B, NQ, S, H), generator=g, device=dev,
                        dtype=torch.bfloat16)
        k = torch.randn((B, NKV, S, H), generator=g, device=dev,
                        dtype=torch.bfloat16)
        v = torch.randn((B, NKV, S, H), generator=g, device=dev,
                        dtype=torch.bfloat16)
        # the grouped layout of ops._group: (B*NKV, G*S, H), no K/V copy
        qg = q.reshape(B * NKV, G * S, H)
        kg, vg = k.reshape(B * NKV, S, H), v.reshape(B * NKV, S, H)
        out, lse = fa_kernel.flash_fwd(qg, kg, vg, causal=True, sq_real=S)
        again = fa_kernel.flash_fwd(qg, kg, vg, causal=True, sq_real=S)
        torch.cuda.synchronize()
        if not (torch.equal(out, again[0]) and torch.equal(lse, again[1])):
            raise SystemExit(f"flash B{B} S{S}: two launches on the same "
                             f"inputs gave different bits")
        lib = F.scaled_dot_product_attention(q, k, v, is_causal=True,
                                             enable_gqa=True)
        # SDPA rounds the probabilities to bf16 before P.V: a looser
        # yardstick
        err = check(f"flash qwen3 B{B} S{S} vs SDPA yardstick",
                    out.view(B, NQ, S, H).float(), lib.float(), 1e-2, 1e-2)
        # causal pairs (the diagonal included); QK^T and PV, 2 flops a MAC
        flops = 2.0 * B * NQ * H * S * (S + 1)
        nbytes = 2.0 * (qg.numel() + kg.numel() + vg.numel() + qg.numel()) \
            + 4.0 * qg.shape[0] * qg.shape[1]
        rec = timed_record(
            f"flash_attention B{B} S{S} {NQ}/{NKV} heads H{H} bf16 causal", {
                "kernel": lambda: fa_kernel.flash_fwd(qg, kg, vg, causal=True,
                                                      sq_real=S),
                "plain": lambda: fa_ref.flash_fwd(qg, kg, vg, causal=True,
                                                  sq_real=S),
                "library": lambda: F.scaled_dot_product_attention(
                    q, k, v, is_causal=True, enable_gqa=True)},
            flops, nbytes, torch.bfloat16, hw, card,
            max(worst.values()), "kernels-train")
        # the tensor-core path does P.V twice (p_hi and p_lo)
        split_ms = hw.bound_s(1.5 * flops, nbytes, torch.bfloat16)[0] * 1e3
        vs_sdpa = rec["ms"] / rec["library_ms"]
        log("kernels-train", f"  B{B} S{S}: same bits twice; vs SDPA max abs "
                             f"err {err:.2e}; kernel {vs_sdpa:.2f}x SDPA; "
                             f"bound with the split's second P.V "
                             f"{split_ms:.4f} ms")
        del q, k, v, qg, kg, vg, out, lse, again, lib
        torch.cuda.empty_cache()
    return rec


def _whisper_cases():
    """(what, B, S, causal) of whisper-base's train step at AUDIO_TRAIN: the
    encoder's non-causal attention over the frames (S 1500: no multiple of
    a tile) and the decoder's causal self-attention."""
    B, S = AUDIO_TRAIN
    cfg = get_config(AUDIO_ARCH)
    return (("encoder", B, cfg.n_audio_ctx, False), ("decoder", B, S, True))


def kernels_flash_whisper(g, hw, card):
    """B2 at whisper-base's train shapes (8/8 heads, H 64, bf16) against its
    plain version, out and lse, and timed beside SDPA; neither shape ran on
    the card in train mode before."""
    dev = torch.device("cuda")
    cfg = get_config(AUDIO_ARCH)
    NQ, NKV, H = cfg.n_heads, cfg.n_kv_heads, cfg.resolved_head_dim
    G = NQ // NKV
    for what, B, S, causal in _whisper_cases():
        q = torch.randn((B, NQ, S, H), generator=g, device=dev,
                        dtype=torch.bfloat16)
        k = torch.randn((B, NKV, S, H), generator=g, device=dev,
                        dtype=torch.bfloat16)
        v = torch.randn((B, NKV, S, H), generator=g, device=dev,
                        dtype=torch.bfloat16)
        qg = q.reshape(B * NKV, G * S, H)
        kg, vg = k.reshape(B * NKV, S, H), v.reshape(B * NKV, S, H)
        out, lse = fa_kernel.flash_fwd(qg, kg, vg, causal=causal, sq_real=S)
        w_out, w_lse = fa_ref.flash_fwd(qg, kg, vg, causal=causal, sq_real=S)
        rtol, atol = fa_ref.FLASH_TOL[torch.bfloat16]
        label = (f"flash whisper {what} B{B} S{S} {NQ}/{NKV} heads H{H} bf16 "
                 f"{'causal' if causal else 'full'}")
        err = check(f"{label} out", out.float(), w_out.float(), rtol, atol)
        check(f"{label} lse", lse, w_lse, *fa_ref.LSE_TOL)
        pairs = S * (S + 1) / 2 if causal else S * S
        flops = 4.0 * B * NQ * H * pairs
        nbytes = 2.0 * (2 * qg.numel() + kg.numel() + vg.numel()) \
            + 4.0 * qg.shape[0] * qg.shape[1]
        timed_record(label, {
            "kernel": lambda: fa_kernel.flash_fwd(qg, kg, vg, causal=causal,
                                                  sq_real=S),
            "plain": lambda: fa_ref.flash_fwd(qg, kg, vg, causal=causal,
                                              sq_real=S),
            "library": lambda: F.scaled_dot_product_attention(
                q, k, v, is_causal=causal)},
            flops, nbytes, torch.bfloat16, hw, card, err, "kernels-train")
        del q, k, v, qg, kg, vg, out, lse, w_out, w_lse
        torch.cuda.empty_cache()


def phase_kernels_train(card, hw):
    g = torch.Generator(device="cuda").manual_seed(2)
    rec = kernels_flash(g, hw, card)
    kernels_flash_whisper(g, hw, card)
    torch.cuda.empty_cache()
    return {"flash_attention": rec}


# ---------------------------------------------------------------------------
# phase 4, continued: the ssm path's SSD scan kernel vs plain
# ---------------------------------------------------------------------------
SSD_TOL = 2e-3      # rtol = atol: fp32 both, sums in another order
# the gradient check: the same plain scan differentiated on both sides,
# from the same saved inputs; b 1 x S 4096, the train phase's long shape
SSD_GRAD_RTOL = 1e-5
SSD_GRAD_SHAPE = (1, 4096)


def _ssd_inputs(g, b, S, h, P, N):
    """Model-layout fp32 inputs at the scales of the JAX kernel test."""
    dev = torch.device("cuda")
    x = torch.randn((b, S, h, P), generator=g, device=dev)
    dt = F.softplus(torch.randn((b, S, h), generator=g, device=dev)) * 0.1
    A = -torch.exp(torch.randn((h,), generator=g, device=dev))
    B = torch.randn((b, S, N), generator=g, device=dev) * 0.5
    C = torch.randn((b, S, N), generator=g, device=dev) * 0.5
    D = torch.randn((h,), generator=g, device=dev)
    return x, dt, A, B, C, D


def _ssd_kernel_call(x, dt, A, B, C, D, chunk):
    """The kernel through its binding, A and D one value a stream."""
    b, _, h, _ = x.shape
    return ssd_kernel.ssd_scan_fwd(
        x, dt, B, C, A.expand(b, h).reshape(-1), D.expand(b, h).reshape(-1),
        chunk=chunk)


def _ssd_cases():
    """(b, S, h, P, N, chunk): every head dim, state dim and chunk the
    kernel takes at S 1, 200 (b 8) and 2048; then mamba2-780m's layer and
    jamba-v0.1-52b's."""
    for P in ssd_kernel.HEAD_DIMS:
        for N in ssd_kernel.STATE_DIMS:
            for chunk in (16, 32, 64, 128, 256):
                for S in (1, 200, 2048):
                    yield (8 if S == 200 else 1, S, 2, P, N, chunk)
    yield _ssd_full_shape()
    yield _ssd_full_shape(HYBRID_ARCH, MOE_STATIC)


def _ssd_full_shape(arch=SSM_ARCH, static=SSM_STATIC):
    """A layer's SSD call in ``arch``'s static prefill of ``static``."""
    cfg = get_config(arch)
    s = cfg.ssm
    heads = s.expand * cfg.d_model // s.head_dim
    return (static["slots"], static["prompt_len"], heads, s.head_dim,
            s.d_state, s.chunk_size)


def _ssd_timed(g, hw, card, shape, err):
    """Kernel and plain ms at one shape, its bound (the record's: fp32 on
    the CUDA cores) and the 3xTF32 bound beside it."""
    b, S, h, P, N, L = shape
    args = _ssd_inputs(g, b, S, h, P, N)
    nc = -(-S // L)
    # causal pairs only: C.B^T once per (row, chunk), and per head W.xdt,
    # the inter-chunk term and the state update; 2 flops a MAC
    tri = L * (L + 1) / 2
    flops = 2.0 * b * nc * (tri * N + h * (tri * P + 2 * L * P * N))
    # x and y, dt, B and C, h_final: each read or written once, fp32
    nbytes = 4.0 * (2 * b * S * h * P + b * S * h + 2 * b * S * N
                    + b * h * P * N)
    what = f"ssd_scan b{b} S{S} h{h} P{P} N{N} chunk{L} fp32"
    rec = timed_record(what, {
        "kernel": lambda: _ssd_kernel_call(*args, L),
        "plain": lambda: ssd_ref.ssd_chunked(*args, L)},
        flops, nbytes, torch.float32, hw, card, err, "kernels-ssm")
    # the kernel runs each product as three TF32 products on the tensor
    # cores: that bound beside the record's (fp32 on the CUDA cores)
    tf32_ms = max(3 * flops / hw.peak_flops_tf32,
                  nbytes / hw.hbm_bw) * 1e3
    log("kernels-ssm", f"{what}: 3xTF32 bound_ms {tf32_ms:.4f} (3 x "
                       f"{flops / 1e9:.1f} GFLOP at "
                       f"{hw.peak_flops_tf32 / 1e12:.0f} TFLOP/s); the "
                       f"call's kernels: {ssd_kernel_times(args, L)} | "
                       f"{card}")
    del args
    torch.cuda.empty_cache()
    return rec


def kernels_ssd(g, hw, card):
    """y and h_final of the kernel against ref.ssd_chunked on the same card
    inputs, within SSD_TOL; then timed at mamba2-780m's layer shape (the
    record's) and jamba-v0.1-52b's."""
    worst = 0.0
    n = 0
    for b, S, h, P, N, chunk in _ssd_cases():
        args = _ssd_inputs(g, b, S, h, P, N)
        y, hf = _ssd_kernel_call(*args, chunk)
        w_y, w_h = ssd_ref.ssd_chunked(*args, chunk)
        what = f"ssd b{b} S{S} h{h} P{P} N{N} chunk{chunk}"
        worst = max(worst, check(f"{what} y", y, w_y, SSD_TOL, SSD_TOL),
                    check(f"{what} h_final", hf, w_h, SSD_TOL, SSD_TOL))
        n += 1
        del args, y, hf, w_y, w_h
    torch.cuda.empty_cache()
    log("kernels-ssm", f"ssd_scan: {n} cases ok (mamba2-780m's and "
                       f"jamba-v0.1-52b's layer shapes among them), max abs "
                       f"err of y and h_final {worst:.2e}")
    rec = _ssd_timed(g, hw, card, _ssd_full_shape(), worst)
    _ssd_timed(g, hw, card, _ssd_full_shape(HYBRID_ARCH, MOE_STATIC), worst)
    return rec


def ssd_kernel_times(args, L):
    """Device us of each kernel one SSD call issues, the mean of 5 calls
    under torch.profiler."""
    prof = torch.profiler.profile(
        activities=[torch.profiler.ProfilerActivity.CUDA])
    with prof:
        for _ in range(5):
            _ssd_kernel_call(*args, L)
        torch.cuda.synchronize()
    rows = [(e.key.split("(")[0].split("::")[-1], e.device_time_total
             / e.count) for e in prof.key_averages()
            if e.device_time_total > 0 and "ssd_" in e.key]
    return ", ".join(f"{k} {us:.1f} us" for k, us in rows) or "not measured"


def ssd_gradient(g, card, arch):
    """B4 under autograd (``ops.SSDChunked``: the kernel's forward, the
    plain scan's vector-Jacobian product) against autograd through
    ``ref.ssd_chunked`` on the same inputs and cotangents (of y and
    h_final), at ``arch``'s layer at b 1 x S 4096: each input's gradient
    within SSD_GRAD_RTOL of its largest element.  Then the forward kernel,
    the Function's backward and the plain backward timed interleaved."""
    b, S = SSD_GRAD_SHAPE
    cfg = get_config(arch)
    s = cfg.ssm
    h = s.expand * cfg.d_model // s.head_dim
    L = s.chunk_size
    args = _ssd_inputs(g, b, S, h, s.head_dim, s.d_state)
    live = [a.clone().requires_grad_() for a in args]
    before = ssd_kernel.ssd_scan_fwd.launches
    y, hf = ssd_ops.ssd_chunked(*live, chunk=L)
    if ssd_kernel.ssd_scan_fwd.launches != before + 1:
        raise SystemExit(f"ssd gradient {arch}: the forward did not launch "
                         f"the kernel once")
    gy = torch.randn(y.shape, generator=g, device=y.device)
    gh = torch.randn(hf.shape, generator=g, device=y.device)
    got = torch.autograd.grad((y, hf), live, (gy, gh), retain_graph=True)
    ref_live = [a.clone().requires_grad_() for a in args]
    wy, wh = ssd_ref.ssd_chunked(*ref_live, chunk=L)
    want = torch.autograd.grad((wy, wh), ref_live, (gy, gh),
                               retain_graph=True)
    what = f"ssd gradient {arch} b{b} S{S} h{h} P{s.head_dim} N{s.d_state}"
    rel = {}
    for name, a, w in zip(("x", "dt", "A", "B", "C", "D"), got, want):
        scale = float(w.abs().max())
        check(f"{what} d{name}", a, w, 0.0, SSD_GRAD_RTOL * scale)
        rel[name] = float((a - w).abs().max()) / scale
    ms = measure_group({
        "forward": lambda: _ssd_kernel_call(*args, L),
        "backward": lambda: torch.autograd.grad(
            (y, hf), live, (gy, gh), retain_graph=True),
        "plain_backward": lambda: torch.autograd.grad(
            (wy, wh), ref_live, (gy, gh), retain_graph=True)},
        reps=5, cover_ms=20.0)
    ms = {k: m.median_s * 1e3 for k, m in ms.items()}
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    log("kernels-ssm", f"{what} chunk {L}: every input's gradient matches "
                       f"autograd through ref.ssd_chunked, max |err| / "
                       f"max |grad|: " + ", ".join(
                           f"d{k} {v:.2e}" for k, v in rel.items())
        + f"; forward kernel {ms['forward']:.4f} ms, backward (the plain "
          f"scan recomputed) {ms['backward']:.4f} ms, plain backward "
          f"{ms['plain_backward']:.4f} ms; peak {peak:.2f} GiB | {card}")
    del args, live, ref_live, y, hf, wy, wh, got, want
    torch.cuda.empty_cache()


def phase_kernels_ssm(card, hw):
    g = torch.Generator(device="cuda").manual_seed(3)
    rec = kernels_ssd(g, hw, card)
    torch.cuda.reset_peak_memory_stats()
    for arch in (SSM_ARCH, HYBRID_ARCH):
        ssd_gradient(g, card, arch)
    return {"ssd_scan": rec}


# ---------------------------------------------------------------------------
# phase 4, continued: the int8 serving path's GEMM vs plain
# ---------------------------------------------------------------------------
WQ_TOL = 2e-4       # fp32 out, rtol = atol: the JAX kernel test's tolerance


def _wq_inputs(g, M, K, N, transposed, x_dtype):
    """x (M, K) and a quantized (K, N) weight, q stored (N, K) if
    ``transposed``; the weight at the model's initializer scale."""
    dev = torch.device("cuda")
    x = torch.randn((M, K), generator=g, device=dev).to(x_dtype)
    q, s = wq_ref.quantize(torch.randn((K, N), generator=g, device=dev)
                           * K ** -0.5)
    return x, (q.T.contiguous() if transposed else q), s


def _check_wq(what, x, q, s, transposed):
    """The kernel against ref.wq_gemm on the same inputs, fp32 out within
    WQ_TOL.  For bf16 x also the kernel's bf16 out, its fp32 sum rounded
    once: within half a bf16 ulp of that sum, so within half an ulp plus
    the fp32 difference (measured on these inputs) of the plain value."""
    k32, p32 = (fn(x, q, s, out_dtype=torch.float32,
                   q_transposed=transposed)
                for fn in (wq_kernel.wq_gemm, wq_ref.wq_gemm))
    err = check(f"{what} fp32 out", k32, p32, WQ_TOL, WQ_TOL)
    if x.dtype == torch.float32:
        return err
    got = wq_kernel.wq_gemm(x, q, s, q_transposed=transposed).float()
    half_ulp = torch.exp2(torch.floor(torch.log2(
        got.abs().clamp_min(1e-30))) - 8)
    check(f"{what} bf16 out", got, p32, 1.0, 0.0,
          half_ulp + (k32 - p32).abs())
    return err


def wq_long_k_error(g):
    """Sums at granite's longest K (8192) with unit-scale weights, where
    the order of an fp32 sum shows: each path's max |error| against the
    fp64 product beside fp32 ``torch.matmul``'s (the plain version) and,
    for bf16 x, the library's tensor-core product with fp32 out
    (``torch.mm``'s ``out_dtype``) of the same int8 weights.  M 8: the
    GEMV; M 65 x N 1024: wgmma's (64, 64) tile, its sums promoted; M 4096
    x N 2048 (the prefill's down projection): the (128, 256) tile, not
    promoted."""
    dev = torch.device("cuda")
    parts = []
    for M, N in ((8, 1024), (65, 1024), (4096, 2048)):
        for x_dtype in (torch.float32, torch.bfloat16):
            x = torch.randn((M, 8192), generator=g, device=dev).to(x_dtype)
            q, s = wq_ref.quantize(torch.randn((8192, N), generator=g,
                                               device=dev))
            exact = (x.double() @ q.double()) * s.double()
            err = {"kernel": wq_kernel.wq_gemm(x, q, s,
                                               out_dtype=torch.float32),
                   "fp32 matmul": wq_ref.wq_gemm(x, q, s,
                                                 out_dtype=torch.float32)}
            if x_dtype == torch.bfloat16:
                try:
                    err["bf16 mm"] = torch.mm(
                        x, q.to(x_dtype), out_dtype=torch.float32) * s
                except (TypeError, RuntimeError):
                    err["bf16 mm"] = None
            errs = ", ".join(
                f"{k} " + ("—" if v is None else
                           f"{float((v.double() - exact).abs().max()):.2e}")
                for k, v in err.items())
            parts.append(f"M{M} N{N} {str(x_dtype)[6:]} x: {errs}")
    log("kernels-int8", "wq_gemm K 8192, unit-scale weights, max |err| vs "
                        "fp64: " + "; ".join(parts))


def _wq_timed(g, hw, card, what, M, K, N, transposed, err,
              x_dtype=torch.bfloat16):
    """Kernel, plain and library (``torch.matmul`` of the dequantized
    weight in x's type) ms at one shape, and its bound."""
    x, q, s = _wq_inputs(g, M, K, N, transposed, x_dtype)
    w = (q.float() * (s[:, None] if transposed else s)).to(x_dtype)
    library = ((lambda: torch.matmul(x, w.T)) if transposed
               else (lambda: torch.matmul(x, w)))
    # int8 weights, their scales, x and y, each moved once; 2 flops a MAC
    size = x.element_size()
    nbytes = K * N + 4.0 * N + size * (M * K + M * N)
    return timed_record(
        f"wq_gemm {what} M{M} {K}->{N}{' q (N, K)' if transposed else ''} "
        f"{'bf16' if x_dtype == torch.bfloat16 else 'fp32'}", {
            "kernel": lambda: wq_kernel.wq_gemm(x, q, s,
                                                q_transposed=transposed),
            "plain": lambda: wq_ref.wq_gemm(x, q, s,
                                            q_transposed=transposed),
            "library": library},
        2.0 * M * N * K, nbytes, x_dtype, hw, card, err, "kernels-int8")


def kernels_wq(g, hw, card):
    """Checks at the JAX test's shapes, ragged shapes (both layouts, fp32
    and bf16 x), granite-3-2b's own; then timed at granite's decode and
    prefill shapes.  Returns the record of the decode 2048 -> 8192."""
    cfg = get_config(INT8_ARCH)
    d, ff, V = cfg.d_model, cfg.d_ff, cfg.padded_vocab
    cases = [(128, 256, 128, False), (256, 128, 384, False)]
    # ragged M on both sides of every tile edge; K and N off every tile:
    # 300 and 1000 take the byte loads, 2000 and 1008 the 16-byte ones
    for M in (1, 7, 8, 9, 16, 33, 64, 65, 256):
        cases += [(M, 300, 1000, False), (M, 300, 1000, True),
                  (M, 2000, 1008, False), (M, 2000, 1008, True)]
    for M in (1, 7, 8, 33):
        cases += [(M, 300, V, True), (M, d, ff, False), (M, ff, d, False),
                  (M, d, V, True)]
    # the main path's own M past the GEMV: a static prefill's logits (M 4096
    # through the (V, d) table) and a continuous engine's mixed step (M
    # 256), both layouts
    cases += [(4096, d, ff, False), (4096, d, V, True),
              (256, d, ff, False), (256, ff, d, False), (256, d, V, True)]
    # an expert's gate and down at phi3.5-moe's static prefill (8 rows x
    # capacity 80)
    cases += [(k, MOE_D, MOE_FF, False) for k in (8, MOE_ROWS)]
    cases += [(MOE_ROWS, MOE_FF, MOE_D, False)]
    # jamba-v0.1-52b's experts at decode and its static prefill (the same
    # capacity 80), and its mamba B / C (N 16) and dt (N 128) projections
    # at decode and at the static prefill (M 8 x 512)
    for M in (8, MOE_ROWS):
        cases += [(M, MOE_D, HYBRID_FF, False), (M, HYBRID_FF, MOE_D, False)]
    cases += [(M, MOE_D, n, False) for M in (8, 4096)
              for n in HYBRID_MAMBA_N]
    # llama-3.2-vision-90b's MLP and unembed at decode (M 8) and its cross
    # K/V install over 1601 image tokens (8192 -> 1024)
    cases += [(8, VLM_D, VLM_FF, False), (8, VLM_FF, VLM_D, False),
              (8, VLM_D, VLM_V, True), (VLM_IMAGE, VLM_D, VLM_KV, False)]
    worst, n = 0.0, 0
    for M, K, N, transposed in cases:
        for x_dtype in (torch.float32, torch.bfloat16):
            x, q, s = _wq_inputs(g, M, K, N, transposed, x_dtype)
            worst = max(worst, _check_wq(
                f"wq_gemm M{M} K{K} N{N} transposed {transposed} {x_dtype}",
                x, q, s, transposed))
            n += 1
    torch.cuda.empty_cache()
    log("kernels-int8", f"wq_gemm: {n} cases ok (granite-3-2b's decode and "
                        f"prefill shapes among them), max abs err {worst:.2e}")
    wq_long_k_error(g)
    recs = [_wq_timed(g, hw, card, "decode", 8, d, ff, False, worst),
            _wq_timed(g, hw, card, "decode", 8, ff, d, False, worst),
            _wq_timed(g, hw, card, "decode unembed", 8, d, V, True, worst),
            _wq_timed(g, hw, card, "mixed step", 256, d, ff, False, worst),
            _wq_timed(g, hw, card, "prefill", 4096, d, ff, False, worst),
            _wq_timed(g, hw, card, "prefill logits", 4096, d, V, True,
                      worst)]
    # the moe experts' products: phi3.5-moe's at decode (M 8) and at its
    # static prefill (M 640: 8 rows x capacity 80), grok-1's at its static
    # prefill (M 1280)
    _wq_timed(g, hw, card, "phi3.5-moe expert decode", 8, MOE_D, MOE_FF,
              False, worst)
    _wq_timed(g, hw, card, "phi3.5-moe expert prefill", MOE_ROWS, MOE_D,
              MOE_FF, False, worst)
    _wq_timed(g, hw, card, "phi3.5-moe expert prefill down", MOE_ROWS,
              MOE_FF, MOE_D, False, worst)
    _wq_timed(g, hw, card, "grok-1 expert prefill", 2 * MOE_ROWS, 6144,
              32768, False, worst)
    for M, where in ((8, "decode"), (MOE_ROWS, "prefill")):
        _wq_timed(g, hw, card, f"jamba expert {where}", M, MOE_D, HYBRID_FF,
                  False, worst)
        _wq_timed(g, hw, card, f"jamba expert {where} down", M, HYBRID_FF,
                  MOE_D, False, worst)
    torch.cuda.empty_cache()
    for what, M, K, N, transposed in (
            ("llama-3.2-vision decode", 8, VLM_D, VLM_FF, False),
            ("llama-3.2-vision decode", 8, VLM_FF, VLM_D, False),
            ("llama-3.2-vision decode unembed", 8, VLM_D, VLM_V, True),
            ("llama-3.2-vision install", VLM_IMAGE, VLM_D, VLM_KV, False)):
        _wq_timed(g, hw, card, what, M, K, N, transposed, worst)
    torch.cuda.empty_cache()
    # fp32 x, the reduced configurations' and the parity checks' path, at
    # the decode shapes
    for K, N in ((d, ff), (ff, d)):
        _wq_timed(g, hw, card, "decode", 8, K, N, False, worst, torch.float32)
    wq_gemv_fixed_cost(g, hw, card, d, ff, recs[0], worst)
    wq_host_cost(g, d, ff)
    torch.cuda.empty_cache()
    return recs[0]


def wq_gemv_fixed_cost(g, hw, card, d, ff, rec, worst):
    """The GEMV at four times the bytes (8192 -> 8192): the difference from
    ``rec`` (2048 -> 8192) is its streaming rate, the rest a fixed cost a
    call.  The same call at K 128 (one ring stage, 1 MB) reads that cost's
    floor: launch, the first tile's latency and the store."""
    big = _wq_timed(g, hw, card, "decode 4x bytes", 8, ff, ff, False, worst)
    floor = _wq_timed(g, hw, card, "decode floor", 8, 128, ff, False, worst)
    rate = (ff * ff - d * ff) / ((big["ms"] - rec["ms"]) * 1e-3) / 1e12
    fixed = rec["ms"] - d * ff / (rate * 1e12) * 1e3
    log("kernels-int8", f"wq_gemm GEMV: {rate:.2f} TB/s between {d}->{ff} "
                        f"and {ff}->{ff}, so {fixed:.4f} ms of the "
                        f"{d}->{ff} call is not streaming; a call at K 128 "
                        f"takes {floor['ms']:.4f} ms | {card}")


HOST_ROUNDS = 7


def _host_us(fn, n=200):
    """Host microseconds a call: ``n`` calls issued with no sync between
    them (fewer than the launch queue holds, so the host never waits on
    the card), after a warm-up."""
    for _ in range(10):
        fn()
    torch.cuda.synchronize()
    t0 = datetime.datetime.now()
    for _ in range(n):
        fn()
    secs = _since(t0)
    torch.cuda.synchronize()
    return secs / n * 1e6


def wq_host_cost(g, d, ff):
    """Host time a call of the int8 GEMM at granite's decode 2048 -> 8192
    (M 8, bf16 x): the model's call (``matmul_q``), the entry (``ops``),
    the binding (``kernel``: checks, output allocated, cached plan, ctypes
    call), the bare ctypes launch with its arguments made beforehand, and
    bf16 ``torch.matmul`` of the dequantized weights."""
    x, q, s = _wq_inputs(g, 8, d, ff, False, torch.bfloat16)
    w = (q.float() * s).to(torch.bfloat16)
    pack = {"q": q, "scale": s}
    call = wq_kernel._call(x.shape, q.shape, s.shape, x.dtype, q.dtype,
                           s.dtype, x.dtype, False, x.device, q.device,
                           s.device)
    y = torch.empty((8, ff), dtype=torch.bfloat16, device=x.device)
    lib = wq_kernel.load_library()
    args = (x.data_ptr(), q.data_ptr(), s.data_ptr(), y.data_ptr(),
            call.plan_vec, torch.cuda.current_stream().cuda_stream)
    fns = {"matmul_q": lambda: matmul_q(x, pack),
           "ops.wq_gemm": lambda: wq_ops.wq_gemm(x, q, s),
           "kernel.wq_gemm": lambda: wq_kernel.wq_gemm(x, q, s),
           "bare launch": lambda: lib.wq_gemm_launch(*args),
           "torch.matmul": lambda: torch.matmul(x, w)}
    us = {k: [] for k in fns}
    for _ in range(HOST_ROUNDS):                # interleaved: the host drifts
        for k, fn in fns.items():
            us[k].append(_host_us(fn))
    if not torch.equal(y, wq_kernel.wq_gemm(x, q, s)):
        raise SystemExit("wq_gemm: the bare launch differs from the binding's")
    log("kernels-int8", f"host us a call, wq_gemm decode M8 2048->8192 bf16 "
                        f"(200 calls, no sync between; median of "
                        f"{HOST_ROUNDS} rounds, min-max): " + ", ".join(
                            f"{k} {statistics.median(v):.1f} "
                            f"({min(v):.1f}-{max(v):.1f})"
                            for k, v in us.items()))


def phase_kernels_int8(card, hw):
    g = torch.Generator(device="cuda").manual_seed(4)
    return {"wq_gemm": kernels_wq(g, hw, card)}


# ---------------------------------------------------------------------------
# phase 4, continued: the dense-cache decode's flash-decode kernel vs plain
# ---------------------------------------------------------------------------
# (rtol, atol).  fp32: the JAX kernel test's 2e-4.  bf16: both compute in
# fp32 and round once to bf16, at most one bf16 ulp apart (as the flash
# forward's check).
DECODE_TOL = {torch.float32: (2e-4, 2e-4), torch.bfloat16: (8e-3, 1e-4)}
DECODE_S = 1040            # the check grid's cache: 32.5 tiles of 32 keys
# rows: no valid key, one, a tile edge, ragged, the whole cache
DECODE_VALID = (0, 1, 32, 1000, DECODE_S)
# (what, B, S_cache, kv_valid, NQ, NKV, H, Sq): the static engine's decode
# at phase 6d (qwen3-1.7b, 8 x 2048 prompt tokens + 32 new: the cache
# holds 2088) and at phase 6c (granite-3-2b, 8 x 512 + 32: 552), bf16;
# then qwen3's at 64 slots, whose 512 blocks fill the card (8 slots give
# 64 blocks on 132 SMs: what that costs); then the cross-attention decode
# over installed K/V, every key valid and the capacity off the 32-token
# tile (the last split ends in a partial tile): llama-3.2-vision's 1601
# image tokens (64/8 heads of 128) and whisper's 1500 frames (8/8 of 64),
# at a decode step (8 slots, Sq 1), at the continuous engine's prefill
# chunk (``_prefill_row``: one slot, 32 columns) and at 8 rows of 32
# columns (a check shape: no path launches it)
DECODE_TIMED = (("qwen3-1.7b static decode", 8, 2088, 2080, 16, 8, 128, 1),
                ("granite-3-2b 6c static decode", 8, 552, 520, 32, 8, 64,
                 1),
                ("qwen3-1.7b decode at 64 slots", 64, 2088, 2080, 16, 8,
                 128, 1),
                ("grok-1 6f static decode", 8, 552, 520, 48, 8, 128, 1),
                ("phi3-medium-14b 6g static decode", 8, 552, 520, 40, 10,
                 128, 1),
                ("llama-3.2-vision 6i cross decode", 8, 1601, 1601, 64, 8,
                 128, 1),
                ("llama-3.2-vision 6i(b) cross prefill chunk", 1, 1601,
                 1601, 64, 8, 128, 32),
                ("llama-3.2-vision cross 8 x 32 columns (not launched)", 8,
                 1601, 1601, 64, 8, 128, 32),
                ("whisper-base 6j cross decode", 8, 1500, 1500, 8, 8, 64,
                 1),
                ("whisper-base 6j(b) cross prefill chunk", 1, 1500, 1500,
                 8, 8, 64, 32),
                ("whisper-base cross 8 x 32 columns (not launched)", 8,
                 1500, 1500, 8, 8, 64, 32))


DECODE_SWEEP = (1, 2, 4, 8)     # forced split counts, beside the plan's


def _decode_lens(sq, dev):
    """(rows, sq) valid lengths: a decode row (sq 1), or the sq columns of
    a prefill row ending at the row's length (t <= position)."""
    v = torch.tensor(DECODE_VALID, dtype=torch.int32)
    lens = (v[:, None] - sq + 1 + torch.arange(sq)[None]).clamp(0, DECODE_S)
    return lens.to(torch.int32).to(dev)


def _decode_cases():
    """(H, G, NKV, sq, softcap, dtype): every H and power-of-two G at NKV
    2, then the served configs' G 6 (grok-1: 48/8 heads) and NKV 10
    (phi3-medium-14b: 40/10)."""
    groups = [(H, G, 2) for H in (32, 64, 128) for G in (1, 2, 4, 8)]
    groups += [(128, 6, 8), (64, 6, 2), (128, 4, 10)]
    for H, G, NKV in groups:
        for sq in (1, 32):
            for softcap in (0.0, SOFTCAP):
                for dtype in (torch.float32, torch.bfloat16):
                    yield H, G, NKV, sq, softcap, dtype


def kernels_flash_decode(g, hw, card):
    """The flash-decode kernel against ref.flash_decode on the same card
    inputs, every case of ``_decode_cases`` over the DECODE_VALID rows, the
    cache a strided view (every other row of a wider one) in every other
    case; queries with no valid key exactly 0.  Then checked and timed
    at the DECODE_TIMED shapes."""
    dev = torch.device("cuda")
    worst = {torch.float32: 0.0, torch.bfloat16: 0.0}
    B = len(DECODE_VALID)
    n = 0
    for H, G, NKV, sq, softcap, dtype in _decode_cases():
        # softcap 30 over queries scaled as phase 3's: scores of ~30, where
        # the cap moves the output
        q = (torch.randn((B, sq, NKV * G, H), generator=g, device=dev)
             * (SOFTCAP_Q_SCALE if softcap else 1.0)).to(dtype)
        wide = torch.randn((2 * B, DECODE_S, NKV, H), generator=g,
                           device=dev).to(dtype)
        k, v = (wide[::2], wide[1::2]) if n % 2 else (wide[:B], wide[B:])
        lens = _decode_lens(sq, dev)
        what = (f"flash_decode H{H} G{G} NKV{NKV} Sq{sq} cap{softcap:g} "
                f"{dtype}")
        got = fa_kernel.flash_decode(q, k, v, lens, softcap=softcap)
        want = fa_ref.flash_decode(q, k, v, lens, softcap=softcap)
        rtol, atol = DECODE_TOL[dtype]
        worst[dtype] = max(worst[dtype], check(what, got.float(),
                                               want.float(), rtol, atol))
        if not bool((got[lens == 0] == 0).all()):
            raise SystemExit(f"{what}: a query with no valid key is not 0")
        n += 1
    log("kernels-serve-dense", f"flash_decode: {n} cases ok (H 32/64/128, "
                               f"G 1/2/4/8 at NKV 2; G 6 at NKV 8 and 2, "
                               f"NKV 10 at G 4; Sq 1 and a 32-column "
                               f"prefill row, softcap 0 and {SOFTCAP:g} "
                               f"(queries x {SOFTCAP_Q_SCALE:g}), "
                               f"fp32/bf16; kv_valid "
                               f"{list(DECODE_VALID)}), max abs err fp32 "
                               f"{worst[torch.float32]:.2e}, bf16 "
                               f"{worst[torch.bfloat16]:.2e}")
    verify_decode(g, hw, card)
    recs = []
    for what, B, S, valid, NQ, NKV, H, Sq in DECODE_TIMED:
        q, k, v = (torch.randn(shape, generator=g, device=dev,
                               dtype=torch.bfloat16)
                   for shape in ((B, Sq, NQ, H), (B, S, NKV, H),
                                 (B, S, NKV, H)))
        lens = torch.full((B, Sq), valid, dtype=torch.int32, device=dev)
        want = fa_ref.flash_decode(q, k, v, lens)
        err = check(f"{what} shape", fa_kernel.flash_decode(q, k, v, lens)
                    .float(), want.float(), *DECODE_TOL[torch.bfloat16])
        # SDPA over the dense cache laid out heads-first beforehand, with
        # the valid-length mask (a call the port never makes)
        qh, kh, vh = (t.transpose(1, 2).contiguous() for t in (q, k, v))
        mask = (torch.arange(S, device=dev)[None, None, None, :]
                < lens[:, None, :, None])

        def library(qh=qh, kh=kh, vh=vh, mask=mask):
            return F.scaled_dot_product_attention(qh, kh, vh, attn_mask=mask,
                                                  enable_gqa=True)
        check(f"{what} vs SDPA yardstick", library().transpose(1, 2).float(),
              want.float(), 1e-2, 1e-2)
        # the valid K/V once, q and out, the lengths; QK^T and PV
        nbytes = 2.0 * B * valid * NKV * H * 2 + 2.0 * q.numel() * 2 \
            + lens.numel() * 4
        flops = 4.0 * B * Sq * valid * NQ * H
        name = (f"flash_decode {what}: B{B} Sq{Sq} S_cache {S} kv_valid "
                f"{valid} {NQ}/{NKV} heads H{H} bf16")
        recs.append(timed_record(name, {
            "kernel": lambda q=q, k=k, v=v, lens=lens:
                fa_kernel.flash_decode(q, k, v, lens),
            "plain": lambda q=q, k=k, v=v, lens=lens:
                fa_ref.flash_decode(q, k, v, lens),
            "library": library},
            flops, nbytes, torch.bfloat16, hw, card, err,
            "kernels-serve-dense"))
        plan = fa_kernel.decode_plan(
            B, Sq, NQ, NKV, H, S, 2,
            torch.cuda.get_device_properties(0).multi_processor_count)
        # the sweep the plan's rule is read against, timed interleaved
        fns = {f"s{n}": (lambda n=n, q=q, k=k, v=v, lens=lens:
                         fa_kernel.flash_decode(q, k, v, lens, splits=n))
               for n in DECODE_SWEEP}
        fns["plan"] = lambda q=q, k=k, v=v, lens=lens: \
            fa_kernel.flash_decode(q, k, v, lens)
        fns["sdpa"] = library
        ms = measure_group(fns, reps=30, flush_l2=True, cover_ms=2.0)
        # the same two without the flush: what the dirty lines the flush
        # leaves in L2 (written back under the K/V stream) cost
        warm = measure_group({n: fns[n] for n in ("plan", "sdpa")}, reps=30,
                             flush_l2=False, cover_ms=2.0)
        log("kernels-serve-dense",
            f"{name}: plan {plan.splits} splits x {plan.tokens_per_split} "
            f"tokens, grid {plan.grid}, {plan.blocks_per_sm} block an SM | "
            f"ms at forced splits " + " ".join(
                f"{n} {m.median_s * 1e3:.4f}" for n, m in ms.items())
            + " | L2 not flushed: " + " ".join(
                f"{n} {m.median_s * 1e3:.4f}" for n, m in warm.items())
            + f" | {card}")
        del q, k, v, qh, kh, vh
    torch.cuda.empty_cache()
    rec = recs[0]                       # the JSON line: qwen3's shape
    rec["max_abs_err"] = max(worst.values())
    return rec


def _verify_lens(S, dev):
    """(8, VERIFY_SQ) valid lengths of the verify forward's queries with
    ``paged_kernel=False``: ``attention.query_lens`` of each column's
    position (the row's before + c) and the row's ``before + fed``."""
    before = torch.tensor(VERIFY_BEFORE, dtype=torch.int32, device=dev)
    kv_valid = before + torch.tensor(VERIFY_FED, dtype=torch.int32,
                                     device=dev)
    pos = before[:, None].long() + torch.arange(VERIFY_SQ, device=dev)[None]
    return query_lens(pos, kv_valid, S)


def verify_decode(g, hw, card):
    """The flash-decode kernel at the verify width of speculative
    decoding (``paged_kernel=False``, spec_k 4): 8 rows of Sq 5, fed 0,
    1, 3 or 5 tokens each (the columns past a row's feed see its whole
    length and are discarded), granite's (32/8, H 64) and qwen3's (16/8,
    H 128) heads, softcap 0 and 30, fp32 and bf16, over a 512-token cache
    read through a strided view: against ``ref.flash_decode`` at
    DECODE_TOL, every output finite, a query with no valid key 0.  The
    granite bf16 shape is timed beside SDPA and its bound."""
    dev = torch.device("cuda")
    S, B = 512, len(VERIFY_FED)
    lens = _verify_lens(S, dev)
    worst = {torch.float32: 0.0, torch.bfloat16: 0.0}
    n = 0
    for NQ, NKV, H in ((32, 8, 64), (16, 8, 128)):
        for softcap in (0.0, SOFTCAP):
            for dtype in (torch.float32, torch.bfloat16):
                q = (torch.randn((B, VERIFY_SQ, NQ, H), generator=g,
                                 device=dev)
                     * (SOFTCAP_Q_SCALE if softcap else 1.0)).to(dtype)
                wide = torch.randn((2 * B, S, NKV, H), generator=g,
                                   device=dev).to(dtype)
                k, v = wide[::2], wide[1::2]
                what = (f"flash_decode verify Sq{VERIFY_SQ} {NQ}/{NKV} H{H} "
                        f"cap{softcap:g} {dtype}")
                got = fa_kernel.flash_decode(q, k, v, lens, softcap=softcap)
                want = fa_ref.flash_decode(q, k, v, lens, softcap=softcap)
                worst[dtype] = max(worst[dtype], check(
                    what, got.float(), want.float(), *DECODE_TOL[dtype]))
                if not bool((got[lens == 0] == 0).all()):
                    raise SystemExit(f"{what}: a query with no valid key "
                                     f"is not 0")
                n += 1
    log("kernels-serve-dense", f"flash_decode at the verify width: {n} "
                               f"cases ok (Sq {VERIFY_SQ}, fed "
                               f"{list(VERIFY_FED)} after "
                               f"{list(VERIFY_BEFORE)}; 32/8 H64 and 16/8 "
                               f"H128; softcap 0 and {SOFTCAP:g}), max abs "
                               f"err fp32 {worst[torch.float32]:.2e}, bf16 "
                               f"{worst[torch.bfloat16]:.2e}")
    NQ, NKV, H = 32, 8, 64
    q, k, v = (torch.randn(shape, generator=g, device=dev,
                           dtype=torch.bfloat16)
               for shape in ((B, VERIFY_SQ, NQ, H), (B, S, NKV, H),
                             (B, S, NKV, H)))
    want = fa_ref.flash_decode(q, k, v, lens)
    err = check("flash_decode verify timed shape",
                fa_kernel.flash_decode(q, k, v, lens).float(), want.float(),
                *DECODE_TOL[torch.bfloat16])
    qh, kh, vh = (t.transpose(1, 2).contiguous() for t in (q, k, v))
    mask = (torch.arange(S, device=dev)[None, None, None, :]
            < lens[:, None, :, None])
    # the keys each row's queries read: its longest query's length
    rows = lens.max(dim=1).values.double()
    nbytes = float(2.0 * rows.sum() * NKV * H * 2 + 2.0 * q.numel() * 2
                   + lens.numel() * 4)
    flops = float(4.0 * lens.double().sum() * NQ * H)
    return timed_record(
        f"flash_decode granite-3-2b verify (spec_k 4): B{B} Sq{VERIFY_SQ} "
        f"S_cache {S} ragged fed {list(VERIFY_FED)} {NQ}/{NKV} heads H{H} "
        f"bf16", {
            "kernel": lambda: fa_kernel.flash_decode(q, k, v, lens),
            "plain": lambda: fa_ref.flash_decode(q, k, v, lens),
            "library": lambda: F.scaled_dot_product_attention(
                qh, kh, vh, attn_mask=mask, enable_gqa=True)},
        flops, nbytes, torch.bfloat16, hw, card, err, "kernels-serve-dense")


def phase_kernels_serve_dense(card, hw):
    g = torch.Generator(device="cuda").manual_seed(5)
    return {"flash_decode": kernels_flash_decode(g, hw, card)}


# ---------------------------------------------------------------------------
# phase 5: port on card vs port on CPU
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
    parity_train_step()
    parity_ssm()
    parity_int8()
    parity_dense()
    parity_hybrid()
    parity_cross()
    parity_features()


def engine_tokens(cfg, params_cpu, device, prompts, gens, wrapper):
    """Greedy tokens of the continuous engine (tests/test_serve_families.py's
    set-up: 2 slots, page 8, chunk 4, a 4-page budget) and of the static
    engine, one request at a time; the launches of ``wrapper``'s kernel in
    each, and the forwards of both."""
    model = LM(cfg, device=device)
    params = _to(params_cpu, model.device)
    eng = ContinuousBatchingEngine(model, params, n_slots=2, max_len=32,
                                   page_size=8, prefill_chunk=4,
                                   page_budget=4)
    # counted from here: the paged kernel's split sweep at construction
    # is not the served forwards'
    before = wrapper.launches
    rids = [eng.submit(p, g) for p, g in zip(prompts, gens)]
    out = eng.run()
    reqs = eng.requests()
    if not (sum(r.n_preemptions for r in reqs) >= 1
            and any(r.admit_step > 0 for r in reqs)):
        raise SystemExit(f"{cfg.arch_id} parity: the mix forced no "
                         f"preemption or no mid-run admission")
    cont_launched = wrapper.launches - before
    static = StaticBatchEngine(model, params, max_len=32, batch=1)
    st = [static.generate(p[None], g)[0].tolist()
          for p, g in zip(prompts, gens)]
    static_launched = wrapper.launches - before - cont_launched
    forwards = eng.stats.summary()["forwards"] + static.stats.forwards
    return ([out[r].tolist() for r in rids], st, cont_launched,
            static_launched, forwards)


def parity_ssm():
    """Reduced mamba2-780m in fp32: continuous and static engines agree
    token for token, on the card and on the CPU; the static prefills
    launch the SSD kernel once a layer each, the continuous engine
    never."""
    cfg = reduced_config(SSM_ARCH)
    params = LM(cfg, device="cpu").init_params(
        torch.Generator(device="cpu").manual_seed(0))
    rng = np.random.default_rng(2)
    prompts = [rng.integers(1, cfg.vocab_size, size=n) for n in (15, 15, 7)]
    gens = [5, 4, 6]
    c_card, s_card, c_launch, s_launch, _ = engine_tokens(
        cfg, params, "cuda", prompts, gens, ssd_kernel.ssd_scan_fwd)
    c_cpu, s_cpu, _, _, _ = engine_tokens(cfg, params, "cpu", prompts, gens,
                                          ssd_kernel.ssd_scan_fwd)
    if not (c_card == s_card == c_cpu == s_cpu):
        raise SystemExit(f"ssm greedy tokens differ:\n continuous card "
                         f"{c_card}\n static card {s_card}\n continuous "
                         f"cpu {c_cpu}\n static cpu {s_cpu}")
    if c_launch != 0 or s_launch != cfg.n_layers * len(prompts):
        raise SystemExit(f"ssm parity: SSD launches {c_launch} (continuous) "
                         f"and {s_launch} (static), expected 0 and "
                         f"{cfg.n_layers} x {len(prompts)}")
    log("parity", f"reduced {SSM_ARCH} fp32 ({cfg.n_layers} layers, P "
                  f"{cfg.ssm.head_dim}, N {cfg.ssm.d_state}, chunk "
                  f"{cfg.ssm.chunk_size}): {sum(map(len, c_card))} greedy "
                  f"tokens identical, continuous = static, card = CPU, over "
                  f"{len(prompts)} requests (a preemption, a mid-run "
                  f"admission); SSD launches {s_launch} = {cfg.n_layers} x "
                  f"{len(prompts)} static prefills, 0 continuous")


def parity_int8():
    """Weight-only int8, fp32: reduced granite-3-2b (H 64) and mamba2-780m
    quantized on the CPU; both engines agree token for token, on the card
    and on the CPU; every forward on the card launches the int8 GEMM once
    a q-pack matmul."""
    # per layer: 7 dense packs; 6 Mamba projections; 4 attention packs and
    # 3 an expert (reduced phi3.5-moe: 4 experts)
    for arch, per_layer in ((INT8_ARCH, 7), (SSM_ARCH, 6),
                            (MOE_ARCH, 4 + 3 * 4)):
        cfg = (reduced_config(arch) if arch == SSM_ARCH
               else reduced_config(arch, head_dim=64))
        qparams = quantize_params(LM(cfg, device="cpu").init_params(
            torch.Generator(device="cpu").manual_seed(0)))
        rng = np.random.default_rng(2)
        prompts = [rng.integers(1, cfg.vocab_size, size=n)
                   for n in (15, 15, 7)]
        gens = [5, 4, 6]
        c_card, s_card, c_launch, s_launch, fwd = engine_tokens(
            cfg, qparams, "cuda", prompts, gens, wq_kernel.wq_gemm)
        launched = c_launch + s_launch
        c_cpu, s_cpu, _, _, _ = engine_tokens(cfg, qparams, "cpu", prompts,
                                              gens, wq_kernel.wq_gemm)
        if not (c_card == s_card == c_cpu == s_cpu):
            raise SystemExit(f"{arch} int8 greedy tokens differ:\n "
                             f"continuous card {c_card}\n static card "
                             f"{s_card}\n continuous cpu {c_cpu}\n static "
                             f"cpu {s_cpu}")
        per_fwd = per_layer * cfg.n_layers + 1
        if launched != per_fwd * fwd:
            raise SystemExit(f"{arch} int8: {launched} wq_gemm launches, "
                             f"expected {per_fwd} x {fwd} forwards")
        log("parity", f"reduced {arch} int8 fp32 ({cfg.n_layers} layers): "
                      f"{sum(map(len, c_card))} greedy tokens identical, "
                      f"continuous = static, card = CPU, over "
                      f"{len(prompts)} requests; wq_gemm launches "
                      f"{launched} = {per_fwd} x {fwd} forwards")


PARITY_KERNELS = ("flash_decode", "paged_partials", "ssd_scan", "wq_gemm")


def _engine_parity(cfg, params, *, int8=False):
    """tests/test_serve_families.py's mix (2 slots, page 8, chunk 4, a
    4-page budget and the pages a context pins: a preemption, a mid-run
    admission; a cross-attention family's requests each with a stub
    context drawn as the test's) through the continuous engine with the
    paged kernel off and on, and through the static engine, on the card
    and on the CPU: every run's greedy tokens identical.  On the card,
    with it off the flash-decode kernel launches once an attention layer
    a forward and the paged kernel never, with it on the paged kernel
    once a self-attention layer; a cross layer's decode is one
    flash-decode launch either way (the static prefill attends to the
    context itself: none); the static decode steps launch the
    flash-decode kernel only, the static prefills the SSD kernel once a
    mamba layer (the continuous engine prefills through the recurrence:
    none); with ``int8`` the int8 GEMM ``int8_per_forward`` times a
    forward (a static prefill's count its own) and ``int8_per_install``
    times an admission.  On the CPU none launches.  Returns (the tokens,
    the card's counts)."""
    rng = np.random.default_rng(2)
    prompts = [rng.integers(1, cfg.vocab_size, size=n) for n in (15, 15, 7)]
    gens = [5, 4, 6]
    extras = [stub_context(cfg, rng, scale=0.05) for _ in prompts]
    attn, cross, mamba = attn_layers(cfg), cross_layers(cfg), \
        mamba_layers(cfg)
    per = int8_per_forward(cfg) if int8 else 0
    per_prefill = int8_per_forward(cfg, prefill=True) if int8 else 0
    per_install = int8_per_install(cfg) if int8 else 0
    aux = -(-get_adapter(cfg.family).context_tokens(cfg) // 8)
    outs, counts = {}, []

    def require(what, device, want):
        got = {n: launches_of(n) for n in PARITY_KERNELS}
        if device != "cuda":
            want = dict.fromkeys(PARITY_KERNELS, 0)
        if got != want:
            raise SystemExit(f"{cfg.arch_id} {what} on {device}: launches "
                             f"{got}, expected {want}")
        if device == "cuda":
            counts.append(f"{what}: " + " / ".join(
                str(got[n]) for n in PARITY_KERNELS))

    for device in ("cuda", "cpu"):
        model = LM(cfg, device=device)
        p = _to(params, model.device)
        for paged in (False, True):
            eng = ContinuousBatchingEngine(
                model, p, n_slots=2, max_len=32, page_size=8,
                prefill_chunk=4, page_budget=4 + 2 * aux,
                paged_kernel=paged)
            reset_launches(PARITY_KERNELS)   # after the split sweep
            rids = [eng.submit(pr, g, extra=e)
                    for pr, g, e in zip(prompts, gens, extras)]
            out = eng.run()
            reqs = eng.requests()
            if not (sum(r.n_preemptions for r in reqs) >= 1
                    and any(r.admit_step > 0 for r in reqs)):
                raise SystemExit(f"{cfg.arch_id} parity: the mix forced no "
                                 f"preemption or no mid-run admission")
            fwd = eng.stats.forwards
            require(f"paged_kernel={paged} ({fwd} forwards)", device, {
                "flash_decode": (cross if paged else attn + cross) * fwd,
                "paged_partials": attn * fwd if paged else 0,
                "ssd_scan": 0,
                "wq_gemm": per * fwd + per_install * _admissions(eng)})
            outs[device, paged] = [out[r].tolist() for r in rids]
        reset_launches(PARITY_KERNELS)
        static = StaticBatchEngine(model, p, max_len=32, batch=1)
        outs[device, "static"] = [
            static.generate(pr[None], g, extra=None if e is None else
                            {k: v[None] for k, v in e.items()})[0].tolist()
            for pr, g, e in zip(prompts, gens, extras)]
        decode_fwd = sum(g - 1 for g in gens)
        require("static", device, {
            "flash_decode": (attn + cross) * decode_fwd,
            "paged_partials": 0, "ssd_scan": mamba * len(prompts),
            "wq_gemm": per_prefill * len(prompts) + per * decode_fwd})
    first = outs["cuda", False]
    if not all(o == first for o in outs.values()):
        raise SystemExit(f"{cfg.arch_id} engine parity: greedy tokens "
                         f"differ: {outs}")
    return first, counts


def parity_dense():
    """Reduced granite-3-2b, qwen3-1.7b, phi3.5-moe-42b and grok-1-314b
    (softcap 30, its heads set to 6/1 for grok's G 6) in fp32 at H 64 (a
    width both decode kernels take) through ``_engine_parity``."""
    for arch, extra in ((INT8_ARCH, {}), (DENSE_ARCH, {}), (MOE_ARCH, {}),
                        (GROK_ARCH, dict(n_heads=6, n_kv_heads=1))):
        cfg = reduced_config(arch, head_dim=64, **extra)
        params = LM(cfg, device="cpu").init_params(
            torch.Generator(device="cpu").manual_seed(0))
        first, counts = _engine_parity(cfg, params)
        log("parity", f"reduced {arch} fp32 (H 64, {cfg.n_heads}/"
                      f"{cfg.n_kv_heads} heads, softcap "
                      f"{cfg.attn_logit_softcap:g}, {cfg.n_layers} layers): "
                      f"{sum(map(len, first))} greedy tokens identical, "
                      f"continuous paged_kernel=False = True = static, card "
                      f"= CPU, over 3 requests (a preemption, a mid-run "
                      f"admission); card launches (flash_decode / "
                      f"paged_partials / ssd_scan / wq_gemm) "
                      f"{'; '.join(counts)}")


def parity_hybrid():
    """Reduced jamba-v0.1-52b (one period: attention at s4, 7 mamba
    sub-layers, MoE on s1, s3, s5, s7) at H 64 through ``_engine_parity``,
    in fp32 and then quantized to int8 on the CPU (the int8 GEMM
    ``int8_per_forward`` = 107 times a forward)."""
    cfg = reduced_config(HYBRID_ARCH, head_dim=64)
    params = LM(cfg, device="cpu").init_params(
        torch.Generator(device="cpu").manual_seed(0))
    for int8 in (False, True):
        first, counts = _engine_parity(
            cfg, quantize_params(params) if int8 else params, int8=int8)
        log("parity", f"reduced {HYBRID_ARCH} {'int8' if int8 else 'fp32'} "
                      f"(H 64, {attn_layers(cfg)} attention and "
                      f"{mamba_layers(cfg)} mamba layers, "
                      f"{cfg.moe.num_experts} experts): "
                      f"{sum(map(len, first))} greedy tokens "
                      f"identical, continuous paged_kernel=False = True = "
                      f"static, card = CPU, over 3 requests (a preemption, a "
                      f"mid-run admission); card launches (flash_decode / "
                      f"paged_partials / ssd_scan / wq_gemm) "
                      f"{'; '.join(counts)}")


def set_gates(params, value):
    """Every cross layer's ``gate_attn`` set to ``value``, in place (test
    data: at its zero init tanh(0) drops the cross path from the output,
    so the context would not matter)."""
    if isinstance(params, list):
        for p in params:
            set_gates(p, value)
    elif isinstance(params, dict):
        for k, v in params.items():
            if k == "gate_attn":
                v.fill_(value)
            else:
                set_gates(v, value)
    return params


def parity_cross():
    """Reduced llama-3.2-vision-90b (one period: 4 attention layers and
    the gated cross layer over 16 image tokens; G 4) and whisper-base (2
    encoder and 2 decoder layers over 24 audio frames; G 1, its
    cross-attention ungated), at H 64, every gate_attn set to 0.5,
    through ``_engine_parity`` in fp32 and then quantized to int8 on the
    CPU."""
    for arch in (VLM_ARCH, AUDIO_ARCH):
        cfg = reduced_config(arch, head_dim=64)
        params = set_gates(LM(cfg, device="cpu").init_params(
            torch.Generator(device="cpu").manual_seed(0)), 0.5)
        for int8 in (False, True):
            first, counts = _engine_parity(
                cfg, quantize_params(params) if int8 else params, int8=int8)
            log("parity", f"reduced {arch} {'int8' if int8 else 'fp32'} "
                          f"(H 64, {cfg.n_heads}/{cfg.n_kv_heads} heads, "
                          f"{attn_layers(cfg)} self-attention and "
                          f"{cross_layers(cfg)} cross layers"
                          f"{', gate_attn 0.5' if cfg.cross_attn_period else ''}"
                          f"): {sum(map(len, first))} greedy tokens "
                          f"identical, continuous paged_kernel=False = "
                          f"True = static, card = CPU, over 3 requests with "
                          f"contexts (a preemption and its re-install, a "
                          f"mid-run admission); card launches (flash_decode "
                          f"/ paged_partials / ssd_scan / wq_gemm) "
                          f"{'; '.join(counts)}")


# the serving features on the card (phase 5): each family's reduced
# config (H 64 where it has attention), every gate_attn 0.5, fp32
FEATURE_ARCHS = (INT8_ARCH, SSM_ARCH, MOE_ARCH, HYBRID_ARCH, VLM_ARCH,
                 AUDIO_ARCH)
# tests/test_serve_spec.py's mix (the first prompt motif-tiled) and
# tests/test_serve_prefix.py's (a shared 14-token prefix), both on 2
# slots under a 4-page budget plus the pages a context pins: a
# preemption each
SPEC_MIX = ((15, 6), (15, 5), (7, 6))
PREFIX_MIX = ((1, 4), (2, 3), (3, 3))


def _no_errors(what, *engines):
    errors = [f.format() for e in engines for f in e.check_findings
              if f.severity == "error"]
    if errors:
        raise SystemExit(f"{what}: the shadow checker found "
                         + "; ".join(errors))


def oracle_drafts(eng, want, vocab):
    """Replace the engine's drafter proposals by the next ``spec_k``
    tokens the spec-off run gave the request (``want``: rid -> tokens),
    the second made wrong every other proposal, and never throttle:
    drafts are then made, accepted and rejected on every family, where a
    random model's own n-grams seldom recur.  Greedy acceptance must keep
    the tokens whatever is drafted."""
    calls = [0]
    plen = {}

    def propose(rid, k=None):
        h = eng.drafter.history(rid)
        n_gen = len(h) - plen[rid]
        d = np.array(want[rid][n_gen:n_gen + eng.spec_k], np.int32)
        calls[0] += 1
        if len(d) > 1 and calls[0] % 2:
            d[1] = (d[1] + 1) % vocab
        return d

    real_add = eng.drafter.add_request

    def add_request(rid, prompt):
        plen[rid] = len(np.asarray(prompt).reshape(-1))
        real_add(rid, prompt)

    eng.drafter.propose = propose
    eng.drafter.add_request = add_request
    eng.drafter.throttled = lambda *a, **kw: False


def _feature_run(model, params, prompts, gens, extras, oracle=None, **kw):
    """The engine (``kw``: its feature options; ``oracle``: the tokens
    ``oracle_drafts`` drafts from) on a phase-5 mix under the checker,
    which must preempt; returns (the engine, {rid: tokens})."""
    cfg = model.cfg
    aux = -(-get_adapter(cfg.family).context_tokens(cfg) // 8)
    eng = ContinuousBatchingEngine(model, params, n_slots=2, max_len=32,
                                   page_size=8, prefill_chunk=4,
                                   page_budget=4 + 2 * aux, check=True,
                                   **kw)
    if oracle is not None:
        oracle_drafts(eng, oracle, cfg.vocab_size)
    rids = [eng.submit(p, g, extra=e)
            for p, g, e in zip(prompts, gens, extras)]
    out = eng.run()
    if sum(r.n_preemptions for r in eng.requests()) < 1:
        raise SystemExit(f"{cfg.arch_id} features: the mix forced no "
                         f"preemption")
    return eng, {r: out[r].tolist() for r in rids}


def parity_features():
    """Every family's reduced config (granite, mamba2, phi3.5-moe, jamba,
    llama-3.2-vision, whisper; H 64, fp32, gate_attn 0.5) on the card,
    every engine under the shadow checker: ``spec_decode=True, spec_k=4``
    (drafts from ``oracle_drafts``) against it off on SPEC_MIX, and
    ``prefix_cache=True`` against it off on PREFIX_MIX: identical greedy
    tokens, drafts made and some accepted, prefix hits where the family
    can share a prefix (none for ssm and hybrid), no error finding."""
    for arch in FEATURE_ARCHS:
        cfg = (reduced_config(arch) if arch == SSM_ARCH
               else reduced_config(arch, head_dim=64))
        params = set_gates(LM(cfg, device="cpu").init_params(
            torch.Generator(device="cpu").manual_seed(0)), 0.5)
        model = LM(cfg, device="cuda")
        p = _to(params, model.device)
        rng = np.random.default_rng(3)
        prompts = [np.tile(rng.integers(1, cfg.vocab_size, size=2),
                           SPEC_MIX[0][0])[:SPEC_MIX[0][0]]]
        prompts += [rng.integers(1, cfg.vocab_size, size=n)
                    for n, _ in SPEC_MIX[1:]]
        gens = [g for _, g in SPEC_MIX]
        extras = [stub_context(cfg, rng, scale=0.05) for _ in SPEC_MIX]
        off, want = _feature_run(model, p, prompts, gens, extras)
        spec, got = _feature_run(model, p, prompts, gens, extras,
                                 spec_decode=True, spec_k=4, oracle=want)
        s = spec.stats.summary()
        verify = sum(st.verify for st in spec.stats.steps)
        if got != want or not s["drafted_tokens"] or not s["accept_rate"]:
            raise SystemExit(f"{arch} spec parity: tokens {got} vs {want}, "
                             f"drafted {s['drafted_tokens']}, accept_rate "
                             f"{s['accept_rate']}")
        rng = np.random.default_rng(4)
        shared = rng.integers(1, cfg.vocab_size, size=14)
        pprompts = [np.concatenate([shared, rng.integers(
            1, cfg.vocab_size, size=n)]) for n, _ in PREFIX_MIX]
        pgens = [g for _, g in PREFIX_MIX]
        ctx = stub_context(cfg, rng, scale=0.05)
        cold, cold_t = _feature_run(model, p, pprompts, pgens,
                                    [ctx] * len(PREFIX_MIX))
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            warm, warm_t = _feature_run(model, p, pprompts, pgens,
                                        [ctx] * len(PREFIX_MIX),
                                        prefix_cache=True)
        hits = warm.stats.summary()["prefix_hit_tokens"]
        cachable = get_adapter(cfg.family).prefix_cachable
        if warm_t != cold_t or (hits > 0) != cachable:
            raise SystemExit(f"{arch} prefix parity: tokens {warm_t} vs "
                             f"{cold_t}, hits {hits} (cachable "
                             f"{cachable})")
        _no_errors(f"{arch} features", off, spec, cold, warm)
        log("parity", f"reduced {arch} fp32 on the card, check=True: "
                      f"spec_decode (spec_k 4) = off, "
                      f"{sum(map(len, got.values()))} greedy tokens, "
                      f"{verify} verify steps, drafted "
                      f"{s['drafted_tokens']}, accept_rate "
                      f"{s['accept_rate']:.3f}, forwards "
                      f"{spec.stats.forwards} vs {off.stats.forwards}"
                      f"{' (two-pass)' if spec.snapshot_bytes else ''}; "
                      f"prefix_cache = off, "
                      f"{sum(map(len, warm_t.values()))} tokens, "
                      f"prefix_hit_tokens {hits}"
                      f"{'' if cachable else ' (pool off: recurrent)'}; "
                      f"a preemption in each run; no error finding")
        del model, p, off, spec, cold, warm
    torch.cuda.empty_cache()


def parity_train_step():
    """One train step of reduced qwen3-1.7b (fp32, H 32, flash kernel on
    the card, its plain version on the CPU) through
    ``train.parity.card_step_matches_cpu``: loss and grad norm within 1e-4
    relative, the kernel launched once per layer."""
    cfg = reduced_config(TRAIN_ARCH, attention_impl="pallas")
    params = LM(cfg, device="cpu").init_params(
        torch.Generator(device="cpu").manual_seed(0))
    got, launched = card_step_matches_cpu(cfg, params, batch=4, seq=128)
    log("parity", f"reduced {TRAIN_ARCH} fp32 train step, batch 4 x 128: "
                  f"loss {got['cuda']['loss']:.6f} card vs "
                  f"{got['cpu']['loss']:.6f} CPU, grad norm "
                  f"{got['cuda']['grad_norm']:.6f} vs "
                  f"{got['cpu']['grad_norm']:.6f}; flash launches "
                  f"{launched['flash_attention']}")


# ---------------------------------------------------------------------------
# phase 6: serve at full width
# ---------------------------------------------------------------------------
SERVE_KERNELS = ("wq_gemm", "flash_decode", "paged_partials", "ssd_scan")


def cross_layers(cfg) -> int:
    """Cross-attention layers: the vlm's one a period, one an audio
    decoder layer."""
    if cfg.cross_attn_period:
        return cfg.n_layers // cfg.cross_attn_period
    return cfg.n_layers if cfg.is_encdec else 0


def attn_layers(cfg) -> int:
    """Self-attention layers (not the vlm's cross layers)."""
    n = sum(cfg.layer_kind(i) == "attn" for i in range(cfg.n_layers))
    return n - cross_layers(cfg) if cfg.cross_attn_period else n


def mamba_layers(cfg) -> int:
    return sum(cfg.layer_kind(i) == "mamba" for i in range(cfg.n_layers))


def _ffn_packs(cfg, i) -> int:
    if cfg.layer_uses_moe(i):
        return 3 * cfg.moe.num_experts
    if not cfg.d_ff:
        return 0
    return 2 if cfg.mlp_type == "gelu" else 3


def int8_per_forward(cfg, prefill: bool = False) -> int:
    """int8 GEMM launches a forward: a layer's 4 attention packs or 6
    mamba projections (the vlm's cross layer none), its cross-attention's
    wq and wo (with ``prefill``, wk and wv of the context too: 4), then
    3 an expert (an MoE layer), 3 (a SwiGLU MLP) or 2 (GELU; an ssm
    layer has none), then the unembed; with ``prefill`` an enc-dec's
    encoder layers too.  Decode mode, the continuous engine's every
    forward, projects no context."""
    xattn = 4 if prefill else 2
    per = cfg.cross_attn_period
    n = 1
    for i in range(cfg.n_layers):
        if per and i % per == per - 1:
            n += xattn
        else:
            n += 4 if cfg.layer_kind(i) == "attn" else 6
            n += xattn if cfg.is_encdec else 0
        n += _ffn_packs(cfg, i)
    if prefill and cfg.is_encdec:
        n += cfg.n_encoder_layers * (4 + _ffn_packs(cfg, 0))
    return n


def int8_per_install(cfg) -> int:
    """int8 GEMM launches of one admission's context install: each cross
    layer's wk and wv over the context, after the encoder (audio)."""
    n = 2 * cross_layers(cfg)
    if cfg.is_encdec:
        n += cfg.n_encoder_layers * (4 + _ffn_packs(cfg, 0))
    return n


def _admissions(eng) -> int:
    """Admissions of an engine's run, re-admissions after preemption
    included: each installs its request's context once."""
    return sum(1 + r.n_preemptions for r in eng.requests())


def _served_cfg(arch, layers=None):
    return get_config(arch, **({} if layers is None
                               else {"n_layers": layers}))


def serve_static(phase, arch, card, *, int8, layers=None,
                 shape=MOE_STATIC):
    """``launch.serve.run(static=True)`` at ``shape`` (MOE_STATIC: 8 x 512
    + 32): the decode through the flash-decode kernel (one launch an
    attention layer, cross layers included, and decode forward; none in
    the prefill), the paged kernel never, the SSD kernel once a mamba
    layer (the prefill), the int8 GEMM ``int8_per_forward`` a forward
    with ``int8`` (else never).  A cross-attention family's batched stub
    context is the launcher's.  Returns the launches of SERVE_KERNELS, and
    the result's ``param_bytes``, ``init_peak_gib`` and ``peak_gib``."""
    cfg = _served_cfg(arch, layers)
    torch.cuda.empty_cache()
    reset_launches(SERVE_KERNELS)
    res = launch_serve.run(arch, static=True, int8=int8, layers=layers,
                           **shape)
    got = {n: launches_of(n) for n in SERVE_KERNELS}
    decode_fwd = res["forwards"] - 1
    attn = attn_layers(cfg) + cross_layers(cfg)
    per = int8_per_forward(cfg) if int8 else 0
    per_prefill = int8_per_forward(cfg, prefill=True) if int8 else 0
    want = {"wq_gemm": per_prefill + per * decode_fwd,
            "flash_decode": attn * decode_fwd,
            "paged_partials": 0, "ssd_scan": mamba_layers(cfg)}
    if got != want:
        raise SystemExit(f"{phase} {arch} static: launches {got}, expected "
                         f"{want}")
    _check_tokens(f"{arch} static", res["tokens"], shape["gen_len"],
                  cfg.padded_vocab)
    cut = "" if layers is None else f", cut to {layers} layers"
    log(phase, f"(a) {arch} {'int8' if int8 else 'bf16'} full width{cut}, "
               f"StaticBatchEngine via launch.serve.run: "
               f"{shape['slots']} x {shape['prompt_len']} prompt "
               f"tokens, {res['generated_tokens']} tokens | prefill "
               f"{res['prefill_ms']:.3f} ms, decode step p50 "
               f"{res['step_ms_p50']:.3f} ms, {res['tokens_per_s']:.1f} "
               f"tok/s over {res['run_ms']:.1f} ms | param_bytes "
               f"{res['param_bytes'] / 1e9:.3f} GB (the bf16 tree "
               f"{res['init_param_bytes'] / 1e9:.3f} GB, reckoned"
               f"{', never allocated' if int8 else ''}), peak after init "
               f"{res['init_peak_gib']:.2f} GiB | launches wq_gemm "
               f"{got['wq_gemm']} = {per_prefill} + {per} x {decode_fwd} "
               f"forwards, flash_decode "
               f"{got['flash_decode']} = {attn} x {decode_fwd} decode "
               f"forwards, paged_partials 0, ssd_scan {got['ssd_scan']} | "
               f"peak serving {res['peak_gib']:.2f} GiB | {card}")
    sizes = {k: res[k] for k in ("param_bytes", "init_peak_gib",
                                 "peak_gib")}
    del res
    torch.cuda.empty_cache()
    return got, sizes


def serve_mix(phase, model, params, n_req, card, *, int8,
              paged_kernel=True):
    """The ContinuousBatchingEngine at phase 6's request mix (``n_req``
    requests of 32-256 prompt tokens, 32 new; ``paged_kernel`` as the
    engine's; a cross-attention family's requests each with a stub
    context): the paged kernel (or with ``paged_kernel=False`` the
    flash-decode kernel) one launch a self-attention layer and forward
    and the other never, the flash-decode kernel one a cross layer and
    forward, the SSD kernel never (a recurrent prefill runs token by
    token), the int8 GEMM ``int8_per_forward`` a forward and
    ``int8_per_install`` an admission with ``int8``.  Returns (the
    launches of SERVE_KERNELS, the engine, each request's tokens)."""
    cfg = model.cfg
    eng = ContinuousBatchingEngine(model, params, paged_kernel=paged_kernel,
                                   **MIX)
    rng = np.random.default_rng(0)
    prompts = [rng.integers(1, cfg.vocab_size, size=int(n))
               for n in rng.integers(32, 257, size=n_req)]
    ctx_rng = np.random.default_rng(1)
    rids = [eng.submit(p, MIX_NEW, extra=stub_context(cfg, ctx_rng))
            for p in prompts]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launches(SERVE_KERNELS)
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    out = eng.run()
    end.record()
    end.synchronize()
    got = {n: launches_of(n) for n in SERVE_KERNELS}
    run_ms = start.elapsed_time(end)
    if sorted(out) != sorted(rids):
        raise SystemExit(f"{phase} continuous: not every request finished")
    _check_tokens(f"{cfg.arch_id} continuous", out, MIX_NEW,
                  cfg.padded_vocab)
    st = eng.stats.summary()
    fwd = st["forwards"]
    # attention launches: one a self-attention layer and forward, the
    # paged kernel's or the flash-decode kernel's; one a cross layer and
    # forward, the flash-decode kernel's
    attn, cross = attn_layers(cfg) * fwd, cross_layers(cfg) * fwd
    admitted = _admissions(eng)
    per = int8_per_forward(cfg) if int8 else 0
    per_install = int8_per_install(cfg) if int8 else 0
    want = {"wq_gemm": per * fwd + per_install * admitted,
            "flash_decode": cross + (0 if paged_kernel else attn),
            "paged_partials": attn if paged_kernel else 0, "ssd_scan": 0}
    if got != want or fwd == 0:
        raise SystemExit(f"{phase} continuous: launches {got}, expected "
                         f"{want}")
    decode_ms = sorted(s_.device_ms() for s_ in eng.stats.steps
                       if s_.n_decode and not s_.n_prefill_tokens)
    p50 = decode_ms[len(decode_ms) // 2] if decode_ms else float("nan")
    gen_tok = st["generated_tokens"]
    attn_kernel = "paged_partials" if paged_kernel else "flash_decode"
    xline = (f", flash_decode {got['flash_decode']} = "
             f"{cross_layers(cfg)} cross x {fwd}"
             if cross and paged_kernel else "")
    log(phase, f"{cfg.arch_id} {'int8' if int8 else 'bf16'} full width "
               f"({cfg.n_layers} layers), ContinuousBatchingEngine("
               f"paged_kernel={paged_kernel}): {n_req} requests "
               f"({sum(r.admit_step > 0 for r in eng.requests())} admitted "
               f"mid-run, {admitted} admissions), {gen_tok} tokens in "
               f"{st['steps']} steps / {fwd} "
               f"forwards | {gen_tok / (run_ms / 1e3):.1f} tok/s over "
               f"{run_ms:.1f} ms | step p50 {st['step_ms_p50']:.3f} ms, "
               f"pure-decode step p50 {p50:.3f} ms ({len(decode_ms)} steps)"
               f" | launches {attn_kernel} {got[attn_kernel]} = "
               f"{attn_layers(cfg)}{'' if paged_kernel or not cross else f' + {cross_layers(cfg)}'}"
               f" x {fwd}{xline}, wq_gemm "
               f"{got['wq_gemm']} = {per} x {fwd} + {per_install} x "
               f"{admitted} admissions | peak "
               f"{torch.cuda.max_memory_allocated() / 2 ** 30:.2f} GiB | "
               f"{card}")
    return got, eng, [np.asarray(out[r]) for r in rids]


def phase_serve(card, profile):
    """Full-width granite-3-2b in bf16 through the continuous engine at
    phase 6's mix (the paged kernel 40 launches a forward), then finite
    logits of the expected shape from one forward.  Returns the paged
    kernel's launches."""
    cfg = get_config("granite-3-2b")
    model = LM(cfg)                                   # cuda, bf16
    params = model.init_params(
        torch.Generator(device=model.device).manual_seed(0))
    got, eng, _ = serve_mix("serve", model, params, 16, card, int8=False)
    # finite logits of the expected shape on the card, through the kernel
    cache = model.init_cache(1, 512)
    p0 = torch.randint(1, cfg.vocab_size, (1, 100), device=model.device)
    logits, _ = model.forward(params, p0,
                              torch.arange(p0.shape[1],
                                           device=model.device)[None],
                              cache=cache)
    if logits.shape != (1, p0.shape[1], cfg.padded_vocab) or \
            not torch.isfinite(logits).all():
        raise SystemExit(f"bad logits {tuple(logits.shape)}")
    if profile:
        profile_decode(model, params, card, "granite-3-2b bf16",
                       eng._page_idx)
    return got["paged_partials"]


def profile_decode(model, params, card, what, page_idx=None):
    """Kernels-busy share of pure batched decode forwards (8 rows, 288
    tokens of context for the attention layers; the ssm's state has no
    length) under torch.profiler: kernel rows only, as in
    ``profile_train_step``."""
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.models.attention import PagedDecodeState
    cache = model.init_cache(8, 512)
    toks = torch.ones((8, 1), dtype=torch.long, device=model.device)
    pos = torch.full((8, 1), 288, dtype=torch.long, device=model.device)
    paged = None if page_idx is None else PagedDecodeState(page_idx, 16)

    def step():
        if model.decode_state.paged:
            _pos(model, cache).fill_(288)
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
    kernels, _ = _kernel_rows(prof, 5)
    busy = sum(r[1] for r in kernels)
    log("profile", f"{what} decode forward (8 x 1): {wall:.3f} ms between "
                   f"events, kernels busy {busy:.3f} ms "
                   f"({100 * busy / wall:.1f}%), "
                   f"{sum(r[2] for r in kernels)} kernel launches | {card}")
    for key, ms, n in sorted(kernels, key=lambda r: -r[1])[:8]:
        log("profile", f"  kernel {ms:.4f} ms/forward  x{n}  {key[:70]}")


def profile_prefill(model, params, card, what, batch=8, seq=512,
                    extra=None):
    """One static prefill forward (``batch`` x ``seq``; a cross-attention
    family's batched context in ``extra``): its first call in this
    process and its warm median (``measure``, no cover: host-paced), then
    its kernel rows under torch.profiler, as ``profile_decode``."""
    from torch.profiler import ProfilerActivity, profile
    g = torch.Generator(device=model.device).manual_seed(1)
    toks = torch.randint(1, model.cfg.vocab_size, (batch, seq), generator=g,
                         device=model.device)
    pos = torch.arange(seq, device=model.device)[None].expand(batch, seq)

    def fwd():
        model.forward(params, toks, pos, mode="prefill",
                      cache=model.init_cache(batch, seq), extra=extra)

    m = measure(fwd, reps=3, cover_ms=0.0)
    log("profile", f"{what} prefill forward ({batch} x {seq}): its first call here "
                   f"{m.first_s * 1e3:.3f} ms, warm median "
                   f"{m.median_s * 1e3:.3f} ms (CUDA events, 3 reps) | "
                   f"{card}")
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        start.record()
        fwd()
        end.record()
        end.synchronize()
    wall = start.elapsed_time(end)
    kernels, _ = _kernel_rows(prof, 1)
    busy = sum(r[1] for r in kernels)
    log("profile", f"{what} prefill forward ({batch} x {seq}): {wall:.3f} "
                   f"ms between events, kernels busy {busy:.3f} ms "
                   f"({100 * busy / wall:.1f}%), "
                   f"{sum(r[2] for r in kernels)} kernel launches | {card}")
    for key, ms, n in sorted(kernels, key=lambda r: -r[1])[:8]:
        log("profile", f"  kernel {ms:.4f} ms/forward  x{n}  {key[:70]}")


def _kernel_rows(prof, n):
    """(kernels, ops) of a profile, per one of its n repeats: (key, device
    ms, count).  Kernels are the device events; the ops and annotations
    that launched them are kept apart, since their device time would
    count the same kernels again."""
    from torch.autograd import DeviceType
    kernels, ops = [], []
    for e in prof.key_averages():
        if getattr(e, "is_user_annotation", False):
            continue
        row = (e.key, _device_us(e) / 1e3 / n, e.count // n)
        if e.device_type == DeviceType.CUDA:
            kernels.append(row)
        elif row[1] > 0:
            ops.append(row)
    return kernels, ops


# ---------------------------------------------------------------------------
# phase 6b: serve mamba2-780m at full width
# ---------------------------------------------------------------------------
def _check_tokens(what, tokens, n_new, vocab):
    for rid, toks in tokens.items():
        toks = np.asarray(toks)
        if len(toks) != n_new or toks.min() < 0 or toks.max() >= vocab:
            raise SystemExit(f"{what} request {rid}: bad tokens "
                             f"{toks.tolist()}")


def _recurrence_vs_kernel(cfg, prompt):
    """One prompt through ``mode="prefill"`` (the SSD kernel) and through
    ``mode="decode"`` (the recurrence, as the continuous engine prefills)
    from a zero state: each layer's max |h_rec - h_kernel| / max
    |h_kernel|, and both first greedy tokens."""
    model = LM(cfg)
    params = model.init_params(
        torch.Generator(device=model.device).manual_seed(0))
    S = len(prompt)
    toks = torch.as_tensor(prompt, device=model.device)[None]
    pos = torch.arange(S, device=model.device)[None]
    lk, kc = model.forward(params, toks, pos, mode="prefill",
                           cache=model.init_cache(1, S))
    lr, rc = model.forward(params, toks, pos, mode="decode",
                           cache=model.init_cache(1, S))
    for what, lg in (("prefill", lk), ("recurrence", lr)):
        if lg.shape != (1, S, cfg.padded_vocab) or \
                not bool(torch.isfinite(lg).all()):
            raise SystemExit(f"(c) {what}: bad logits {tuple(lg.shape)}")
    rel = [float((rc["h"][i] - kc["h"][i]).abs().max()
                 / kc["h"][i].abs().max()) for i in range(cfg.n_layers)]
    first = (int(lk[0, -1].argmax()), int(lr[0, -1].argmax()))
    del model, params, kc, rc, lk, lr
    torch.cuda.empty_cache()
    return rel, first


def phase_serve_ssm(card, profile=False):
    """Full-width mamba2-780m in bf16: (a) the static engine through
    ``launch.serve.run`` (the SSD kernel prefills, once a layer); (b) the
    continuous engine (recurrent prefill, no SSD launch); (c) the
    recurrence against the kernel's final state on one prompt.  Returns
    the SSD launches of (a)."""
    t0 = datetime.datetime.now()
    cfg = get_config(SSM_ARCH)
    torch.cuda.empty_cache()
    ssd_kernel.ssd_scan_fwd.launches = 0
    res = launch_serve.run(SSM_ARCH, static=True, **SSM_STATIC)
    launches = ssd_kernel.ssd_scan_fwd.launches
    _check_tokens("static", res["tokens"], SSM_STATIC["gen_len"],
                  cfg.padded_vocab)
    if launches != cfg.n_layers:            # one prefill of the batch
        raise SystemExit(f"static: {launches} SSD launches, expected "
                         f"{cfg.n_layers} x 1 prefill")
    B, S = SSM_STATIC["slots"], SSM_STATIC["prompt_len"]
    log("serve-ssm", f"(a) {SSM_ARCH} bf16 full width, StaticBatchEngine "
                     f"via launch.serve.run: {B} x {S} prompt tokens, "
                     f"{res['generated_tokens']} tokens | prefill "
                     f"{res['prefill_ms']:.3f} ms, decode step p50 "
                     f"{res['step_ms_p50']:.3f} ms, {res['tokens_per_s']:.1f} "
                     f"tok/s over {res['run_ms']:.1f} ms | SSD launches "
                     f"{launches} = {cfg.n_layers} x 1 prefill | peak "
                     f"{res['peak_gib']:.2f} GiB | {card}")
    prompt0 = np.asarray(res["prompts"][0])
    del res
    torch.cuda.empty_cache()

    # (b) the continuous engine, SSM_MIX_REQUESTS requests drawn as phase
    # 6's (its recurrent prefill runs token by token), SSM_MIX_LAYERS deep
    model = LM(get_config(SSM_ARCH, n_layers=SSM_MIX_LAYERS))
    params = model.init_params(
        torch.Generator(device=model.device).manual_seed(0))
    ssd_kernel.ssd_scan_fwd.launches = 0
    _, eng, _ = serve_mix("serve-ssm", model, params, SSM_MIX_REQUESTS, card,
                          int8=False)
    if ssd_kernel.ssd_scan_fwd.launches:
        raise SystemExit(f"continuous: {ssd_kernel.ssd_scan_fwd.launches} "
                         f"SSD launches, its prefill is the recurrence")
    if profile:
        profile_decode(model, params, card, f"{SSM_ARCH} bf16")
    del eng, model, params
    torch.cuda.empty_cache()

    # (c) the recurrence against the kernel's final state, the first
    # SSM_RECURRENCE_LEN tokens of one prompt; in bf16 as served, then in
    # fp32 (the same weights before rounding)
    prompt0 = prompt0[:SSM_RECURRENCE_LEN]
    for cfg_c in (cfg, get_config(SSM_ARCH, param_dtype="float32",
                                  compute_dtype="float32")):
        rel, first = _recurrence_vs_kernel(cfg_c, prompt0)
        log("serve-ssm", f"(c) one {len(prompt0)}-token prompt, "
                         f"{cfg_c.compute_dtype}: "
                         f"recurrence vs SSD-kernel prefill, max relative "
                         f"error of h: layer 0 {rel[0]:.2e}, median "
                         f"{statistics.median(rel):.2e}, max {max(rel):.2e} "
                         f"(layer {int(np.argmax(rel))}); first greedy token "
                         f"{first[0]} vs {first[1]} "
                         f"({'agrees' if first[0] == first[1] else 'differs'})"
                         f"; phase wall {_since(t0):.1f} s | {card}")
    return launches


# ---------------------------------------------------------------------------
# phase 6c: serve granite-3-2b in weight-only int8 at full width
# ---------------------------------------------------------------------------
def _static_line(what, res, launches, per_fwd, card):
    gb = res["init_param_bytes"] / 1e9
    trees = (f"bf16 tree {gb:.3f} GB -> int8 tree "
             f"{res['param_bytes'] / 1e9:.3f} GB (freed the bf16)"
             if res["int8"] else f"bf16 tree {gb:.3f} GB")
    log("serve-int8", f"(a) {what} {INT8_ARCH} full width, StaticBatchEngine "
                      f"via launch.serve.run: {INT8_STATIC['slots']} x "
                      f"{INT8_STATIC['prompt_len']} prompt tokens, "
                      f"{res['generated_tokens']} tokens | prefill "
                      f"{res['prefill_ms']:.3f} ms, decode step p50 "
                      f"{res['step_ms_p50']:.3f} ms, "
                      f"{res['tokens_per_s']:.1f} tok/s over "
                      f"{res['run_ms']:.1f} ms | {trees} | wq_gemm launches "
                      f"{launches} = {per_fwd} x {res['forwards']} forwards"
                      f" | peak {res['peak_gib']:.2f} GiB | {card}")


def phase_serve_int8(card, profile=False):
    """Full-width granite-3-2b: (a) the static engine through
    ``launch.serve.run``, bf16 (the dense prefill mode) and then int8;
    (b) the continuous engine in int8 at phase 6's request mix.  Every
    int8 forward launches the int8 GEMM 7 x 40 + 1 times, a bf16 forward
    never.  Returns the int8 GEMM's launches of (a) and (b)."""
    t0 = datetime.datetime.now()
    cfg = get_config(INT8_ARCH)
    per_fwd = int8_per_forward(cfg)
    runs, total = {}, 0
    for int8 in (False, True):
        torch.cuda.empty_cache()
        reset_launches(("wq_gemm", "flash_decode", "paged_partials"))
        res = launch_serve.run(INT8_ARCH, static=True, int8=int8,
                               **INT8_STATIC)
        launches = wq_kernel.wq_gemm.launches
        decode = (launches_of("flash_decode"), launches_of("paged_partials"))
        if decode != (cfg.n_layers * (res["forwards"] - 1), 0):
            raise SystemExit(f"static int8={int8}: (flash_decode, "
                             f"paged_partials) launches {decode}, expected "
                             f"{cfg.n_layers} x {res['forwards'] - 1} decode "
                             f"forwards and 0")
        log("serve-int8", f"(a) {'int8' if int8 else 'bf16'} static decode "
                          f"through the dense-cache flash-decode kernel: "
                          f"{decode[0]} launches = {cfg.n_layers} x "
                          f"{res['forwards'] - 1} decode forwards, 0 "
                          f"paged_partials")
        _check_tokens("static int8" if int8 else "static bf16",
                      res["tokens"], INT8_STATIC["gen_len"], cfg.padded_vocab)
        if launches != (per_fwd * res["forwards"] if int8 else 0):
            raise SystemExit(f"static int8={int8}: {launches} wq_gemm "
                             f"launches, expected {per_fwd if int8 else 0} x "
                             f"{res['forwards']} forwards")
        _static_line("int8" if int8 else "bf16", res, launches,
                     per_fwd if int8 else 0, card)
        total += launches
        runs[int8] = res
    same = [np.mean(np.asarray(runs[True]["tokens"][r])
                    == np.asarray(runs[False]["tokens"][r]))
            for r in runs[False]["tokens"]]
    first = np.mean([runs[True]["tokens"][r][0] == runs[False]["tokens"][r][0]
                     for r in runs[False]["tokens"]])
    log("serve-int8", f"(a) int8 greedy tokens equal to bf16's: "
                      f"{100 * float(np.mean(same)):.1f}% of all, "
                      f"{100 * float(first):.1f}% of first tokens (reported "
                      f"only: random weights, greedy paths diverge after a "
                      f"first difference)")
    del runs
    torch.cuda.empty_cache()

    # (b) the continuous engine in int8, at phase 6's request mix
    model = LM(cfg)
    params = model.init_params(
        torch.Generator(device=model.device).manual_seed(0), int8=True)
    got, eng, _ = serve_mix("serve-int8", model, params, 16, card, int8=True)
    log("serve-int8", f"(b) phase wall {_since(t0):.1f} s | {card}")
    total += got["wq_gemm"]
    if profile:
        profile_decode(model, params, card, f"{INT8_ARCH} int8",
                       eng._page_idx)
    del eng, model, params
    torch.cuda.empty_cache()
    return total


# ---------------------------------------------------------------------------
# phase 6d: the dense-cache decode, full-width qwen3-1.7b
# ---------------------------------------------------------------------------
def phase_serve_dense(card, profile=False):
    """Full-width qwen3-1.7b in bf16: (a) the static engine through
    ``launch.serve.run`` (8 prompts of 2048 tokens, 32 new), its decode
    through the flash-decode kernel, 28 launches a decode forward and none
    in the prefill, the paged kernel never; (b) the continuous engine at
    phase 6's request mix with the paged kernel off (the flash-decode
    kernel only) and on (the paged kernel only), and the share of greedy
    tokens the two runs share (reported only: in bf16 the two kernels
    round differently).  Returns the flash-decode launches of (a) and of
    (b) with the paged kernel off."""
    t0 = datetime.datetime.now()
    cfg = get_config(DENSE_ARCH)
    pair = ("flash_decode", "paged_partials")
    torch.cuda.empty_cache()
    reset_launches(pair)
    res = launch_serve.run(DENSE_ARCH, static=True, **DENSE_STATIC)
    b3, b1 = (launches_of(n) for n in pair)
    decode_fwd = res["forwards"] - 1
    _check_tokens("static", res["tokens"], DENSE_STATIC["gen_len"],
                  cfg.padded_vocab)
    if b3 != cfg.n_layers * decode_fwd or b1:
        raise SystemExit(f"static: (flash_decode, paged_partials) launches "
                         f"({b3}, {b1}), expected {cfg.n_layers} x "
                         f"{decode_fwd} decode forwards and 0")
    B, S = DENSE_STATIC["slots"], DENSE_STATIC["prompt_len"]
    log("serve-dense", f"(a) {DENSE_ARCH} bf16 full width, StaticBatchEngine "
                       f"via launch.serve.run: {B} x {S} prompt tokens, "
                       f"{res['generated_tokens']} tokens | prefill "
                       f"{res['prefill_ms']:.3f} ms, decode step p50 "
                       f"{res['step_ms_p50']:.3f} ms, "
                       f"{res['tokens_per_s']:.1f} tok/s over "
                       f"{res['run_ms']:.1f} ms | flash_decode launches {b3} "
                       f"= {cfg.n_layers} x {decode_fwd} decode forwards (0 "
                       f"in the prefill), paged_partials 0 | peak "
                       f"{res['peak_gib']:.2f} GiB | {card}")
    total = b3
    del res
    torch.cuda.empty_cache()

    # (b) the continuous engine at phase 6's request mix, paged kernel off
    # and on
    model = LM(cfg)
    params = model.init_params(
        torch.Generator(device=model.device).manual_seed(0))
    toks = {}
    for paged in (False, True):
        got, eng, toks[paged] = serve_mix("serve-dense", model, params, 16,
                                          card, int8=False,
                                          paged_kernel=paged)
        if not paged:
            total += got["flash_decode"]
        del eng
        torch.cuda.empty_cache()
    same = np.mean([np.mean(a == b) for a, b in zip(toks[False],
                                                    toks[True])])
    first = np.mean([a[0] == b[0] for a, b in zip(toks[False], toks[True])])
    log("serve-dense", f"(b) greedy tokens equal between paged_kernel=False "
                       f"and True: {100 * float(same):.1f}% of all, "
                       f"{100 * float(first):.1f}% of first tokens (reported "
                       f"only: bf16, the two kernels round differently); "
                       f"phase wall {_since(t0):.1f} s | {card}")
    if profile:
        profile_decode(model, params, card, f"{DENSE_ARCH} bf16 dense-cache")
    del model, params
    torch.cuda.empty_cache()
    return total


# ---------------------------------------------------------------------------
# phases 6e-6g: the moe family (phi3.5-moe-42b int8, grok-1 depth-cut
# int8) and phi3-medium-14b
# ---------------------------------------------------------------------------
def _int8_model(arch, layers=None):
    """The full-width model (``layers``: depth cut) and its int8 tree,
    drawn and quantized layer by layer; the peak after init in GiB."""
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    model = LM(_served_cfg(arch, layers))
    params = model.init_params(
        torch.Generator(device=model.device).manual_seed(0), int8=True)
    return model, params, torch.cuda.max_memory_allocated() / 2 ** 30


def _add(total, got):
    for k, v in got.items():
        total[k] = total.get(k, 0) + v
    return total


def phase_serve_moe(card, profile=False):
    """6e: phi3.5-moe-42b at full width, weight-only int8 drawn layer by
    layer: (a) static 8 x 512 + 32 (decode through the flash-decode
    kernel); (b) continuous at phase 6's mix (the paged kernel); one
    decode forward launches the int8 GEMM exactly 32 x (4 + 3 x 16) + 1 =
    1665 times.  Returns the launches of SERVE_KERNELS."""
    t0 = datetime.datetime.now()
    phase = "serve-moe"
    total, _ = serve_static(phase, MOE_ARCH, card, int8=True)
    model, params, init_peak = _int8_model(MOE_ARCH)
    log(phase, f"(b) int8 tree {quant_bytes(params) / 1e9:.3f} GB, peak "
               f"after init {init_peak:.2f} GiB")
    got, eng, _ = serve_mix(phase, model, params, 16, card, int8=True)
    _add(total, got)
    cfg = model.cfg
    _add(total, decode_forward_launches(
        phase, model, params, 1665,
        f"{cfg.n_layers} x (4 + 3 x {cfg.moe.num_experts}) + 1"))
    log(phase, f"phase wall {_since(t0):.1f} s | {card}")
    if profile:
        profile_decode(model, params, card, f"{MOE_ARCH} int8",
                       eng._page_idx)
        profile_prefill(model, params, card, f"{MOE_ARCH} int8")
    del eng, model, params
    torch.cuda.empty_cache()
    return total


def _pos(model, cache):
    """The cache's position counter (it sits with the attention K/V)."""
    return blocks.kv_cache(model.cfg, cache)["pos"]


def phase_serve_grok(card):
    """6f: grok-1-314b at full width (48/8 heads of 128: G 6; softcap 30;
    8 experts of d_ff 32768), cut to GROK_LAYERS layers, int8: (a) static
    8 x 512 + 32 (the flash-decode kernel at softcap 30, G 6); (b) 8
    requests drawn as phase 6's, through the paged kernel (a 32-column chunk
    is 192 query rows).  Returns the launches of SERVE_KERNELS."""
    t0 = datetime.datetime.now()
    phase = "serve-grok"
    total, _ = serve_static(phase, GROK_ARCH, card, int8=True,
                         layers=GROK_LAYERS)
    model, params, init_peak = _int8_model(GROK_ARCH, GROK_LAYERS)
    log(phase, f"(b) int8 tree {quant_bytes(params) / 1e9:.3f} GB, peak "
               f"after init {init_peak:.2f} GiB")
    got, eng, _ = serve_mix(phase, model, params, 8, card, int8=True)
    _add(total, got)
    log(phase, f"phase wall {_since(t0):.1f} s | {card}")
    del eng, model, params
    torch.cuda.empty_cache()
    return total


def phase_serve_phi3m(card):
    """6g: phi3-medium-14b at full width in bf16 (40/10 heads: B x NKV =
    80 in the flash-decode kernel's plan), static 8 x 512 + 32.  Returns
    the launches of SERVE_KERNELS."""
    t0 = datetime.datetime.now()
    got, _ = serve_static("serve-phi3m", PHI3M_ARCH, card, int8=False)
    log("serve-phi3m", f"phase wall {_since(t0):.1f} s | {card}")
    return got


# ---------------------------------------------------------------------------
# phase 6h: the hybrid family, jamba-v0.1-52b at full width in int8
# ---------------------------------------------------------------------------
def _share_prompts(cfg):
    return np.random.default_rng(5).integers(
        1, cfg.vocab_size, size=(8, HYBRID_SHARE["prompt_len"]))


def hybrid_token_share(model, params):
    """(c) 8 prompts of HYBRID_SHARE's length through the static engine
    (the SSD kernel's prefill) and the continuous engine (the recurrent
    prefill, the paged kernel), HYBRID_SHARE's new tokens each: the share
    of greedy tokens the two give alike, and of first tokens."""
    cfg, n = model.cfg, HYBRID_SHARE["gen_len"]
    prompts = _share_prompts(cfg)
    static = StaticBatchEngine(
        model, params, max_len=HYBRID_SHARE["prompt_len"] + n + 8,
        batch=8).generate(prompts, n_steps=n).cpu().numpy()
    eng = ContinuousBatchingEngine(model, params, **MIX)
    rids = [eng.submit(p, n) for p in prompts]
    out = eng.run()
    cont = np.stack([np.asarray(out[r]) for r in rids])
    return float((cont == static).mean()), float(
        (cont[:, 0] == static[:, 0]).mean())


def hybrid_prefill_paths(model, params):
    """(d) (c)'s prompts through one prefill-mode forward (the SSD kernel)
    and one decode-mode forward from a zero state (the recurrence, as the
    continuous engine prefills): at each prompt's last position, the
    share of argmaxes alike, the median of the max |logit difference|
    and the median gap between the two largest prefill-mode logits."""
    toks = torch.as_tensor(_share_prompts(model.cfg), device=model.device)
    B, S = toks.shape
    pos = torch.arange(S, device=model.device)[None].expand(B, S)
    last = [model.forward(params, toks, pos, mode=mode,
                          cache=model.init_cache(B, S))[0][:, -1]
            for mode in ("prefill", "decode")]
    top2 = last[0].topk(2, dim=-1).values
    return (float((last[0].argmax(-1) == last[1].argmax(-1)).float().mean()),
            float((last[0] - last[1]).abs().amax(-1).median()),
            float((top2[:, 0] - top2[:, 1]).median()))


def _log_paths(phase, what, stats, card):
    alike, diff, gap = stats
    log(phase, f"(d) {what}: prefill-mode (SSD kernel) vs decode-mode "
               f"(recurrence) forward of (c)'s prompts, last position: "
               f"argmax alike {100 * alike:.1f}%, median max |logit "
               f"difference| {diff:.3e}, median top-2 gap {gap:.4f} "
               f"(reported only) | {card}")


def phase_serve_hybrid(card, profile=False):
    """6h: jamba-v0.1-52b at full width (4 periods of 1 attention and 7
    mamba layers; 16 experts top-2 of d_ff 14336 on the odd layers),
    weight-only int8 drawn and quantized sub-layer by sub-layer (the 103
    GB bf16 tree is never held): (a) static 8 x 512 + 32 (the SSD kernel
    28 launches in the prefill, the flash-decode kernel 4 a decode
    forward); (b) 8 requests drawn as phase 6's through the paged kernel,
    the model cut to HYBRID_MIX_LAYERS (2 periods); one decode forward
    launches the int8 GEMM exactly 2 x (7 + 42 + 9 + 3 x 4 x 16) + 1 =
    501 times; (c) the share of greedy tokens the two
    engines give alike on one set of prompts (reported only: in bf16 the
    recurrence and the SSD kernel round differently); (d) the logits
    behind it, from one forward through each path, in bf16 and in fp32
    (one period at full width).  The int8 tree must
    stay under HYBRID_INT8_MAX_GB and the peak after init under
    HYBRID_INIT_PEAK_MAX_GB.  Returns the launches of SERVE_KERNELS."""
    t0 = datetime.datetime.now()
    phase = "serve-hybrid"
    total, sizes = serve_static(phase, HYBRID_ARCH, card, int8=True)
    int8_bytes, init_peak = sizes["param_bytes"], sizes["init_peak_gib"]
    if (int8_bytes / 1e9 >= HYBRID_INT8_MAX_GB
            or init_peak * 2 ** 30 / 1e9 >= HYBRID_INIT_PEAK_MAX_GB):
        raise SystemExit(f"{phase}: int8 tree {int8_bytes / 1e9:.3f} GB, "
                         f"peak after init {init_peak:.2f} GiB: over "
                         f"{HYBRID_INT8_MAX_GB} / {HYBRID_INIT_PEAK_MAX_GB} "
                         f"GB")
    model, params, init_peak = _int8_model(HYBRID_ARCH, HYBRID_MIX_LAYERS)
    log(phase, f"(b) {HYBRID_MIX_LAYERS} of 32 layers: int8 tree "
               f"{quant_bytes(params) / 1e9:.3f} GB, peak after init "
               f"{init_peak:.2f} GiB")
    got, eng, _ = serve_mix(phase, model, params, 8, card, int8=True)
    _add(total, got)
    periods = model.n_periods
    _add(total, decode_forward_launches(
        phase, model, params, periods * 250 + 1,
        f"{periods} x (4 + 3 + 7 x 6 + 3 x 3 + 4 x 3 x 16) + 1"))
    same, first = hybrid_token_share(model, params)
    log(phase, f"(c) 8 x {HYBRID_SHARE['prompt_len']} prompt tokens, "
               f"{HYBRID_SHARE['gen_len']} new: greedy tokens equal between "
               f"the static engine (SSD prefill) and the continuous engine "
               f"(recurrent prefill): {100 * same:.1f}% of all, "
               f"{100 * first:.1f}% of first tokens (reported only) | "
               f"{card}")
    _log_paths(phase, f"int8 weights, bf16, {model.cfg.n_layers} layers",
               hybrid_prefill_paths(model, params), card)
    if profile:
        profile_decode(model, params, card, f"{HYBRID_ARCH} int8",
                       eng._page_idx)
    del eng, model, params
    torch.cuda.empty_cache()
    # the same in fp32, one period at full width (~52 GB of fp32 weights)
    cfg = get_config(HYBRID_ARCH, n_layers=get_config(HYBRID_ARCH)
                     .attn_period, param_dtype="float32",
                     compute_dtype="float32")
    model = LM(cfg)
    params = model.init_params(
        torch.Generator(device=model.device).manual_seed(0))
    _log_paths(phase, f"fp32, {cfg.n_layers} layers",
               hybrid_prefill_paths(model, params), card)
    log(phase, f"phase wall {_since(t0):.1f} s | {card}")
    del model, params
    torch.cuda.empty_cache()
    return total


# ---------------------------------------------------------------------------
# phases 6i, 6j: the cross-attention families (llama-3.2-vision-90b int8,
# depth-cut; whisper-base whole)
# ---------------------------------------------------------------------------
def install_cost(phase, model, params, card):
    """One admission's context install into a slot's row (a stub context
    from the host, its cross K/V; audio: the encoder first): CUDA-event
    ms, and its int8 GEMM launches, which must be ``int8_per_install``
    for an int8 tree.  Returns the B5 launches of one install."""
    cfg = model.cfg
    cache = model.init_cache(1, 64)
    extra = stub_context(cfg, np.random.default_rng(3))
    ms = measure(lambda: model.install_slot_context(params, cache, 0, extra),
                 cover_ms=0.0).median_s * 1e3
    reset_launches(("wq_gemm",))
    model.install_slot_context(params, cache, 0, extra)
    torch.cuda.synchronize()
    per = launches_of("wq_gemm")
    int8 = any(t.dtype == torch.int8 for t in tree_leaves(params))
    if per != (int8_per_install(cfg) if int8 else 0):
        raise SystemExit(f"{phase}: {per} wq_gemm launches in one install, "
                         f"expected {int8_per_install(cfg) if int8 else 0}")
    k = cache["cross_k"]
    if not bool(torch.isfinite(k).all()) or not bool(k.abs().sum() > 0):
        raise SystemExit(f"{phase}: the installed cross K is zero or not "
                         f"finite")
    line = ""
    if cfg.is_encdec:
        frames = torch.as_tensor(extra["audio_frames"][None],
                                 device=model.device)
        enc_ms = measure(lambda: model.encode_audio(params, frames),
                         cover_ms=0.0).median_s * 1e3
        line = f", of it the encoder {enc_ms:.3f} ms"
    log(phase, f"one admission's install ({cross_layers(cfg)} cross layers "
               f"over {get_adapter(cfg.family).context_tokens(cfg)} context "
               f"tokens): {ms:.3f} ms{line} (perf.measure: CUDA events, "
               f"no cover, median of 5); wq_gemm launches {per} | {card}")
    return per


def decode_forward_launches(phase, model, params, int8_want=0,
                            formula="0"):
    """One pure decode forward (8 x 1, context 288, the dense-cache path):
    its launches of SERVE_KERNELS, which must be the flash-decode
    kernel's one an attention layer, cross layers included, and the int8
    GEMM's ``int8_want``, the count ``int8_per_forward`` reckons from the
    config (``formula``) for an int8 tree."""
    cfg = model.cfg
    cache = model.init_cache(8, 512)
    _pos(model, cache).fill_(288)
    reset_launches(SERVE_KERNELS)
    model.forward(params, torch.ones((8, 1), dtype=torch.long,
                                     device=model.device),
                  torch.full((8, 1), 288, dtype=torch.long,
                             device=model.device), cache=cache)
    torch.cuda.synchronize()
    got = {n: launches_of(n) for n in SERVE_KERNELS}
    attn = attn_layers(cfg) + cross_layers(cfg)
    want = {"wq_gemm": int8_want, "flash_decode": attn,
            "paged_partials": 0, "ssd_scan": 0}
    if got != want or (int8_want and int8_want != int8_per_forward(cfg)):
        raise SystemExit(f"{phase}: one decode forward launched {got}, "
                         f"expected {want} (wq_gemm {formula})")
    log(phase, f"one decode forward (8 x 1): launches wq_gemm "
               f"{got['wq_gemm']} = {formula}, flash_decode "
               f"{got['flash_decode']} = {attn_layers(cfg)} self + "
               f"{cross_layers(cfg)} cross, paged_partials 0, ssd_scan 0")
    return got


def phase_serve_vlm(card, profile=False):
    """6i: llama-3.2-vision-90b at full width (64/8 heads of 128: G 8;
    d_ff 28672; 1601 image tokens), cut to VLM_LAYERS of its 100 layers
    (2 periods of 4 attention layers and 1 gated cross layer), int8
    drawn layer by layer: (a) static 8 x 512 + 32 through
    ``launch.serve.run`` with the launcher's stub image embeds, every
    gate_attn at its zero init (the cross layers run and launch all the
    same; only launches and the token range are checked there), the
    decode through the flash-decode kernel only (8 self and 2 cross
    launches a forward); (b) every gate_attn set to VLM_GATE (test data),
    8 requests drawn as phase 6's, each with its own stub image, through
    the paged kernel (self) and the flash-decode kernel (cross);
    one decode forward launches the int8 GEMM exactly 8 x 7 + 2 x 5 + 1
    = 67 times, and one install 2 x 2.  The int8 tree must stay under
    VLM_INT8_MAX_GB and the peak after init under VLM_INIT_PEAK_MAX_GB.
    Returns the launches of SERVE_KERNELS."""
    t0 = datetime.datetime.now()
    phase = "serve-vlm"
    total, sizes = serve_static(phase, VLM_ARCH, card, int8=True,
                                layers=VLM_LAYERS)
    int8_bytes, init_peak = sizes["param_bytes"], sizes["init_peak_gib"]
    full = LM(get_config(VLM_ARCH), device="meta")
    full_int8 = quant_bytes(full.init_params(None, int8=True))
    log(phase, f"int8 tree {int8_bytes / 1e9:.3f} GB at {VLM_LAYERS} "
               f"layers (measured), {full_int8 / 1e9:.3f} GB at all "
               f"{full.cfg.n_layers} (the bf16 tree "
               f"{full.init_param_bytes() / 1e9:.3f} GB; both reckoned on "
               f"the meta device: not one card) | (a) gate_attn at its "
               f"zero init, (b) {VLM_GATE:g} (test data) | peak after init "
               f"{init_peak:.2f} GiB, serving {sizes['peak_gib']:.2f} GiB "
               f"| {card}")
    if (int8_bytes / 1e9 >= VLM_INT8_MAX_GB
            or init_peak * 2 ** 30 / 1e9 >= VLM_INIT_PEAK_MAX_GB):
        raise SystemExit(f"{phase}: int8 tree {int8_bytes / 1e9:.3f} GB, "
                         f"peak after init {init_peak:.2f} GiB: over "
                         f"{VLM_INT8_MAX_GB} / {VLM_INIT_PEAK_MAX_GB} GB")
    model, params, init_peak = _int8_model(VLM_ARCH, VLM_LAYERS)
    set_gates(params, VLM_GATE)
    log(phase, f"(b) int8 tree {quant_bytes(params) / 1e9:.3f} GB, peak "
               f"after init {init_peak:.2f} GiB")
    got, eng, _ = serve_mix(phase, model, params, 8, card, int8=True)
    _add(total, got)
    _add(total, decode_forward_launches(
        phase, model, params, 67, "8 x (4 + 3) + 2 x (2 + 3) + 1"))
    _add(total, {"wq_gemm": install_cost(phase, model, params, card)})
    if profile:
        profile_decode(model, params, card, f"{VLM_ARCH} int8 "
                       f"{VLM_LAYERS} layers", eng._page_idx)
    log(phase, f"phase wall {_since(t0):.1f} s | {card}")
    del eng, model, params
    torch.cuda.empty_cache()
    return total


def phase_serve_audio(card, profile=False):
    """6j: whisper-base whole (6 encoder and 6 decoder layers, d 512, 8/8
    heads of 64: G 1; vocab 51865; 1500 audio frames) in bf16: (a) static
    8 x 128 + 64 over 8 x 1500 stub frames through ``launch.serve.run``
    (the encoder in the prefill; the decode through the flash-decode
    kernel, 6 self and 6 cross launches a forward); (b) 16 requests at
    phase 6's mix, each with its own stub frames, through the paged
    kernel (self) and the flash-decode kernel (cross); the encoder's and
    an install's CUDA-event ms a request; a static prefill's first and
    warm times and its kernel rows.  Returns the launches of
    SERVE_KERNELS."""
    t0 = datetime.datetime.now()
    phase = "serve-audio"
    total, _ = serve_static(phase, AUDIO_ARCH, card, int8=False,
                            shape=AUDIO_STATIC)
    model = LM(get_config(AUDIO_ARCH))
    params = model.init_params(
        torch.Generator(device=model.device).manual_seed(0))
    got, eng, _ = serve_mix(phase, model, params, 16, card, int8=False)
    _add(total, got)
    _add(total, {"wq_gemm": install_cost(phase, model, params, card)})
    _add(total, decode_forward_launches(phase, model, params))
    # (a)'s prefill again in this process: its first call against warm
    # ones, and where a warm one spends its time
    B, S = AUDIO_STATIC["slots"], AUDIO_STATIC["prompt_len"]
    frames = torch.as_tensor(stub_context(
        model.cfg, np.random.default_rng(3), batch=B)["audio_frames"],
        device=model.device)
    profile_prefill(model, params, card, f"{AUDIO_ARCH} bf16", batch=B,
                    seq=S, extra={"audio_frames": frames})
    if profile:
        profile_decode(model, params, card, f"{AUDIO_ARCH} bf16",
                       eng._page_idx)
    log(phase, f"phase wall {_since(t0):.1f} s | {card}")
    del eng, model, params
    torch.cuda.empty_cache()
    return total


# ---------------------------------------------------------------------------
# phase 6k: the serving features at full width (granite-3-2b, mamba2-780m)
# ---------------------------------------------------------------------------
# (a) the prefix cache: 16 requests, a shared 256-token prefix (a multiple
# of the chunk, so a hit's suffix chunks fall where the cold run's do)
# and 16-128 own tokens, phase 6's mix otherwise; (b), (c) speculative
# decoding: 8 requests whose prompts repeat one 32-token phrase 4 to 8
# times, 64 new, spec_k 4
FEATURE_PREFIX = 256
FEATURE_OWN = (16, 128)
SPEC_PHRASE, SPEC_REPEATS, SPEC_NEW, SPEC_K = 32, (4, 8), 64, 4
# (c)'s mamba2-780m cut to this many of its 48 layers (its width whole;
# 16 until phase 6l took the time)
SPEC_SSM_LAYERS = 8


def _feature_serve(phase, what, eng, prompts, n_new, card):
    """Submit ``prompts`` (``n_new`` new tokens each), drain between CUDA
    events and check the tokens; returns (tokens a request, the summary,
    tokens/s over the run, the launches of SERVE_KERNELS, the peak GiB)."""
    cfg = eng.model.cfg
    rids = [eng.submit(p, n_new) for p in prompts]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launches(SERVE_KERNELS)
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    out = eng.run()
    end.record()
    end.synchronize()
    got = {n: launches_of(n) for n in SERVE_KERNELS}
    _check_tokens(f"{phase} {what}", out, n_new, cfg.padded_vocab)
    _no_errors(f"{phase} {what}", eng)
    st = eng.stats.summary()
    run_ms = start.elapsed_time(end)
    verify = sum(s_.verify for s_ in eng.stats.steps)
    fast = sum(bool(s_.n_decode) and not s_.verify for s_ in eng.stats.steps)
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    log(phase, f"{what}: {len(prompts)} requests, "
               f"{st['generated_tokens']} tokens in {st['steps']} steps / "
               f"{st['forwards']} forwards | "
               f"{st['generated_tokens'] / (run_ms / 1e3):.1f} tok/s over "
               f"{run_ms:.1f} ms | step p50 {st['step_ms_p50']:.3f} ms, p95 "
               f"{st['step_ms_p95']:.3f} ms | prefix_hit_tokens "
               f"{st['prefix_hit_tokens']}, prefix_hit_rate "
               f"{st['prefix_hit_rate']:.3f} | drafted "
               f"{st['drafted_tokens']}, accepted "
               f"{st['accepted_draft_tokens']}, accept_rate "
               f"{st['accept_rate']:.3f}, {verify} verify steps, {fast} "
               f"plain-decode steps | launches " + ", ".join(
                   f"{k} {v}" for k, v in got.items() if v)
               + f" | peak {peak:.2f} GiB | check=True, no error finding | "
               f"{card}")
    return ([np.asarray(out[r]) for r in rids], st,
            st["generated_tokens"] / (run_ms / 1e3), got, peak)


def _agreeing(a, b):
    """The share of greedy tokens two runs give alike, position by
    position."""
    same = sum(int((x == y).sum()) for x, y in zip(a, b))
    return same / sum(len(x) for x in a)


def _spec_prompts(cfg, seed=5):
    rng = np.random.default_rng(seed)
    return [np.tile(rng.integers(1, cfg.vocab_size, size=SPEC_PHRASE),
                    int(r))
            for r in rng.integers(SPEC_REPEATS[0], SPEC_REPEATS[1] + 1,
                                  size=8)]


def phase_serve_features(card):
    """6k: the serving features at full width, every engine with
    check=True.  (a) granite-3-2b bf16, phase 6's mix, 16 requests sharing
    a 256-token prefix, ``prefix_cache`` off then on: identical tokens,
    hits > 0.  (b) granite-3-2b, 8 repeated-phrase requests, 64 new,
    ``spec_decode`` off then on (spec_k 4): the paged kernel a launch a
    layer a forward, verify forwards included; granite cut to
    OPEN_LOOP_LAYERS layers in (a) and (b); the agreeing share reported.  (c)
    mamba2-780m at full width cut to SPEC_SSM_LAYERS layers, as (b): the
    two-pass verify's snapshot bytes, accept rate and agreeing share; then
    with ``oracle_drafts`` from the off run's tokens, verify steps
    required.  Returns the launches of SERVE_KERNELS."""
    t0 = datetime.datetime.now()
    phase = "serve-features"
    total = {}
    cfg = get_config("granite-3-2b", n_layers=OPEN_LOOP_LAYERS)
    model = LM(cfg)
    params = model.init_params(
        torch.Generator(device=model.device).manual_seed(0))
    rng = np.random.default_rng(3)
    shared = rng.integers(1, cfg.vocab_size, size=FEATURE_PREFIX)
    prompts = [np.concatenate([shared, rng.integers(1, cfg.vocab_size,
                                                    size=int(n))])
               for n in rng.integers(FEATURE_OWN[0], FEATURE_OWN[1] + 1,
                                     size=16)]
    runs = {}
    for on in (False, True):
        eng = ContinuousBatchingEngine(model, params, prefix_cache=on,
                                       check=True, **MIX)
        runs[on] = _feature_serve(
            phase, f"(a) granite-3-2b bf16 prefix_cache={on} (a shared "
                   f"{FEATURE_PREFIX}-token prefix + {FEATURE_OWN[0]}-"
                   f"{FEATURE_OWN[1]} own tokens)", eng, prompts, MIX_NEW,
            card)
        _add(total, runs[on][3])
        del eng
    same = all(np.array_equal(x, y) for x, y in zip(runs[False][0],
                                                     runs[True][0]))
    hits = runs[True][1]["prefix_hit_tokens"]
    log(phase, f"(a) tokens identical with the prefix cache on and off: "
               f"{same}; prefix_hit_tokens {hits}; tok/s on / off "
               f"{runs[True][2] / runs[False][2]:.3f} | {card}")
    if not same or hits <= 0:
        raise SystemExit(f"{phase} (a): identical {same}, hits {hits}")

    sprompts = _spec_prompts(cfg)
    runs = {}
    for on in (False, True):
        eng = ContinuousBatchingEngine(model, params, spec_decode=on,
                                       spec_k=SPEC_K, check=True, **MIX)
        runs[on] = _feature_serve(
            phase, f"(b) granite-3-2b bf16 spec_decode={on} (spec_k "
                   f"{SPEC_K}; a {SPEC_PHRASE}-token phrase x "
                   f"{SPEC_REPEATS[0]}-{SPEC_REPEATS[1]})", eng, sprompts,
            SPEC_NEW, card)
        fwd = runs[on][1]["forwards"]
        if runs[on][3]["paged_partials"] != cfg.n_layers * fwd:
            raise SystemExit(f"{phase} (b): paged_partials "
                             f"{runs[on][3]['paged_partials']}, expected "
                             f"{cfg.n_layers} x {fwd} forwards")
        _add(total, runs[on][3])
        del eng
    log(phase, f"(b) paged_partials = {cfg.n_layers} x forwards in both "
               f"runs; greedy tokens alike on and off "
               f"{100 * _agreeing(runs[False][0], runs[True][0]):.1f}% "
               f"(reported only: bf16 at another GEMM M and B1 slicing); "
               f"tok/s on / off {runs[True][2] / runs[False][2]:.3f} | "
               f"{card}")
    del model, params
    torch.cuda.empty_cache()

    # (c) at full width cut to SPEC_SSM_LAYERS layers: its continuous
    # prefill runs token by token (the phase's cost)
    cfg = get_config(SSM_ARCH, n_layers=SPEC_SSM_LAYERS)
    model = LM(cfg)
    params = model.init_params(
        torch.Generator(device=model.device).manual_seed(0))
    s = cfg.ssm
    d_inner = s.expand * cfg.d_model
    nheads = d_inner // s.head_dim
    conv_dim = d_inner + 2 * s.ngroups * s.d_state
    # the snapshot a slot and layer: h (fp32) and the conv window
    per_layer = (nheads * s.head_dim * s.ngroups * s.d_state * 4
                 + (s.conv_kernel - 1) * conv_dim
                 * dtype_of(cfg.compute_dtype).itemsize)
    full_layers = get_config(SSM_ARCH).n_layers
    sprompts = _spec_prompts(cfg)
    runs = {}
    for on in (False, True):
        eng = ContinuousBatchingEngine(model, params, spec_decode=on,
                                       spec_k=SPEC_K, check=True, **MIX)
        if on:
            want = per_layer * cfg.n_layers * MIX["n_slots"]
            log(phase, f"(c) {SSM_ARCH} ({cfg.n_layers} of {full_layers} "
                       f"layers) snapshot of the two-pass verify: "
                       f"{eng.snapshot_bytes} bytes for {MIX['n_slots']} "
                       f"slots (reckoned from the config: {per_layer} "
                       f"bytes a layer and slot, h {nheads} x {s.head_dim}"
                       f" x {s.d_state} fp32 + conv {s.conv_kernel - 1} x "
                       f"{conv_dim} {cfg.compute_dtype}; "
                       f"{per_layer * full_layers / 1e6:.2f} MB a slot at "
                       f"all {full_layers} layers)")
            if eng.snapshot_bytes != want:
                raise SystemExit(f"{phase} (c): snapshot "
                                 f"{eng.snapshot_bytes} != {want}")
        runs[on] = _feature_serve(
            phase, f"(c) {SSM_ARCH} bf16, {cfg.n_layers} layers, "
                   f"spec_decode={on} (spec_k {SPEC_K})", eng, sprompts,
            SPEC_NEW, card)
        if runs[on][3]["ssd_scan"]:
            raise SystemExit(f"{phase} (c): SSD launches in the continuous "
                             f"engine")
        del eng
    # the replay at full width whatever the drafter finds: drafts from
    # the off run's tokens (phase 5's oracle_drafts)
    eng = ContinuousBatchingEngine(model, params, spec_decode=True,
                                   spec_k=SPEC_K, check=True, **MIX)
    oracle_drafts(eng, dict(enumerate(t.tolist() for t in runs[False][0])),
                  cfg.vocab_size)
    oracle = _feature_serve(
        phase, f"(c) {SSM_ARCH} bf16, {cfg.n_layers} layers, "
               f"spec_decode=True, drafts from the off run's tokens (every "
               f"other one wrong)", eng, sprompts, SPEC_NEW, card)
    if not sum(s_.verify for s_ in eng.stats.steps):
        raise SystemExit(f"{phase} (c): no verify step with the oracle's "
                         f"drafts")
    del eng
    log(phase, f"(c) greedy tokens alike on and off "
               f"{100 * _agreeing(runs[False][0], runs[True][0]):.1f}%, "
               f"with the oracle's drafts and off "
               f"{100 * _agreeing(runs[False][0], oracle[0]):.1f}% "
               f"(reported only: bf16); tok/s on / off "
               f"{runs[True][2] / runs[False][2]:.3f}; phase wall "
               f"{_since(t0):.1f} s | {card}")
    del model, params
    torch.cuda.empty_cache()
    return total


# 6l: the open-loop front end at full width (granite-3-2b bf16, phase 6's
# engine shape).  (b): the launcher's requests, prompt band and new
# tokens, and each run's arrival process at a share of (a)'s closed-loop
# rate; (d): request 0's prompt and new tokens, the long prompt (one new
# token) arriving about STALL_AFTER decode steps into request 0, and the
# stall-free policy's TBT target as a multiple of (a)'s pure-decode p50
OPEN_N = 32
OPEN_PROMPTS = (32, 256)
OPEN_LOADS = (("poisson", 0.5), ("poisson", 0.9), ("gamma", 0.9))
OPEN_CV = 2.0
STALL_SHORT, STALL_LONG, STALL_AFTER, STALL_TARGET = (64, 128), 448, 10, 1.2


def _b1_only(phase, what, got, forwards, n_layers):
    """The paged kernel ``n_layers`` launches a forward, no other serving
    kernel."""
    want = {n: 0 for n in SERVE_KERNELS}
    want["paged_partials"] = n_layers * forwards
    if got != want or not forwards:
        raise SystemExit(f"{phase} {what}: launches {got}, expected {want}")


def _front_run(phase, what, eng, arr, clock):
    """``OpenLoopFrontend(eng, clock=clock).run(arr)``, the launches of
    SERVE_KERNELS counted and checked; returns (the result, the
    launches)."""
    torch.cuda.synchronize()
    reset_launches(SERVE_KERNELS)
    res = OpenLoopFrontend(eng, clock=clock).run(arr)
    got = {n: launches_of(n) for n in SERVE_KERNELS}
    _b1_only(phase, what, got, res.engine_summary["forwards"],
             eng.model.cfg.n_layers)
    return res, got


def _step_ms(eng, pure_decode=False):
    return [s_.device_ms() for s_ in eng.stats.steps
            if not pure_decode or (s_.n_decode and not s_.n_prefill_tokens)]


def _p50(xs):
    xs = sorted(xs)
    return xs[len(xs) // 2]


def _plan_widths(eng):
    """Wrap ``eng.step`` to log each executed plan's prefill rows as
    (rid, forward width, valid tokens)."""
    log = []
    orig = eng.step

    def step():
        rid_of = {s: r.rid for s, r in eng.sched.active.items()}
        more = orig()
        rid_of.update((s, r.rid) for s, r in eng.sched.active.items())
        if eng.last_plan is not None:
            log.append([(rid_of.get(pf.slot), int(pf.tokens.shape[1]),
                         int(pf.n_valid[0]))
                        for pf in eng.last_plan.prefills])
        return more

    eng.step = step
    return log


def _force_chunks(eng, widths):
    """Make ``eng``'s scheduler size its first ``len(widths)`` prefill
    steps' chunks as ``widths`` says, in order, then as its policy does."""
    left = list(widths)
    orig = eng.sched._step_chunk

    def step_chunk(n_decode, n_prefilling):
        width = orig(n_decode, n_prefilling)
        return left.pop(0) if left and n_prefilling else width

    eng.sched._step_chunk = step_chunk


def phase_serve_open_loop(card):
    """6l: the open-loop front end at full width, granite-3-2b bf16 cut to
    OPEN_LOOP_LAYERS layers, at phase 6's engine shape.  (a) 16 requests
    through ``engine.run()``, then through
    ``OpenLoopFrontend(clock="wall")`` over closed-loop arrivals:
    identical tokens, the paged kernel a launch a layer a forward;
    both runs' tok/s.  (b) ``launch.serve.run(open_loop=True)``, 32
    requests of 32-256 prompt tokens, 32 new, Poisson at 0.5 and 0.9 of
    (a)'s closed-loop rate and gamma at 0.9 (cv 2): the latency block;
    the last run's recorded trace replayed to the same tokens.  (c) (a)
    again on the model clock against the card's HWSpec: the modeled work
    and the served step's share of its bound, over all steps and over
    pure-decode steps.  (d) the stall-free policy under contention:
    request 0's worst and p99 TBT, prefill steps and chunk widths, fixed
    against stall-free; request 0's tokens identical under the fixed
    policy with stall-free's chunks forced as under stall-free, and under
    both policies where they chunked its prompt alike.  Returns the
    launches of SERVE_KERNELS."""
    t0 = datetime.datetime.now()
    phase = "serve-open-loop"
    total = {}
    cfg = get_config("granite-3-2b", n_layers=OPEN_LOOP_LAYERS)
    model = LM(cfg)
    params = model.init_params(
        torch.Generator(device=model.device).manual_seed(0))
    rng = np.random.default_rng(0)
    reqs = [(rng.integers(1, cfg.vocab_size, size=int(n)), MIX_NEW)
            for n in rng.integers(32, 257, size=16)]

    # (a) closed loop, then the same requests through the front end
    eng = ContinuousBatchingEngine(model, params, **MIX)
    rids = [eng.submit(p, g) for p, g in reqs]
    torch.cuda.synchronize()
    reset_launches(SERVE_KERNELS)
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    closed = eng.run()
    end.record()
    end.synchronize()
    got = {n: launches_of(n) for n in SERVE_KERNELS}
    st = eng.stats.summary()
    _b1_only(phase, "(a) engine.run()", got, st["forwards"], cfg.n_layers)
    _add(total, got)
    _check_tokens(f"{phase} (a)", closed, MIX_NEW, cfg.padded_vocab)
    closed_s = start.elapsed_time(end) / 1e3
    decode_p50 = _p50(_step_ms(eng, pure_decode=True)) / 1e3
    lam_max = len(reqs) / closed_s
    eng.reset()
    front, got = _front_run(phase, "(a) front end", eng,
                            closed_loop_arrivals(reqs), "wall")
    _add(total, got)
    same = all(np.array_equal(front.results[r], closed[r]) for r in rids)
    fst = front.engine_summary
    tps_closed = st["generated_tokens"] / closed_s
    tps_front = fst["generated_tokens"] / front.makespan_s
    log(phase, f"(a) granite-3-2b bf16 ({cfg.n_layers} layers), 16 "
               f"requests at phase 6's mix: "
               f"engine.run() {st['generated_tokens']} tokens in "
               f"{st['steps']} steps / {st['forwards']} forwards, "
               f"{tps_closed:.1f} tok/s over {closed_s * 1e3:.1f} ms "
               f"(pure-decode step p50 {decode_p50 * 1e3:.3f} ms); "
               f"OpenLoopFrontend(clock='wall') over closed-loop arrivals "
               f"{fst['steps']} steps, {tps_front:.1f} tok/s over the "
               f"makespan {front.makespan_s * 1e3:.1f} ms; front / run "
               f"{tps_front / tps_closed:.3f} | tokens identical: {same} | "
               f"paged_partials {cfg.n_layers} x forwards in both | "
               f"lambda_max {lam_max:.4f} requests/s | {card}")
    if not same or fst["steps"] != st["steps"]:
        raise SystemExit(f"{phase} (a): tokens identical {same}, steps "
                         f"{fst['steps']} against {st['steps']}")

    # (c) the model clock against the card's HWSpec, the events recorded
    eng.reset()
    modeled, got = _front_run(phase, "(c)", eng, closed_loop_arrivals(reqs),
                              "model")
    _add(total, got)
    if not all(np.array_equal(modeled.results[r], closed[r]) for r in rids):
        raise SystemExit(f"{phase} (c): tokens differ from (a)'s")
    mst = modeled.engine_summary
    steps = eng.stats.steps
    meas = [s_.device_ms() / 1e3 for s_ in steps]
    model_t = [eng.modeled_step_time(s_.n_decode, s_.n_prefill_tokens)
               for s_ in steps]
    dec = [i for i, s_ in enumerate(steps)
           if s_.n_decode and not s_.n_prefill_tokens]
    share = sum(model_t) / sum(meas)
    dshare = sum(model_t[i] for i in dec) / sum(meas[i] for i in dec)
    log(phase, f"(c) clock='model' against {eng.hw.name} "
               f"({eng.hw.hbm_bw / 1e12:.2f} TB/s, "
               f"{eng.hw.peak_flops_bf16 / 1e12:.0f} TFLOP/s bf16): "
               f"tokens as (a); model_flops {mst['model_flops']:.4e}, "
               f"model_bytes {mst['model_bytes']:.4e}, model_tflops_per_s "
               f"{mst['model_tflops_per_s']:.4f} over the step events | "
               f"modeled makespan {modeled.makespan_s * 1e3:.3f} ms | "
               f"modeled / measured step time: all {len(steps)} steps "
               f"{sum(model_t) * 1e3:.3f} / {sum(meas) * 1e3:.3f} ms = "
               f"{100 * share:.2f}%, {len(dec)} pure-decode steps "
               f"{sum(model_t[i] for i in dec) * 1e3:.3f} / "
               f"{sum(meas[i] for i in dec) * 1e3:.3f} ms = "
               f"{100 * dshare:.2f}% (one decode step of 8 rows: modeled "
               f"{eng.modeled_step_time(8, 0) * 1e3:.3f} ms, measured p50 "
               f"{_p50([meas[i] for i in dec]) * 1e3:.3f} ms) | {card}")
    if not 0 < share < 1 or not 0 < dshare < 1:
        raise SystemExit(f"{phase} (c): shares {share}, {dshare}")

    # (d) the stall-free policy under contention, wall feedback
    srng = np.random.default_rng(6)
    short = srng.integers(1, cfg.vocab_size, size=STALL_SHORT[0])
    long_ = srng.integers(1, cfg.vocab_size, size=STALL_LONG)
    # request 0's prefill (its chunks) and STALL_AFTER decode steps
    t_long = (-(-STALL_SHORT[0] // MIX["prefill_chunk"]) + STALL_AFTER) \
        * decode_p50
    arr = [ArrivalRequest(0.0, short, STALL_SHORT[1]),
           ArrivalRequest(t_long, long_, 1)]
    target = STALL_TARGET * decode_p50
    runs, chunks0, splits = {}, {}, {}

    def serve(policy, forced=None):
        e = ContinuousBatchingEngine(
            model, params, chunk_policy=policy,
            tbt_target_s=target if policy == "stall_free" else None, **MIX)
        if forced is not None:
            _force_chunks(e, forced)
        widths = _plan_widths(e)
        res, got = _front_run(phase, f"(d) {policy}", e, arr, "wall")
        del e.step                   # the log's wrapper, so e can go
        _add(total, got)
        ev = [x for x in res.events if x.rid == 0][0]
        if not ev.completed or len(ev.tbt_s) != STALL_SHORT[1] - 1:
            raise SystemExit(f"{phase} (d) {policy}: request 0 "
                             f"incomplete")
        chunks = [(w, n) for ws in widths for rid, w, n in ws if rid == 0]
        return e, res, ev, widths, chunks

    for policy in ("fixed", "stall_free"):
        e, res, ev, widths, chunks0[policy] = serve(policy)
        splits[policy] = e.paged_meta["splits"]
        hist = collections.Counter(n for ws in widths for _, _, n in ws)
        n_pf = sum(bool(s_.n_prefill_tokens) for s_ in e.stats.steps)
        runs[policy] = res
        log(phase, f"(d) chunk_policy={policy}"
                   + (f" (tbt_target {target * 1e3:.3f} ms = "
                      f"{STALL_TARGET} x (a)'s pure-decode p50)"
                      if policy == "stall_free" else "")
                   + f": request 0 ({STALL_SHORT[0]} prompt, "
                   f"{STALL_SHORT[1]} new) worst TBT "
                   f"{ev.max_tbt_s * 1e3:.3f} ms, p99 "
                   f"{float(np.percentile(ev.tbt_s, 99)) * 1e3:.3f} ms, p50 "
                   f"{float(np.percentile(ev.tbt_s, 50)) * 1e3:.3f} ms; the "
                   f"{STALL_LONG}-token request arrives at "
                   f"{t_long * 1e3:.1f} ms, its token "
                   f"{int(res.results[1][0])} (reported only: bf16) | "
                   f"{len(e.stats.steps)} steps, {n_pf} with prefill, "
                   f"chunk widths {dict(sorted(hist.items()))} | makespan "
                   f"{res.makespan_s * 1e3:.1f} ms | {card}")
        del e
    # request 0's tokens depend on its own prompt's chunks alone: its
    # decode rows run in the (n_slots, 1) forward at every step, at the
    # engine's one split count, and no row's sums read another's.  So the
    # fixed policy with stall-free's chunks forced must give stall-free's
    # tokens, and the two policies must agree where they chunked the
    # prompt alike (each chunk is a forward at its own width, whose bf16
    # sums may round apart)
    e, res, _, _, chunks = serve(
        "fixed", forced=[w for w, _ in chunks0["stall_free"]])
    splits["forced"] = e.paged_meta["splits"]
    del e
    t0_fixed, t0_sf = runs["fixed"].results[0], runs["stall_free"].results[0]
    same = np.array_equal(t0_fixed, t0_sf)
    forced_same = np.array_equal(res.results[0], t0_sf)
    alike = float(np.mean(np.asarray(t0_fixed) == np.asarray(t0_sf)))
    log(phase, f"(d) request 0's prompt chunks (width, tokens): fixed "
               f"{chunks0['fixed']}, stall_free {chunks0['stall_free']}, "
               f"fixed with stall_free's forced {chunks}; split counts "
               f"{splits}; its tokens identical under both policies: "
               f"{same} ({100 * alike:.1f}% alike), with the chunks forced "
               f"to stall_free's: {forced_same} | {card}")
    if len(set(splits.values())) != 1:
        raise SystemExit(f"{phase} (d): split counts {splits}")
    if chunks != chunks0["stall_free"] or not forced_same:
        raise SystemExit(f"{phase} (d): with stall_free's chunks forced, "
                         f"request 0's chunks {chunks} and tokens "
                         f"identical {forced_same}")
    if chunks0["fixed"] == chunks0["stall_free"] and not same:
        raise SystemExit(f"{phase} (d): request 0's tokens differ")
    del eng, model, params
    torch.cuda.empty_cache()

    # (b) the launcher, open loop, at shares of (a)'s closed-loop rate
    kw = dict(slots=MIX["n_slots"], requests=OPEN_N,
              prompt_len=OPEN_PROMPTS[1], min_prompt_len=OPEN_PROMPTS[0],
              gen_len=MIX_NEW, prefill_chunk=MIX["prefill_chunk"],
              page_size=MIX["page_size"], open_loop=True)
    with tempfile.TemporaryDirectory() as tmp:
        trace = os.path.join(tmp, "6l_trace.json")
        for i, (process, load) in enumerate(OPEN_LOADS):
            last = i == len(OPEN_LOADS) - 1
            res = _launch_open(phase, card, rate=load * lam_max,
                               arrival=process, cv=OPEN_CV,
                               record_trace=trace if last else None, **kw)
            _add(total, res["launches"])
        replay = _launch_open(phase, card, trace=trace, **kw)
    _add(total, replay["launches"])
    same = ({r: t.tolist() for r, t in replay["tokens"].items()}
            == {r: t.tolist() for r, t in res["tokens"].items()})
    log(phase, f"(b) the recorded trace replayed: tokens identical {same}; "
               f"phase wall {_since(t0):.1f} s | {card}")
    if not same:
        raise SystemExit(f"{phase} (b): the replay's tokens differ")
    return total


def sweep_launches(meta):
    """The paged kernel's launches in an engine's split sweep at its
    construction (0 when ``paged_meta`` came from the cache or says the
    sweep was skipped)."""
    if not meta or meta.get("source") != "measured":
        return 0
    return (meta["reps"] + 1) * len(meta["medians_s"])


def _launch_open(phase, card, **kw):
    """One ``launch.serve.run(open_loop=True)`` of (b): checked tokens and
    launches (the engine's split sweep at construction left out), the
    launcher's printout logged."""
    torch.cuda.empty_cache()
    reset_launches(SERVE_KERNELS)
    res = launch_serve.run("granite-3-2b", layers=OPEN_LOOP_LAYERS, **kw)
    got = {n: launches_of(n) for n in SERVE_KERNELS}
    served = dict(got, paged_partials=got["paged_partials"]
                  - sweep_launches(res["paged_meta"]))
    cfg = get_config("granite-3-2b", n_layers=OPEN_LOOP_LAYERS)
    _b1_only(phase, f"(b) {res['arrivals']}", served, res["forwards"],
             cfg.n_layers)
    _check_tokens(f"{phase} (b)", res["tokens"], MIX_NEW, cfg.padded_vocab)
    lat = res["latency"]
    if lat["completed"] != lat["requests"]:
        raise SystemExit(f"{phase} (b): {lat['completed']} of "
                         f"{lat['requests']} requests completed")
    for line in launch_serve.report(res).splitlines():
        log(phase, f"(b) {line}")
    log(phase, f"(b) {res['arrivals']}: {res['tokens_per_s']:.1f} tok/s "
               f"over {res['run_ms']:.1f} ms, step p50 "
               f"{res['step_ms_p50']:.3f} ms, paged_partials "
               f"{served['paged_partials']} = {cfg.n_layers} x "
               f"{res['forwards']} (+ {sweep_launches(res['paged_meta'])} "
               f"in the split sweep) | latency block "
               f"{json.dumps({k: lat[k] for k in ('ttft_s', 'tbt_s', 'e2e_s', 'queue_depth', 'makespan_s', 'goodput_tok_s', 'slo')})} "
               f"| {card}")
    res["launches"] = got
    return res


# ---------------------------------------------------------------------------
# phase 7: train at full width
# ---------------------------------------------------------------------------
# phase 6m: sharded serving over ranks on the one card
# ---------------------------------------------------------------------------
MESH_ARCH = "granite-3-2b"
MESH_LAYERS = 5               # (b) and (c): cut from 40 for the time budget
# a chunk as wide as a rank's slice of the cache under SP-KV (256 / 2)
MESH_ENGINE = dict(max_len=256, page_size=16, prefill_chunk=128)
MESH_PREFIX = 32              # (a): the requests' shared prefix, 2 pages
MESH_TIMEOUT_S = 300          # a world of ranks, start to results
MESH_THREADS = 2              # each rank's torch threads: 4 ranks, 8 cores
MESH_TOL = 2e-3               # B1 at the shard shapes, as phase 3's TOL
# (b): the bf16 first chunk's max |dlogit| against the unsharded forward
# (0.0625-0.078 in sound runs); a wo product left unsummed must exceed it
MESH_DLOGIT = 0.25
# (d)-(f): the moe, ssm and hybrid families on 1x2 at full width, depth
# cut for the script's time: phi3.5-moe's 4 of 32 layers (8 of its 16
# experts a rank), mamba2-780m's 8 of 48 (24 of 48 heads a rank), one
# period of jamba-v0.1-52b (8 of 32 layers: 1 attention, 7 mamba, MoE on
# 4); 4 requests of 32-128 prompt tokens, 16 greedy tokens
MESH_FAMILY_LAYERS = {MOE_ARCH: 4, SSM_ARCH: 8, HYBRID_ARCH: 8}
MESH_FAMILY_PROMPTS = (32, 128)
# (d): a rank's parameter bytes over the whole tree's (experts ~97% of a
# layer, half of them a rank)
MESH_RANK_BYTES = 0.55


def _mesh_prompts(cfg, n, shared=0, lo=32, hi=200, seed=7):
    """``n`` prompts of lo..hi tokens, the first ``shared`` of them the
    same in every prompt."""
    rng = np.random.default_rng(seed)
    head = rng.integers(1, cfg.vocab_size, size=shared)
    return [np.concatenate([head, rng.integers(
        1, cfg.vocab_size, size=int(rng.integers(lo, hi + 1)) - shared)])
            for _ in range(n)]


def _mesh_cfg(job):
    kw = {} if job["layers"] is None else {"n_layers": job["layers"]}
    if job["dtype"] == "float32":
        kw.update(param_dtype="float32", compute_dtype="float32")
    return get_config(job.get("arch", MESH_ARCH), **kw)


def _mesh_serve(eng, prompts, new, time_steps=False):
    """Serve every prompt (greedy); returns (tokens by request,
    pure-decode step ms, the collectives' ms inside them).  With
    ``time_steps`` each pure-decode step's events and the collectives'
    events inside it are read after the step."""
    rids = [eng.submit(p, new) for p in prompts]
    step_ms, coll_ms = [], []
    mesh = eng.mesh
    while True:
        if mesh is not None and time_steps:
            mesh.timing = []
        more = eng.step()
        plan = eng.last_plan
        if (time_steps and plan is not None and plan.n_decode
                and not plan.n_prefill_tokens):
            step_ms.append(eng.stats.steps[-1].device_ms())
            if mesh is not None:
                coll_ms.append(sum(a.elapsed_time(b)
                                   for a, b in mesh.timing))
        if not more:
            break
    if mesh is not None:
        mesh.timing = None
    out = eng.results()
    return [np.asarray(out[r]) for r in rids], step_ms, coll_ms


def _first_chunk_logits(eng, prompt):
    """Logits of the engine's first step (request 0's first prefill
    chunk, batch 1 on slot 0 through the paged kernel), on a fresh cache;
    the cache is zeroed again after."""
    return _forced_logits(eng, prompt[:eng.sched.prefill_chunk])


def _forced_logits(eng, tokens):
    """Logits of every position of ``tokens`` fed as one batch-1 chunk on
    slot 0 (the engine reset before and after): (1, len, V)."""
    eng.reset()
    n = len(tokens)
    toks = torch.as_tensor(np.asarray(tokens), device=eng.device)[None].long()
    pos = torch.arange(n, device=eng.device)[None]
    row = eng.model.cache_row(eng.cache, 0)
    with eng._ctx():
        logits, _ = eng.model.forward(
            eng.params, toks, pos, mode="decode", cache=row,
            n_valid=torch.full((1,), n, dtype=torch.int32,
                               device=eng.device),
            paged=eng._paged_state(None))
    eng.reset()
    return logits


def _unsummed_wo_logits(eng, prompt):
    """``_first_chunk_logits`` with a fault planted: the attention's
    row-parallel ``wo`` product left unsummed over the model axis (each
    rank keeps its own heads' share).  (b)'s |dlogit| limit must reject
    it."""
    summed = model_layers.row_parallel
    model_layers.row_parallel = lambda y, p, full_in, name: (
        y if name == "heads" else summed(y, p, full_in, name))
    try:
        return _first_chunk_logits(eng, prompt).cpu().numpy()
    finally:
        model_layers.row_parallel = summed


MESH_KERNELS = ("paged_partials", "wq_gemm")


def _decode_forward_launches(eng):
    """B1's and B5's launches in one pure decode forward over the
    engine's (this rank's) slots, after its run: the counts set to 0 just
    before and read just after (not the main path's)."""
    n = eng._n_local
    ones = torch.ones((n, 1), dtype=torch.long, device=eng.device)
    reset_launches(MESH_KERNELS)
    eng._forward_decode(ones, ones * 64, torch.ones(
        (n,), dtype=torch.int32, device=eng.device))
    torch.cuda.synchronize()
    return {k: launches_of(k) for k in MESH_KERNELS}


def _state_bytes(eng):
    """Bytes a slot and layer of the engine's recurrent ``h`` and conv
    window (this rank's)."""
    st = blocks.ssm_state(eng.model.cfg, eng.cache)
    return {k: st[k][0, 0].numel() * st[k].element_size()
            for k in ("h", "conv")}


def _first_divergence(got, want):
    """(request, step) of the first token that differs, or None."""
    for i, (a, b) in enumerate(zip(got, want)):
        if not np.array_equal(a, b):
            n = min(len(a), len(b))
            diff = np.nonzero(a[:n] != b[:n])[0]
            return i, int(diff[0]) if len(diff) else n
    return None


def _mesh_rank(rank, jobs):
    """One rank: every job in order (each a mesh, a config, requests);
    the counts of B1 (and of its kv_offset mode) and B5 set to 0 just
    before each job serves and read just after.  A job that carries the
    unsharded engine's tokens (``want``) compares its own: at the first
    that differs it returns the logits of that step (the request's
    prompt and the unsharded tokens before it fed as one chunk)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    out = []
    for job in jobs:
        cfg = _mesh_cfg(job)
        mesh = mesh_lib.parse_mesh(job["mesh"])
        model = LM(cfg, device=mesh.device)
        rules = rules_for(cfg, mesh, sp_kv=job["sp_kv"])
        params = model.init_params(
            torch.Generator(device=mesh.device).manual_seed(0),
            int8=job["int8"],
            shard=lambda t, sp: paxes.shard_tree(t, sp, mesh, rules))
        eng = ContinuousBatchingEngine(
            model, params, n_slots=job["slots"], mesh=mesh,
            sp_kv=job["sp_kv"], prefix_cache=job["prefix"],
            check=job["prefix"], **MESH_ENGINE)
        del params
        res = dict(name=job["name"], mesh=repr(mesh),
                   meta=eng.sharding_meta, param_bytes=quant_bytes(
                       eng.params))
        if job["logits"]:
            res["logits"] = _first_chunk_logits(
                eng, job["prompts"][0]).cpu().numpy()
            res["unsummed_logits"] = _unsummed_wo_logits(
                eng, job["prompts"][0])
        reset_launches(MESH_KERNELS)
        pa_ops.decode_partials.launches = 0
        toks, step_ms, coll_ms = _mesh_serve(eng, job["prompts"],
                                             job["new"], job["time"])
        torch.cuda.synchronize()
        res.update(tokens=toks, step_ms=step_ms, coll_ms=coll_ms,
                   launches={n: launches_of(n) for n in MESH_KERNELS},
                   kv_offset_launches=pa_ops.decode_partials.launches,
                   prefix_hits=eng.stats.prefix_hit_tokens,
                   errors=[f.format() for f in eng.check_findings
                           if f.severity == "error"])
        if job.get("family"):
            res["forward_launches"] = _decode_forward_launches(eng)
            if cfg.ssm is not None:
                res["state_bytes"] = _state_bytes(eng)
            at = _first_divergence(toks, job["want"])
            if at is not None:
                i, t = at
                seq = np.concatenate([job["prompts"][i], job["want"][i][:t]])
                res["diverged"] = dict(request=i, step=t, logits=(
                    _forced_logits(eng, seq)[0, -1].cpu().numpy()))
        out.append(res)
        del eng
        torch.cuda.empty_cache()
    return out


def spkv_plain(q, k, v, positions, kv_valid, off, softcap):
    """``decode_partials``' function plainly, on absolute positions: the
    scores of the slice's keys (cache positions off ... off + S - 1) under
    the mask ``t <= position and t < kv_valid``; fp32 (m, l, acc) shaped
    (B, NQ, Sq)[, H], masked keys adding exactly 0."""
    B, Sq, NQ, H = q.shape
    S, NKV = k.shape[1], k.shape[2]
    G = NQ // NKV
    kT = k.float().repeat_interleave(G, dim=2).transpose(1, 2)
    vT = v.float().repeat_interleave(G, dim=2).transpose(1, 2)
    s = torch.einsum("bqnh,bnkh->bnqk", q.float(), kT) * H ** -0.5
    if softcap:
        s = softcap * torch.tanh(s / softcap)
    t = off + torch.arange(S, device=q.device)
    mask = ((t[None, None, None] <= positions[:, None, :, None])
            & (t[None, None, None] < kv_valid[:, None, None, None]))
    s = torch.where(mask, s, pa_ref.NEG_INF)
    m = s.amax(-1)
    p = torch.where(mask, torch.exp(s - m[..., None]), 0.0)
    return m, p.sum(-1), torch.einsum("bnqk,bnkh->bnqh", p, vT)


# (slice length = offset, each row's kv_valid, the query lengths): the
# second shard of (a)'s cache, at Sq 1 and (a)'s prefill chunk (timed);
# granite's second shard of a 512-token cache, and of a 400-token one,
# whose 200-key slice ends in a partial 32-key tile, at Sq 1 and 32
_S_SHARD = MESH_ENGINE["max_len"] // 2
SPKV_SHARDS = ((_S_SHARD, (0, _S_SHARD // 2, _S_SHARD, _S_SHARD + 12,
                           _S_SHARD + _S_SHARD // 2, 2 * _S_SHARD - 27,
                           2 * _S_SHARD - 6, 2 * _S_SHARD),
                (1, MESH_ENGINE["prefill_chunk"])),
               (256, (0, 100, 256, 270, 300, 401, 480, 512), (1, 32)),
               (200, (0, 100, 200, 214, 250, 301, 380, 400), (1, 32)))


def kernels_spkv(card, hw):
    """B1 through ``decode_partials`` at a rank's shard of granite's
    cache (8 slots, the second half of the cache: ``SPKV_SHARDS``, the
    first (a)'s own); rows whose keys all lie before the slice and rows
    into it; the chunks end at each row's valid length, so a row 12 or
    14 keys into the slice has a chunk that starts before it."""
    worst, rows, n = 0.0, [], 0
    for i, (S, valid, sqs) in enumerate(SPKV_SHARDS):
        w, r, k = _spkv_shard(S, valid, sqs, hw, timed=i == 0)
        worst, n = max(worst, w), n + k
        rows += r
    shapes = "; ".join(f"{S} keys at Sq {' and '.join(map(str, sqs))}"
                       for S, _, sqs in SPKV_SHARDS)
    log("serve-mesh", f"B1 at the shard shapes: {n} cases ok (slices of "
                      f"{shapes}; bf16 and fp32, softcap 0 and {SOFTCAP:g}; "
                      f"rows with no key in the slice, chunks starting "
                      f"before it), max abs err {worst:.2e} | bf16 granite "
                      f"8 slots, slice {_S_SHARD} at {_S_SHARD} ((a)'s "
                      f"second shard): {' | '.join(rows)} | {card}")
    return worst


def _spkv_shard(S, valid, sqs, hw, timed):
    dev = torch.device("cuda")
    B, NKV, G, H, off = 8, 8, 4, 64, S
    valid = torch.tensor(valid, dtype=torch.int32, device=dev)
    worst, rows, n = 0.0, [], 0
    for sq in sqs:
        pos = ((valid - sq).clamp_min(0)[:, None]
               + torch.arange(sq, device=dev)[None]).to(torch.int32)
        for dtype in (torch.bfloat16, torch.float32):
            g = torch.Generator(device=dev).manual_seed(sq)
            q = torch.randn((B, sq, NKV * G, H), generator=g, device=dev)
            k = torch.randn((B, S, NKV, H), generator=g, device=dev).to(dtype)
            v = torch.randn((B, S, NKV, H), generator=g, device=dev).to(dtype)
            for softcap in (0.0, SOFTCAP):
                qs = q * (SOFTCAP_Q_SCALE if softcap else 1.0)
                got = pa_ops.decode_partials(qs, k, v, pos, valid,
                                             kv_offset=off, softcap=softcap)
                want = spkv_plain(qs, k, v, pos, valid, off, softcap)
                name = (f"B1 kv_offset {off} of S {S} Sq{sq} "
                        f"{str(dtype)[6:]} softcap {softcap:g}")
                live = want[1] > 0
                for g_, w_, what in zip(got, want, ("m", "l", "acc")):
                    if not torch.isfinite(g_).all():
                        raise SystemExit(f"{name}: non-finite {what}")
                    if what == "m":
                        g_, w_ = g_[live], w_[live]
                    torch.testing.assert_close(
                        g_, w_, atol=MESH_TOL, rtol=MESH_TOL,
                        msg=lambda m_: f"{name} {what}: {m_}")
                if (got[1][~live] != 0).any() or (got[2][~live] != 0).any():
                    raise SystemExit(f"{name}: a query with no key in the "
                                     f"slice has l or acc != 0")
                out_k = got[2] / got[1].clamp_min(1e-30)[..., None]
                out_p = want[2] / want[1].clamp_min(1e-30)[..., None]
                worst = max(worst, float((out_k - out_p).abs().max()))
                n += 1
            if dtype != torch.bfloat16 or not timed:
                continue
            mask = ((off + torch.arange(S, device=dev))[None, None]
                    <= pos[..., None]) & (
                (off + torch.arange(S, device=dev))[None, None]
                < valid[:, None, None])
            qT = q.to(dtype).transpose(1, 2).contiguous()
            kT, vT = k.transpose(1, 2).contiguous(), v.transpose(
                1, 2).contiguous()
            t = time_three({
                "kernel": lambda: pa_ops.decode_partials(
                    q, k, v, pos, valid, kv_offset=off),
                "plain": lambda: spkv_plain(q, k, v, pos, valid, off, 0.0),
                "library": lambda: F.scaled_dot_product_attention(
                    qT, kT, vT, attn_mask=mask[:, None], enable_gqa=True)})
            keys = (valid - off).clamp(0, S).double()
            nbytes = float(2 * keys.sum() * NKV * H * k.element_size()
                           + q.numel() * 4 + 2 * B * 4
                           + B * NKV * G * sq * (H + 2) * 4)
            flops = float(4 * keys.sum() * NKV * G * sq * H)
            b_s, b_by = hw.bound_s(flops, nbytes, torch.bfloat16)
            rows.append(
                f"Sq{sq}: kernel_ms {t['kernel']:.4f} plain_ms "
                f"{t['plain']:.4f} library_ms {t['library']:.4f} bound_ms "
                f"{b_s * 1e3:.4f} ({b_by})")
    return worst, rows, n


def _mesh_jobs(cfg_a, cfg_b):
    prompts_a = _mesh_prompts(cfg_a, 8, shared=MESH_PREFIX)
    prompts_b = _mesh_prompts(cfg_b, 4, seed=8)
    job = dict(layers=None, dtype="float32", int8=False, sp_kv=False,
               prefix=False, logits=False, time=False)
    a = dict(job, name="a", mesh="2x2", sp_kv=True, prefix=True, slots=4,
             prompts=prompts_a, new=16)
    b = dict(job, name="b", mesh="1x2", layers=MESH_LAYERS,
             dtype="bfloat16", slots=4, prompts=prompts_b[:4], new=16,
             logits=True, time=True)
    c = dict(job, name="c", mesh="1x2", layers=MESH_LAYERS, int8=True,
             slots=4, prompts=prompts_b, new=8)
    return a, b, c


def _mesh_family_jobs():
    """(d), (e), (f): phi3.5-moe int8, mamba2-780m, jamba int8 on 1x2, in
    fp32 compute, 4 requests of 32-128 tokens on 4 slots, 16 new."""
    lo, hi = MESH_FAMILY_PROMPTS
    out = []
    for name, arch, int8 in (("d", MOE_ARCH, True), ("e", SSM_ARCH, False),
                             ("f", HYBRID_ARCH, True)):
        job = dict(name=name, arch=arch, layers=MESH_FAMILY_LAYERS[arch],
                   dtype="float32", int8=int8, mesh="1x2", sp_kv=False,
                   prefix=False, logits=False, time=name == "f", slots=4,
                   new=16, family=True)
        job["prompts"] = _mesh_prompts(_mesh_cfg(job), 4, lo=lo, hi=hi,
                                       seed=9)
        out.append(job)
    return out


def _mesh_unsharded(job):
    """The unsharded engine's run of a job on the card (same seeded
    weights): (tokens, the first chunk's logits or None, pure-decode
    step ms, the whole tree's bytes, and for (d)-(f) B1's and B5's
    launches in one pure decode forward and the logits of every
    generated token, each request's prompt and tokens fed as one
    chunk)."""
    cfg = _mesh_cfg(job)
    model = LM(cfg)
    params = model.init_params(
        torch.Generator(device=model.device).manual_seed(0),
        int8=job["int8"])
    eng = ContinuousBatchingEngine(model, params, n_slots=job["slots"],
                                   prefix_cache=job["prefix"],
                                   **MESH_ENGINE)
    logits = (_first_chunk_logits(eng, job["prompts"][0]).cpu().numpy()
              if job["logits"] else None)
    toks, step_ms, _ = _mesh_serve(eng, job["prompts"], job["new"],
                                   job["time"])
    nbytes = quant_bytes(params)
    fwd, forced = None, None
    if job.get("family"):
        fwd = _decode_forward_launches(eng)
        forced = [_forced_logits(eng, np.concatenate([p, t[:-1]]))[
            0, len(p) - 1:].cpu().numpy()
            for p, t in zip(job["prompts"], toks)]
    del eng, params
    torch.cuda.empty_cache()
    return toks, logits, step_ms, nbytes, fwd, forced


def int8_per_rank(cfg, split: int) -> int:
    """``int8_per_forward`` on a rank holding 1/``split`` of each MoE
    layer's experts (expert-parallel): 3 launches an expert it holds."""
    moe = sum(cfg.layer_uses_moe(i) for i in range(cfg.n_layers))
    E = cfg.moe.num_experts if cfg.moe is not None else 0
    return int8_per_forward(cfg) - 3 * moe * (E - E // split)


def _mesh_family_checks(job, want, ranks, card, t0):
    """(d)-(f): every rank's tokens the unsharded engine's (else the
    step, its max |dlogit| and the top-2 gap there); (d), (f) B5's
    launches in a decode forward, reckoned, and B1 on both ranks; (d) a
    rank's bytes; (e) the state's bytes a slot and layer; (f)'s timing,
    reported.  Returns the ranks' main-path launches."""
    toks, _, step_ms, whole, fwd, forced = want
    cfg = _mesh_cfg(job)
    phase = f"serve-mesh ({job['name']})"
    for rank, res in enumerate(ranks):
        div = res.get("diverged")
        if div is not None:
            ref = forced[div["request"]][div["step"]]
            top = np.sort(ref)[-2:]
            raise SystemExit(
                f"{phase}: rank {rank}'s request {div['request']} diverges "
                f"from the unsharded engine's at step {div['step']}: max "
                f"|dlogit| {float(np.abs(div['logits'] - ref).max()):.4e}, "
                f"the unsharded top-2 gap {float(top[1] - top[0]):.4e}")
    _same_tokens(phase, toks, ranks)
    launches, line = {}, ""
    for res in ranks:
        _add(launches, res["launches"])
    if job["int8"]:
        per = int8_per_rank(cfg, 2)
        got = [r["forward_launches"]["wq_gemm"] for r in ranks]
        if got != [per, per] or fwd["wq_gemm"] != int8_per_forward(cfg):
            raise SystemExit(f"{phase}: B5 launches in a decode forward "
                             f"{got} a rank (unsharded {fwd['wq_gemm']}), "
                             f"reckoned {per} ({int8_per_forward(cfg)})")
        b1 = [r["launches"]["paged_partials"] for r in ranks]
        if min(b1) == 0:
            raise SystemExit(f"{phase}: B1 launches a rank {b1}")
        line += (f" | B5 in one decode forward {got} a rank = "
                 f"int8_per_forward {int8_per_forward(cfg)} less 3 x "
                 f"{cfg.moe.num_experts // 2} experts x "
                 f"{sum(cfg.layer_uses_moe(i) for i in range(cfg.n_layers))}"
                 f" MoE layers (unsharded {fwd['wq_gemm']}); main-path "
                 f"launches a rank B5 "
                 f"{[r['launches']['wq_gemm'] for r in ranks]}, B1 {b1}")
    share = [r["param_bytes"] / whole for r in ranks]
    if job["name"] == "d" and max(share) > MESH_RANK_BYTES:
        raise SystemExit(f"{phase}: a rank holds {max(share):.3f} of the "
                         f"tree's bytes, over {MESH_RANK_BYTES}")
    line += (f" | param bytes a rank {[r['param_bytes'] for r in ranks]} "
             f"of {whole} ({max(share):.3f})")
    if cfg.ssm is not None:
        s = cfg.ssm
        d_inner = s.expand * cfg.d_model
        el = 4 if job["dtype"] == "float32" else 2
        reckoned = {"h": d_inner // 2 // s.head_dim * s.head_dim
                    * s.ngroups * s.d_state * 4,
                    "conv": (d_inner // 2 + 2 * s.ngroups * s.d_state)
                    * (s.conv_kernel - 1) * el}
        got = [r["state_bytes"] for r in ranks]
        if any(g != reckoned for g in got):
            raise SystemExit(f"{phase}: state bytes a slot and layer {got},"
                             f" reckoned {reckoned}")
        line += (f" | h and conv window bytes a slot and layer {got[0]} "
                 f"on each rank, as reckoned ({d_inner // 2 // s.head_dim} "
                 f"of {d_inner // s.head_dim} heads; "
                 f"{d_inner // 2} + {2 * s.ngroups * s.d_state} channels x "
                 f"{s.conv_kernel - 1} taps)")
    if job["time"]:
        steps = ranks[0]["step_ms"]
        if not steps:
            raise SystemExit(f"{phase}: no pure-decode step")
        line += (f" | pure-decode step p50 {statistics.median(steps):.3f} "
                 f"ms on rank 0 ({len(steps)} steps), "
                 f"{100 * sum(ranks[0]['coll_ms']) / sum(steps):.1f}% of "
                 f"it inside the collectives; the unsharded engine's p50 "
                 f"{statistics.median(step_ms):.3f} ms (two ranks "
                 f"time-sharing one card through host-staged gloo: these "
                 f"times say nothing of a deployment over cards)")
    log("serve-mesh", f"({job['name']}) {job['arch']} "
                      f"{'int8' if job['int8'] else 'fp32'}, fp32 compute, "
                      f"cut to {cfg.n_layers} layers, "
                      f"{ranks[0]['mesh'].split(';')[0]}) over 2 ranks: 4 "
                      f"requests of {min(p.size for p in job['prompts'])}"
                      f"...{max(p.size for p in job['prompts'])} tokens, "
                      f"{job['new']} new: tokens identical to the unsharded "
                      f"engine's on both ranks | rules expert "
                      f"{ranks[0]['meta']['rules']['expert']}, heads "
                      f"{ranks[0]['meta']['rules']['heads']}{line} | "
                      f"{_since(t0):.1f} s into 6m | {card}")
    return launches


def _same_tokens(phase, want, ranks):
    for res in ranks:
        if len(res["tokens"]) != len(want) or not all(
                np.array_equal(a, b) for a, b in zip(res["tokens"], want)):
            raise SystemExit(f"{phase}: a rank's tokens differ from the "
                             f"unsharded engine's")


def phase_serve_mesh(card, hw):
    """6m: B1 at the shard shapes, then (a) to (f) (see the module
    docstring); returns the ranks' B1 and B5 launches."""
    t0 = datetime.datetime.now()
    kernels_spkv(card, hw)
    torch.backends.cuda.matmul.allow_tf32 = False
    a, b, c = _mesh_jobs(_mesh_cfg(dict(layers=None, dtype="float32")),
                         _mesh_cfg(dict(layers=MESH_LAYERS,
                                        dtype="bfloat16")))
    family = _mesh_family_jobs()
    want = {job["name"]: _mesh_unsharded(job)
            for job in (a, b, c, *family)}
    for job in family:
        job["want"] = want[job["name"]][0]
    log("serve-mesh", f"the unsharded runs done, {_since(t0):.1f} s into "
                      f"6m")
    launches = {}
    # (a): 4 ranks, 2x2 with SP-KV
    ranks = [r[0] for r in mesh_lib.spawn_ranks(
        _mesh_rank, 4, ([a],), timeout=MESH_TIMEOUT_S,
        threads=MESH_THREADS)]
    _same_tokens("serve-mesh (a)", want["a"][0], ranks)
    for rank, res in enumerate(ranks):
        if res["errors"]:
            raise SystemExit(f"serve-mesh (a) rank {rank}: {res['errors']}")
        if res["kv_offset_launches"] == 0 or res["launches"][
                "paged_partials"] != res["kv_offset_launches"]:
            raise SystemExit(f"serve-mesh (a) rank {rank}: B1 launches "
                             f"{res['launches']['paged_partials']}, "
                             f"{res['kv_offset_launches']} of them at a "
                             f"kv_offset")
        _add(launches, res["launches"])
    meta = ranks[0]["meta"]
    log("serve-mesh", f"(a) {MESH_ARCH} fp32 full width (40 layers), "
                      f"{ranks[0]['mesh'].split(';')[0]}) over 4 spawned "
                      f"ranks on one card, backend "
                      f"{ranks[0]['mesh'].split('; ')[2]}: 8 requests of "
                      f"{a['prompts'][0].size}..."
                      f"{max(p.size for p in a['prompts'])} tokens "
                      f"(a {MESH_PREFIX}-token shared prefix, prefix hits "
                      f"{ranks[0]['prefix_hits']}) on 4 slots, 16 new: "
                      f"tokens identical to the unsharded engine's on every "
                      f"rank | sharding_meta {json.dumps(meta)} | param "
                      f"bytes a rank "
                      f"{[r['param_bytes'] for r in ranks]} of the whole "
                      f"tree's {want['a'][3]} | B1 launches a rank "
                      f"{[r['launches']['paged_partials'] for r in ranks]}"
                      f", in the kv_offset mode "
                      f"{[r['kv_offset_launches'] for r in ranks]} | "
                      f"{_since(t0):.1f} s into 6m | {card}")
    # (b) to (f): 2 ranks, 1x2
    ranks = mesh_lib.spawn_ranks(_mesh_rank, 2, ([b, c, *family],),
                                 timeout=MESH_TIMEOUT_S,
                                 threads=MESH_THREADS)
    rb, rc = [r[0] for r in ranks], [r[1] for r in ranks]
    dlogit, planted = (max(float(np.abs(r[key] - want["b"][1]).max())
                           for r in rb)
                       for key in ("logits", "unsummed_logits"))
    if not all(np.isfinite(r["logits"]).all() for r in rb):
        raise SystemExit("serve-mesh (b): non-finite logits")
    if not dlogit <= MESH_DLOGIT:
        raise SystemExit(f"serve-mesh (b): the first chunk's max |dlogit| "
                         f"{dlogit:.4e} is over {MESH_DLOGIT}")
    if not planted > MESH_DLOGIT:
        raise SystemExit(f"serve-mesh (b): with wo left unsummed the max "
                         f"|dlogit| is {planted:.4e}, within the limit "
                         f"{MESH_DLOGIT}: the limit catches no fault")
    steps = rb[0]["step_ms"]
    if not steps:
        raise SystemExit("serve-mesh (b): no pure-decode step")
    p50 = statistics.median(steps)
    share = sum(rb[0]["coll_ms"]) / sum(steps)
    agree = np.mean([np.array_equal(x, y) for x, y in
                     zip(rb[0]["tokens"], want["b"][0])])
    for res in rb:
        _add(launches, res["launches"])
    log("serve-mesh", f"(b) {MESH_ARCH} bf16 cut to {MESH_LAYERS} of 40 "
                      f"layers, {rb[0]['mesh'].split(';')[0]}) over 2 ranks "
                      f"on one card ({rb[0]['mesh'].split('; ')[2]}): first "
                      f"chunk's max |dlogit| {dlogit:.4e} against the "
                      f"unsharded forward, within {MESH_DLOGIT} (with wo's "
                      f"sum over the model axis dropped: {planted:.4e}, "
                      f"rejected) | pure-decode step p50 "
                      f"{p50:.3f} ms on rank 0 ({len(steps)} steps), "
                      f"{100 * share:.1f}% of it inside the collectives; "
                      f"the unsharded engine's p50 "
                      f"{statistics.median(want['b'][2]):.3f} ms | requests "
                      f"whose greedy tokens equal the unsharded engine's "
                      f"{agree:.3f} (bf16: reported only) | two ranks "
                      f"time-sharing one card through host-staged gloo "
                      f"collectives: these times say nothing of a "
                      f"deployment over several cards | "
                      f"{_since(t0):.1f} s into 6m | {card}")
    _same_tokens("serve-mesh (c)", want["c"][0], rc)
    if any(r["launches"]["wq_gemm"] == 0 for r in rc):
        raise SystemExit("serve-mesh (c): a rank launched no int8 GEMM")
    for res in rc:
        _add(launches, res["launches"])
    log("serve-mesh", f"(c) {MESH_ARCH} int8 fp32 compute cut to "
                      f"{MESH_LAYERS} layers, {rc[0]['mesh'].split(';')[0]}"
                      f"), 4 requests of 8 tokens: tokens identical to the "
                      f"unsharded int8 engine's on both ranks | B5 launches "
                      f"a rank {[r['launches']['wq_gemm'] for r in rc]}, B1 "
                      f"{[r['launches']['paged_partials'] for r in rc]} | "
                      f"param bytes a rank {[r['param_bytes'] for r in rc]}"
                      f" of {want['c'][3]} | {card}")
    for i, job in enumerate(family):
        _add(launches, _mesh_family_checks(
            job, want[job["name"]], [r[2 + i] for r in ranks], card, t0))
    return launches


# ---------------------------------------------------------------------------
def _train_log(what, log_, B, S, card, phase="train"):
    for r in log_:
        log(phase, f"{what} step {r['step']}: {r['seconds'] * 1e3:.1f} ms, "
                   f"{B * S / r['seconds']:.0f} tokens/s, loss "
                   f"{r['loss']:.4f}, grad norm {r['grad_norm']:.4f}, lr "
                   f"{r['lr']:.2e} | {card}")


def _train_run(cfg, per_step, B, S, steps, ckpt_dir, what, card,
               kernel="flash_attention", phase="train", every=3):
    """launch.train.run, the launches of ``kernel`` held to ``per_step`` a
    step."""
    before = launches_of(kernel)
    out = launch_train.run(cfg, steps=steps, batch=B, seq=S,
                           ckpt_dir=ckpt_dir, checkpoint_every=every)
    launched = launches_of(kernel) - before
    if launched != per_step * len(out["log"]) or not out["log"]:
        raise SystemExit(f"{what}: {launched} {kernel} launches over "
                         f"{len(out['log'])} steps, expected {per_step} a "
                         f"step")
    losses = [r["loss"] for r in out["log"]]
    if not all(np.isfinite(losses)):
        raise SystemExit(f"{what}: loss {losses}")
    _train_log(what, out["log"], B, S, card, phase)
    return out, launched


def _restored_bitwise(ckpt_dir, step, state, phase, t0):
    """Exit unless ``ckpt_dir`` holds only ``step`` and it restores to
    ``state`` bit for bit, leaf for leaf."""
    ck = Checkpointer(ckpt_dir)
    if ck.all_steps() != [step]:
        raise SystemExit(f"checkpoints {ck.all_steps()}, expected [{step}]")
    restored, manifest = ck.restore(step, like=state)
    saved = tree_leaves(state)
    back = tree_leaves(restored)
    if len(saved) != len(back) or not all(
            a.dtype == b.dtype and a.device == b.device and torch.equal(a, b)
            for a, b in zip(saved, back)):
        raise SystemExit("the restored checkpoint differs from the state")
    log(phase, f"checkpoint at step {manifest['step']}: {len(back)} "
               f"leaves in {len(manifest['leaves'])} files restored "
               f"bitwise; phase wall {_since(t0):.1f} s so far")


def phase_train(card, profile=False):
    """Full-width qwen3-1.7b through the launcher with the flash kernel:
    3 steps and a checkpoint, the checkpoint restored bitwise, a run
    resumed from it to step 6; then 2 steps at batch 1 x seq 4096.
    Returns the flash launches of the whole phase."""
    t0 = datetime.datetime.now()
    cfg = get_config(TRAIN_ARCH, attention_impl="pallas")
    per_step = 2 * cfg.n_layers            # remat full: forward runs twice
    shutil.rmtree(TRAIN_CKPT, ignore_errors=True)
    fa_kernel.flash_fwd.launches = 0
    B, S = TRAIN_SHAPES[0]
    torch.cuda.reset_peak_memory_stats()
    first, _ = _train_run(cfg, per_step, B, S, 3, TRAIN_CKPT,
                          f"{TRAIN_ARCH} bf16 B{B} S{S}", card)
    _restored_bitwise(TRAIN_CKPT, 3, first["state"], "train", t0)
    loss0 = first["log"][0]["loss"]
    first_log = first["log"]
    del first
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    resumed, _ = _train_run(cfg, per_step, B, S, 6, TRAIN_CKPT,
                            f"{TRAIN_ARCH} bf16 B{B} S{S} resumed", card)
    steps = [r["step"] for r in resumed["log"]]
    loss1 = resumed["log"][-1]["loss"]
    if steps != [3, 4, 5] or not loss1 < loss0:
        raise SystemExit(f"resumed at steps {steps}; loss {loss0} -> {loss1}")
    drift = max(abs(x / ref - 1) for x, ref in zip((loss0, loss1),
                                                    TRAIN_LOSS_BEFORE))
    if drift > TRAIN_LOSS_RTOL:
        raise SystemExit(f"loss {loss0} -> {loss1}, {drift:.2e} from the "
                         f"CUDA-core forward's {TRAIN_LOSS_BEFORE}")
    log("train", f"losses of steps 0-2 and 3-5 (for a bitwise comparison "
                 f"between runs): {[repr(r['loss']) for r in first_log]} "
                 f"{[repr(r['loss']) for r in resumed['log']]}; steps 0 "
                 f"and 5 {drift:.2e} from the CUDA-core forward's")
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    ms = [r["seconds"] * 1e3 for r in resumed["log"]]
    log("train", f"{TRAIN_ARCH} bf16 full width, B{B} S{S}: loss {loss0:.4f} "
                 f"-> {loss1:.4f} over 6 steps (resumed at 3), steady step "
                 f"{statistics.median(ms):.1f} ms, "
                 f"{B * S / statistics.median(ms) * 1e3:.0f} tokens/s, flash "
                 f"launches {per_step} a step, peak {peak:.2f} GiB | {card}")
    del resumed
    shutil.rmtree(TRAIN_CKPT, ignore_errors=True)
    torch.cuda.empty_cache()
    B, S = TRAIN_SHAPES[1]
    torch.cuda.reset_peak_memory_stats()
    long_, _ = _train_run(cfg, per_step, B, S, 2, None,
                          f"{TRAIN_ARCH} bf16 B{B} S{S}", card)
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    log("train", f"{TRAIN_ARCH} bf16 full width, B{B} S{S}: peak "
                 f"{peak:.2f} GiB; phase wall {_since(t0):.1f} s | {card}")
    del long_
    torch.cuda.empty_cache()
    launches = fa_kernel.flash_fwd.launches
    if profile:
        for B, S in TRAIN_SHAPES:
            profile_train_step(cfg, B, S, card)
    return launches


# ---------------------------------------------------------------------------
# phase 7b: the train stack's other families and options at full width
# ---------------------------------------------------------------------------
# qwen3-1.7b at TRAIN_SHAPES[1], one variant a run: (what, config
# overrides, make_train_step options); the first is phase 7's step
# 7b (c)'s qwen3-1.7b, cut from 28 layers for the script's time (its
# options are held against remat full's at the same depth)
TRAIN_VARIANT_LAYERS = 14
TRAIN_VARIANTS = (
    ("remat full", {}, {}),
    ("fused_xent", {}, {"fused_xent": True}),
    ("int8_ef", {}, {"grad_compression": "int8_ef"}),
    ("remat none", {"remat": "none"}, {}),
    ("remat save_blocks", {"remat": "save_blocks"}, {}),
    ("remat dots", {"remat": "dots"}, {}))


def _timed_step(step, state, batch):
    """One train step between CUDA events: (state, metrics, ms)."""
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    state, metrics = step(state, batch)
    end.record()
    end.synchronize()
    return state, metrics, start.elapsed_time(end)


def _grad_rel_err(grads, ref):
    """The largest per-leaf ||g - r|| / ||r|| of ``grads`` (on the card)
    against ``ref`` (the same leaves on the host), and its leaf's index."""
    worst, at = 0.0, -1
    for i, (g, r) in enumerate(zip(grads, ref)):
        r = r.to(g.device, torch.float32)
        err = float(torch.linalg.vector_norm(g.float() - r)
                    / torch.linalg.vector_norm(r).clamp_min(1e-30))
        if err > worst:
            worst, at = err, i
    return worst, at


def train_variant(what, cfg_kw, step_kw, card, ref_grads=None):
    """qwen3-1.7b at full width, ``TRAIN_VARIANT_LAYERS`` deep, at
    TRAIN_SHAPES[1] built through ``make_train_step`` with ``step_kw``.  First the loss and its gradient
    alone at the initial parameters on step 0's batch, for their own peak
    (the optimizer's fp32 temporaries left out) and for step 0's gradient
    leaves: held against ``ref_grads`` (remat full's, on the host) when
    given, else copied to the host and returned as them.  Then three
    steps.  Returns a dict: the losses, the mean ms of steps 1 and 2, the
    peak GiB over the steps, step 0's ``grad_norm`` (after the int8
    round trip under int8_ef), the gradient's worst per-leaf relative
    error and, under int8_ef, the residual's largest element against
    half a quantization step of the largest gradient element and its
    norm.  Exits unless B2 launched ``train_launches`` a step, the losses
    are finite and, under int8_ef, ``grad_err`` holds 4 bytes a
    parameter."""
    cfg = get_config(TRAIN_ARCH, attention_impl="pallas",
                     n_layers=TRAIN_VARIANT_LAYERS, **cfg_kw)
    model = LM(cfg)
    opt = AdamWConfig(lr=warmup_cosine(3e-4, 10, 3))
    state = init_train_state(
        model, torch.Generator(device=model.device).manual_seed(0), opt,
        step_kw.get("grad_compression"))
    step = make_train_step(model, opt, **step_kw)
    B, S = TRAIN_SHAPES[1]
    stream = SyntheticLMStream(cfg, B, S)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _, grads = value_and_grad(make_loss_fn(model, fused_xent=step_kw.get(
        "fused_xent", False)))(state["params"], stream.batch_for_step(0))
    torch.cuda.synchronize()
    grad_peak = torch.cuda.max_memory_allocated() / 2 ** 30
    grads = tree_leaves(grads)
    out = {"grad_norm_g": float(global_norm(grads)),
           "amax_g": float(max(g.abs().max() for g in grads))}
    if ref_grads is None:
        out["ref_grads"] = [g.cpu() for g in grads]
        out["grad_err"], at = 0.0, -1
    else:
        out["grad_err"], at = _grad_rel_err(grads, ref_grads)
    del grads
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    before = launches_of("flash_attention")
    losses, ms = [], []
    for i in range(3):
        state, metrics, t = _timed_step(step, state, stream.batch_for_step(i))
        losses.append(float(metrics["loss"]))
        ms.append(t)
        if i == 0:
            out["grad_norm"] = float(metrics["grad_norm"])
            if "grad_err" in state:
                err = tree_leaves(state["grad_err"])
                out["ef_max"] = float(max(e.abs().max() for e in err))
                out["ef_norm"] = float(global_norm(err))
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    launched = launches_of("flash_attention") - before
    want = 3 * train_launches(cfg)["flash_attention"]
    if launched != want or not all(np.isfinite(losses)):
        raise SystemExit(f"{what}: {launched} flash launches (expected "
                         f"{want}), losses {losses}")
    extra = ""
    if "grad_err" in state:
        n = sum(p.numel() for p in tree_leaves(state["params"]))
        got = sum(t.numel() * t.element_size()
                  for t in tree_leaves(state["grad_err"]))
        if got != 4 * n:
            raise SystemExit(f"{what}: grad_err {got} bytes, expected 4 x "
                             f"{n} params")
        extra = (f"; grad_err {got} bytes = 4 x {n} params; after step 0 "
                 f"its largest element {out['ef_max']:.4e} (half a step of "
                 f"the largest gradient element: {out['amax_g'] / 254:.4e})"
                 f", its norm {out['ef_norm']:.4e}")
    steady = (ms[1] + ms[2]) / 2
    log("train-families", f"{TRAIN_ARCH} bf16 B{B} S{S} {what}: steps "
                          f"{ms[0]:.1f} / {ms[1]:.1f} / {ms[2]:.1f} ms, "
                          f"{B * S / steady * 1e3:.0f} tokens/s (steps 1-2), "
                          f"loss {losses[0]!r} / {losses[1]!r} / "
                          f"{losses[2]!r}, step 0 grad_norm "
                          f"{out['grad_norm']!r} (of the gradient alone "
                          f"{out['grad_norm_g']!r}), step 0's gradient "
                          f"against remat full's: worst leaf {at} rel err "
                          f"{out['grad_err']:.3e}, flash launches "
                          f"{launched // 3} a step, peak {peak:.2f} GiB "
                          f"(loss and gradient alone {grad_peak:.2f})"
                          f"{extra} | {card}")
    del state, step, model
    torch.cuda.empty_cache()
    out.update(losses=losses, steady=steady, peak=peak)
    return out


def _variant_faults(got):
    """What in ``got`` (``train_variant``'s results by variant; the first
    remat full) breaks the bounds: every variant's step 0 loss, and but
    for int8_ef's (its updates differ by design) its step 2 loss, within
    TRAIN_LOSS_RTOL of remat full's; the step 0 gradient within GRAD_RTOL
    of remat full's leaf by leaf but under fused_xent (reported; its fp32
    gradient is held by ``fused_xent_fp32``); step 0's grad_norm within
    GRAD_RTOL of remat full's (fused_xent: FUSED_NORM_RTOL); under int8_ef
    the residual's elements within half a quantization step (the largest
    gradient element / 254) and step 0's grad_norm within the residual's
    norm of the gradient's (the triangle inequality), each with
    GRAD_RTOL's slack."""
    base = got[TRAIN_VARIANTS[0][0]]
    faults = []
    for what, r in got.items():
        for i in ((0,) if "ef_max" in r else (0, 2)):
            drift = abs(r["losses"][i] / base["losses"][i] - 1)
            if drift > TRAIN_LOSS_RTOL:
                faults.append(f"{what}: step {i} loss {drift:.2e} from "
                              f"remat full's")
        fused = what == "fused_xent"
        if not fused and r["grad_err"] > GRAD_RTOL:
            faults.append(f"{what}: step 0 gradient rel err "
                          f"{r['grad_err']:.2e}")
        if "ef_max" in r:
            if r["ef_max"] > r["amax_g"] / 254 * (1 + GRAD_RTOL):
                faults.append(f"{what}: residual element {r['ef_max']:.3e}"
                              f" past half a step {r['amax_g'] / 254:.3e}")
            gap = abs(r["grad_norm"] - r["grad_norm_g"])
            if gap > r["ef_norm"] + GRAD_RTOL * r["grad_norm_g"]:
                faults.append(f"{what}: step 0 grad_norm {gap:.3e} from "
                              f"the gradient's, past the residual's norm "
                              f"{r['ef_norm']:.3e}")
        elif abs(r["grad_norm"] / base["grad_norm"] - 1) > (
                FUSED_NORM_RTOL if fused else GRAD_RTOL):
            faults.append(f"{what}: step 0 grad_norm {r['grad_norm']!r} "
                          f"against {base['grad_norm']!r}")
    return faults


def fused_xent_fp32(card):
    """Step 0's gradient of qwen3-1.7b at full width, TRAIN_VARIANT_LAYERS
    deep, in fp32 (remat full, B2 on the CUDA cores) at TRAIN_SHAPES[1],
    with the plain loss and with
    ``fused_xent``: exits unless every leaf is within FUSED_FP32_RTOL.
    In bf16 the two differ by more (7b (c)'s fused_xent row): the plain
    path rounds the logits to bf16, and the tied table's gradient sums
    thousands of bf16 terms in another order."""
    cfg = get_config(TRAIN_ARCH, attention_impl="pallas",
                     n_layers=TRAIN_VARIANT_LAYERS, param_dtype="float32",
                     compute_dtype="float32")
    model = LM(cfg)
    params = model.init_params(
        torch.Generator(device=model.device).manual_seed(0))
    batch = SyntheticLMStream(cfg, *TRAIN_SHAPES[1]).batch_for_step(0)
    (loss, _), plain = value_and_grad(make_loss_fn(model))(params, batch)
    plain = [g.cpu() for g in tree_leaves(plain)]
    (fused_loss, _), fused = value_and_grad(make_loss_fn(
        model, fused_xent=True))(params, batch)
    worst, at = _grad_rel_err(tree_leaves(fused), plain)
    del model, params, plain, fused
    torch.cuda.empty_cache()
    log("train-families", f"{TRAIN_ARCH} fp32 B1 S{TRAIN_SHAPES[1][1]} "
                          f"step 0: loss {float(loss)!r} plain, "
                          f"{float(fused_loss)!r} fused_xent; gradients "
                          f"worst leaf {at} rel err {worst:.3e} (bound "
                          f"{FUSED_FP32_RTOL}) | {card}")
    if worst > FUSED_FP32_RTOL:
        raise SystemExit(f"fused_xent's fp32 gradient leaf {at} {worst:.3e}"
                         f" from the plain loss's")


def phase_train_families(card, profile=False):
    """(a) full-width mamba2-780m through the launcher at TRAIN_SHAPES (B4
    in every layer's forward, twice a step under remat full; its gradient
    the plain scan's): 2 steps each, the first shape's ending in a
    checkpoint restored bitwise; (b) whisper-base whole at AUDIO_TRAIN
    over its 1500 frames through B2 (encoder and decoder, twice a step);
    (c) qwen3-1.7b at TRAIN_SHAPES[1] under each of TRAIN_VARIANTS, held
    together as ``_variant_faults`` says.  Returns the phase's B2
    and B4 launches."""
    t0 = datetime.datetime.now()
    reset_launches(("flash_attention", "ssd_scan"))
    cfg = get_config(SSM_ARCH)
    per_step = train_launches(cfg)["ssd_scan"]
    shutil.rmtree(TRAIN_SSM_CKPT, ignore_errors=True)
    for (B, S), ckpt in zip(TRAIN_SHAPES, (TRAIN_SSM_CKPT, None)):
        torch.cuda.reset_peak_memory_stats()
        what = f"{SSM_ARCH} bf16 B{B} S{S}"
        out, _ = _train_run(cfg, per_step, B, S, 2, ckpt, what, card,
                            kernel="ssd_scan", phase="train-families",
                            every=2)
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
        log("train-families", f"{what}: B4 launches {per_step} a step, peak "
                              f"{peak:.2f} GiB | {card}")
        if ckpt:
            _restored_bitwise(ckpt, 2, out["state"], "train-families", t0)
            shutil.rmtree(ckpt, ignore_errors=True)
        del out
        torch.cuda.empty_cache()
    cfg = get_config(AUDIO_ARCH, attention_impl="pallas")
    B, S = AUDIO_TRAIN
    torch.cuda.reset_peak_memory_stats()
    out, _ = _train_run(cfg, train_launches(cfg)["flash_attention"], B, S, 2,
                        None, f"{AUDIO_ARCH} bf16 B{B} S{S} over "
                        f"{cfg.n_audio_ctx} frames", card,
                        phase="train-families")
    log("train-families", f"{AUDIO_ARCH}: B2 launches "
                          f"{train_launches(cfg)['flash_attention']} a step "
                          f"(6 encoder + 6 decoder layers, twice), peak "
                          f"{torch.cuda.max_memory_allocated() / 2 ** 30:.2f}"
                          f" GiB | {card}")
    del out
    torch.cuda.empty_cache()
    got, ref = {}, None
    for what, cfg_kw, step_kw in TRAIN_VARIANTS:
        got[what] = train_variant(what, cfg_kw, step_kw, card, ref)
        if ref is None:
            ref = got[what].pop("ref_grads")
    del ref
    faults = _variant_faults(got)
    if faults:
        raise SystemExit("; ".join(faults))
    fused_xent_fp32(card)
    log("train-families", f"{TRAIN_ARCH} every option's step 0 and 2 losses "
                          f"(int8_ef: step 0's) within {TRAIN_LOSS_RTOL} of "
                          f"remat full's, step 0 gradients within "
                          f"{GRAD_RTOL} leaf by leaf (fused_xent: in fp32, "
                          f"{FUSED_FP32_RTOL}; int8_ef: its residual within "
                          f"half a step); phase wall {_since(t0):.1f} s | "
                          f"{card}")
    launches = {k: launches_of(k) for k in ("flash_attention", "ssd_scan")}
    if profile:
        for B, S in TRAIN_SHAPES:
            profile_train_step(get_config(SSM_ARCH), B, S, card)
    return launches


def _since(t0):
    return (datetime.datetime.now() - t0).total_seconds()


def profile_train_step(cfg, B, S, card):
    """Device-busy share of one full-width train step under
    torch.profiler, and the kernels that take most of its device time."""
    from torch.profiler import ProfilerActivity, profile
    model = LM(cfg)
    opt = AdamWConfig(lr=1e-4)
    state = init_train_state(
        model, torch.Generator(device=model.device).manual_seed(0), opt)
    batch = SyntheticLMStream(cfg, B, S).batch_for_step(0)
    step = make_train_step(model, opt)
    state, _ = step(state, batch)                      # warm-up
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        start.record()
        state, _ = step(state, batch)
        end.record()
        end.synchronize()
    wall = start.elapsed_time(end)
    kernels, ops = _kernel_rows(prof, 1)
    busy = sum(r[1] for r in kernels)
    log("profile", f"train step {cfg.arch_id} B{B} S{S}: {wall:.1f} ms "
                   f"between events, kernels busy {busy:.1f} ms "
                   f"({100 * busy / wall:.1f}%), {sum(r[2] for r in kernels)} "
                   f"kernel launches | {card}")
    # the plain backwards of B2 and B4: the device-side span of their
    # ranges (the annotation's device row: its kernels and the gaps
    # between them, which the profiler's host overhead widens)
    for name in (fa_ops.PROFILE_RANGE, ssd_ops.PROFILE_RANGE):
        rows = [e for e in prof.key_averages() if e.key == name]
        if rows:
            ms = max(_device_us(e) for e in rows) / 1e3
            n = max(e.count for e in rows)
            log("profile", f"  {name}: device-side span {ms:.1f} ms x{n}, "
                           f"{100 * ms / wall:.1f}% of the step"
                           if ms else f"  {name} x{n}: device time not "
                                      f"measured")
    for what, rows in (("kernel", kernels), ("op", ops)):
        for key, ms, n in sorted(rows, key=lambda r: -r[1])[:8]:
            log("profile", f"  {what} {ms:.3f} ms  x{n}  {key[:70]}")
    del state
    torch.cuda.empty_cache()


def _device_us(e):
    for attr in ("self_device_time_total", "self_cuda_time_total"):
        if hasattr(e, attr):
            return getattr(e, attr)
    raise AttributeError("profiler event has no device time field")


# ---------------------------------------------------------------------------
# phase 8: veceval, the proxy-app path
# ---------------------------------------------------------------------------
def phase_veceval(card, hw):
    """``veceval.run_all`` at the default and the card sizes, one app at a
    time: the versions of each app timed interleaved and held against
    each other (it raises past the app's tolerance), each app's kernel
    launched, and each version the dispatcher sees counted once, untimed
    (phase 10 (b) reads the default sizes' counts).  Returns the launches
    of each kernel over the whole path, and the default sizes' rows."""
    names = sorted(set(APP_KERNEL.values()))
    reset_launches(names)
    default_rows = []
    for label, sizes, max_iters in (("default", {}, None),
                                    ("card", CARD_SIZES, SCALAR_MAX_ITERS)):
        torch.cuda.reset_peak_memory_stats()
        for app_name in veceval.BUILDERS:
            before = launches_of(APP_KERNEL[app_name])
            got = veceval.run_all(
                measure=True, apps=[app_name], sizes=sizes, hw=hw,
                scalar_max_iters=max_iters)
            if label == "default":
                default_rows.extend(got)
            rows = {r["version"]: r for r in got}
            if launches_of(APP_KERNEL[app_name]) == before:
                raise SystemExit(f"veceval {app_name}: the kernel version "
                                 f"launched no {APP_KERNEL[app_name]} kernel")
            _log_app(label, app_name, rows, card)
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
        log("veceval", f"{label} sizes: peak {peak:.2f} GiB | {card}")
    launches = {name: launches_of(name) for name in names}
    launches["spmv_ell_onehot"] = spmv_onehot_path(card)
    return launches, default_rows


def spmv_onehot_path(card):
    """The one-hot idiom's path, the JAX package's own entry point
    ``kernels.spmv.ops.spmv_ell(idiom="onehot")`` (veceval's spmv app
    takes the gather, as the reference's does), at the JAX veceval size:
    one launch, held against the take idiom on the same matrix (1e-5 of
    the row's sum of |terms|).  Returns the launches."""
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(6)
    R = C = 1 << 14
    vals, cols, x = _ell(R, C, 16, g, dev)
    reset_launches(("spmv_ell_onehot",))
    y = spmv_ops.spmv_ell(vals, cols, x, idiom="onehot")
    launches = launches_of("spmv_ell_onehot")
    scale = (vals * x[cols]).abs().sum(-1, keepdim=True)
    err = check("spmv_ell(idiom='onehot') vs idiom='take'", y,
                spmv_ops.spmv_ell(vals, cols, x, idiom="take"), 1e-5, 0.0,
                scale)
    if launches != 1:
        raise SystemExit(f"spmv_ell(idiom='onehot'): {launches} launches")
    log("veceval", f"spmv_ell(idiom='onehot') at {R} x 16 against C {C}: "
                   f"one-hot kernel launches {launches}, max abs err vs the "
                   f"take idiom {err:.2e} | {card}")
    return launches


def _log_app(label, app_name, rows, card):
    secs = {v: r["host_seconds"] for v, r in rows.items()}
    bound = rows["kernel"]["bound_seconds"]
    parts = []
    for v, r in rows.items():
        if r["omitted"]:
            parts.append(f"{v}: omitted ({r['omitted']})")
            continue
        s = secs[v]
        extra = (f", x{secs['scalar'] / s:.1f} over scalar"
                 if secs.get("scalar") else "")
        if v == "autovec":
            extra += f", first call (torch.compile) " \
                     f"{r['first_call_seconds']:.2f} s"
        parts.append(f"{v} {s * 1e3:.4f} ms ({100 * bound / s:.1f}% of "
                     f"bound{extra}, err {r['max_abs_err_vs_autovec']:.1e})")
    log("veceval", f"{label} {app_name}: bound {bound * 1e3:.4f} ms "
                   f"({rows['kernel']['bound_by']}, {rows['kernel']['hw']}) | "
                   f"kernel/autovec speedup "
                   f"x{secs['autovec'] / secs['kernel']:.2f} | "
                   + " | ".join(parts) + f" | {card}")


# ---------------------------------------------------------------------------
# phase 9: the paper layer (Qsim, Fig 2, Fig 3, microbenchmarks)
# ---------------------------------------------------------------------------
def phase_paper(card, hw):
    """Fig 9 at the JAX size and at 28 qubits, then Fig 2 and Fig 3 at the
    JAX sizes and the card size, then the microbenchmark suite.  fig9's
    ``run`` raises unless its versions agree; here the gate kernel's
    launches must equal the uncontrolled gates times the calls of the
    kernel version, and the peak device memory of the 28-qubit run stays
    under PEAK_LIMIT_GIB.  Returns the launches of each kernel."""
    names = ("qsim_gate", "strided", "tailmask")
    reset_launches(names)
    for n_qubits, depth in QSIM_SIZES:
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        before = launches_of("qsim_gate")
        rows = {r["version"]: r for r in fig9_qsim.run(
            n_qubits=n_qubits, depth=depth, hw=hw)}
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
        kern = rows["kernel/planar"]
        want = kern["uncontrolled_gates"] * kern["calls"]
        got = launches_of("qsim_gate") - before
        if got != want:
            raise SystemExit(f"Qsim {n_qubits}q: gate kernel launched {got} "
                             f"times, expected {kern['uncontrolled_gates']} "
                             f"uncontrolled gates x {kern['calls']} calls")
        if peak >= PEAK_LIMIT_GIB:
            raise SystemExit(f"Qsim {n_qubits}q: peak {peak:.2f} GiB >= "
                             f"{PEAK_LIMIT_GIB} GiB")
        parts = []
        for v, r in rows.items():
            t = r["host_seconds"]
            extra = (f", first call {r['first_call_seconds']:.2f} s"
                     if v.startswith("autovec") else "")
            if r["fidelity_vs_kernel"] is not None:
                extra += f", fidelity {r['fidelity_vs_kernel']:.9f}"
            parts.append(f"{v} {t * 1e3:.4f} ms ({100 * r['bound_seconds'] / t:.1f}% "
                         f"of bound, x{r['speedup_vs_nonvec']:.1f} over "
                         f"nonvec{extra})")
        log("paper", f"fig9 Qsim {n_qubits}q depth {depth} ({kern['gates']} "
                     f"gates, {kern['uncontrolled_gates']} uncontrolled): "
                     f"bound {kern['bound_seconds'] * 1e3:.4f} ms "
                     f"({kern['bound_by']}, {kern['hw']}) | "
                     + " | ".join(parts)
                     + f" | nonvec: {rows['nonvec/planar']['note']} | norm "
                     f"{kern['norm']:.9f} | gate launches {got} = "
                     f"{kern['uncontrolled_gates']} x {kern['calls']} | "
                     f"peak {peak:.2f} GiB | {card}")
    for rows_n in (fig2_strided.ROWS, fig2_strided.CARD_ROWS):
        torch.cuda.empty_cache()
        for r in fig2_strided.run(rows=rows_n, hw=hw):
            got = (f"omitted ({r['omitted']})" if r["omitted"] else
                   f"{r['seconds'] * 1e3:.4f} ms, {r['gelem_per_s']:.2f} "
                   f"Gelem/s")
            log("paper", f"fig2 ({rows_n}, 128) stride {r['stride']} "
                         f"{r['idiom']}: {got} | bound "
                         f"{r['bound_seconds'] * 1e3:.4f} ms, "
                         f"{r['bound_gelem_per_s']:.2f} Gelem/s | {card}")
    for rows_n in (fig3_tail.ROWS, fig3_tail.CARD_ROWS):
        torch.cuda.empty_cache()
        for r in fig3_tail.run(rows=rows_n, hw=hw):
            log("paper", f"fig3 ({rows_n}, 128) frac {r['active_frac']}: "
                         f"exact {r['exact_seconds'] * 1e3:.4f} ms "
                         f"({r['exact_gelem_per_s']:.2f} Gelem/s, bound "
                         f"{r['bound_exact_gelem_per_s']:.2f}), masked "
                         f"{r['masked_seconds'] * 1e3:.4f} ms "
                         f"({r['masked_gelem_per_s']:.2f}, bound "
                         f"{r['bound_masked_gelem_per_s']:.2f}), penalty "
                         f"{100 * r['penalty']:.1f}% (bytes "
                         f"{100 * r['bytes_penalty']:.1f}%) | {card}")
    rows = microbench.run_suite(hw=hw)
    log("paper", "microbench: " + "; ".join(
        f"{r['name']} {r['dtype']} {r['host_gops']:.1f} of "
        f"{r['bound_gops']:.1f} Gops" for r in rows) + f" | {card}")
    require_launched(names, "paper path")
    return {name: launches_of(name) for name in names}


# ---------------------------------------------------------------------------
# phase 10: the paper's measurement layer
# ---------------------------------------------------------------------------
MEASURE_ARCH = "granite-3-2b"     # phase 6's engine shape (MIX), bf16
MEASURE_REQUESTS = 8
MEASURE_KERNELS = ("paged_partials", "gemm", "stream")


class _SplitSpy:
    """Stands in for the paged kernel's module in ``pa_ops``: counts each
    call of the binding by its ``splits`` argument, then calls it."""

    def __init__(self, counts):
        self.counts = counts

    def paged_flash_decode(self, *args, **kw):
        self.counts[kw.get("splits")] += 1
        return pa_kernel.paged_flash_decode(*args, **kw)


def measure_engines(card, excluded):
    """(d): the split sweep of granite-3-2b's pure decode through three
    engines on a fresh cache file: measured, then from the cache, then
    ``retune=True``; B1 at the chosen count, at the sweep's row lengths,
    against its plain version (a
    comparison launch, kept out of ``excluded``'s count); phase 6's mix
    (MEASURE_REQUESTS requests) on the second engine, the paged kernel 40
    launches a forward, every pure-decode launch at the tuned count."""
    phase = "measure"
    cfg = get_config(MEASURE_ARCH)
    model = LM(cfg)
    params = model.init_params(
        torch.Generator(device=model.device).manual_seed(0))
    saved = autotune.AUTOTUNE_CACHE_PATH
    os.makedirs(os.path.join(ROOT, "build"), exist_ok=True)
    tmp = tempfile.mkdtemp(prefix="autotune-", dir=os.path.join(ROOT,
                                                                "build"))
    autotune.AUTOTUNE_CACHE_PATH = pathlib.Path(tmp) / "cache.json"
    try:
        engines = [ContinuousBatchingEngine(model, params, **MIX)
                   for _ in range(2)]
        engines.append(ContinuousBatchingEngine(model, params, retune=True,
                                                **MIX))
    finally:
        autotune.AUTOTUNE_CACHE_PATH = saved
        shutil.rmtree(tmp, ignore_errors=True)
    metas = [e.paged_meta for e in engines]
    sources = [m.get("source") for m in metas]
    for i, m in enumerate(metas):
        log(phase, f"(d) engine {i + 1}: paged_meta source {m['source']}, "
                   f"key {m['key']}, rows at kv {m['kv_valid']}, "
                   f"{m['reps']} rounds | median (interquartile range) "
                   f"us " + ", ".join(
                       f"{k} {v * 1e6:.2f} ({m['spread_s'][k] * 1e6:.2f})"
                       for k, v in sorted(m["medians_s"].items(),
                                          key=lambda kv: int(kv[0][1:])))
                   + f" | fastest {m['best']}, served at {m['splits']} "
                     f"splits, split_plan's {m['plan_splits']}: "
                     f"{m['why']} | {card}")
    if sources != ["measured", "cache", "measured"]:
        raise SystemExit(f"(d) paged_meta sources {sources}, expected "
                         f"measured, cache, measured")
    tuned = metas[1]["splits"]
    # B1 at the tuned count against its plain version, at the tuned shape
    before = launches_of("paged_partials")
    c = make_case(B=MIX["n_slots"], NKV=cfg.n_kv_heads,
                  G=cfg.n_heads // cfg.n_kv_heads, H=cfg.resolved_head_dim,
                  page=MIX["page_size"], max_len=MIX["max_len"], sq=1,
                  valid=metas[1]["kv_valid"], permuted=False,
                  seed=3, dev=model.device)
    args = (c["qg"], c["kp"], c["vp"], c["page_idx"], c["pos0"],
            c["kv_valid"])
    got = pa_kernel.paged_flash_decode(*args, sq=1, splits=tuned)
    want = pa_ref.paged_partials(*args, sq=1)
    out_k = got[0] / got[2].clamp_min(1e-30)[..., None]
    out_p = want[0] / want[2].clamp_min(1e-30)[..., None]
    err = check(f"B1 at the tuned {tuned} splits", out_k, out_p, TOL, TOL)
    excluded["paged_partials"] = (excluded.get("paged_partials", 0)
                                  + launches_of("paged_partials") - before)
    # phase 6's mix on the second engine, every launch's split recorded
    eng = engines[1]
    rng = np.random.default_rng(0)
    prompts = [rng.integers(1, cfg.vocab_size, size=int(n))
               for n in rng.integers(32, 257, size=MEASURE_REQUESTS)]
    rids = [eng.submit(p, MIX_NEW) for p in prompts]
    by_splits = collections.Counter()
    pa_ops.K = _SplitSpy(by_splits)
    before = launches_of("paged_partials")
    try:
        out = eng.run()
    finally:
        pa_ops.K = pa_kernel
    got_launches = launches_of("paged_partials") - before
    st = eng.stats.summary()
    fwd = st["forwards"]
    decode_fwds = sum(1 for s_ in eng.stats.steps if s_.n_decode)
    if sorted(out) != sorted(rids):
        raise SystemExit("(d) not every request finished")
    _check_tokens(f"{MEASURE_ARCH} tuned", out, MIX_NEW, cfg.padded_vocab)
    if got_launches != attn_layers(cfg) * fwd:
        raise SystemExit(f"(d) paged kernel {got_launches} launches, "
                         f"expected {attn_layers(cfg)} x {fwd} forwards")
    if by_splits[tuned] != attn_layers(cfg) * decode_fwds:
        raise SystemExit(f"(d) launches by splits {dict(by_splits)}: "
                         f"not {attn_layers(cfg)} x {decode_fwds} decode "
                         f"forwards at the tuned {tuned}")
    log(phase, f"(d) B1 at the tuned {tuned} splits vs plain: max abs err "
               f"{err:.2e} | {MEASURE_REQUESTS} requests at phase 6's mix: "
               f"{st['generated_tokens']} tokens, {fwd} forwards "
               f"({decode_fwds} with decode rows), paged kernel "
               f"{got_launches} = {attn_layers(cfg)} x {fwd}; calls by "
               f"splits {dict(by_splits)} | step p50 "
               f"{st['step_ms_p50']:.3f} ms, {st['tok_per_s']:.1f} tok/s | "
               f"{card}")
    del engines, eng, model, params
    torch.cuda.empty_cache()
    return metas


def _table1_line(r):
    got = ("absent" if r["measured"] is None else
           f"{r['measured']:.6g} (error {r['error']:.3g})")
    return (f"{r['channel']:20s} {r['program']:28s} reference "
            f"{r['reference']:.6g} measured {got} "
            f"{'reliable' if r['reliable'] else 'UNRELIABLE'}")


def phase_measure(card, hw, table1_proc, veceval_rows):
    """(a) Table 1 on the card, run in a fresh process started with the
    script (``table1_proc``), with its kernel_launches channel; the same
    channel read in this long process, reported only; (b) Fig 6 from
    phase 8's rows at the JAX sizes (their untimed counted run); (c) Fig
    7 (a)/(b) and Fig 8 measured, the model's spill flags against
    cuobjdump; (d) ``measure_engines``; (e) the four examples at reduced
    configs.  Returns the launches of MEASURE_KERNELS on the path (B6
    and B9 in the sweeps of (c) and the autotune demo, B1 in the split
    sweeps and the served forwards of (d) and (e))."""
    phase = "measure"
    reset_launches(MEASURE_KERNELS)
    excluded = {}
    t0 = datetime.datetime.now()
    rows = table1_counters.collect(table1_proc)
    for r in rows:
        log(phase, f"(a) table1 {_table1_line(r)}")
    verdicts = table1_counters.verdicts(rows)
    bad = [r for r in rows if r["reference"] is None
           or not isinstance(r["reliable"], bool)]
    launch = [r for r in rows if r["channel"] == "kernel_launches"]
    if (bad or len(launch) != 1
            or launch[0]["measured"] != launch[0]["reference"]
            or not verdicts["kernel_launches"]):
        raise SystemExit(f"(a) Table 1: records without a reference or a "
                         f"verdict {bad}, or kernel_launches not exact in "
                         f"a fresh process: {launch}")
    log(phase, "(a) verdicts in a fresh process " + ", ".join(
        f"{ch} {'reliable' if ok else 'UNRELIABLE'}"
        for ch, ok in verdicts.items()) + f" | {card}")
    late = [r for r in table1_counters.run("cuda")
            if r["channel"] == "kernel_launches"]
    log(phase, f"(a) in this process, after phases 1-9 (reported only): "
               f"{_table1_line(late[0])} | {_since(t0):.1f} s | {card}")
    t0 = datetime.datetime.now()
    rows6 = fig6_breakdown.view(veceval_rows, veceval.channel_verdicts())
    for r in rows6:
        seen = r["version"] == "scalar"
        if (seen and (r["ops_source"] != "dispatch" or not r["total_ops"])
                or not seen and (r["total_ops"] is not None
                                 or not r["ops_note"])):
            raise SystemExit(f"(b) fig6 {r['app']} {r['version']}: "
                             f"{r['total_ops']} ops ({r['ops_source']}, "
                             f"{r['ops_note']})")
        counted = (" ".join(f"{k} {r[k]}" for k in fig6_breakdown.CLASSES)
                   if r["total_ops"] is not None else r["ops_note"])
        log(phase, f"(b) fig6 {r['app']:8s} {r['version']:8s} "
                   f"{r['total_ops']} ops ({r['ops_source']}): {counted}")
    if len(rows6) != len(veceval.BUILDERS) * len(veceval.VERSIONS):
        raise SystemExit(f"(b) fig6: {len(rows6)} rows")
    log(phase, f"(b) from phase 8's rows, {_since(t0):.1f} s | {card}")
    t0 = datetime.datetime.now()
    rows7 = fig7_lmul.run("cuda", hw=hw)
    for r in rows7:
        if r["section"] == "a":
            log(phase, f"(c) fig7a {r['kernel']} m{r['multiplier']}: smem "
                       f"{r['smem_kb']:.1f} KiB, regs "
                       f"{r['regs_per_thread']}, {r['blocks_per_sm']} a "
                       f"SM, {r['waves']} waves, model "
                       f"{r['predicted_ms']:.4f} ms {r['bound']}"
                       f"{' <- pick' if r['selected'] else ''}")
        elif r["section"] == "b":
            log(phase, f"(c) fig7b {r['kernel']} {r['knob']} {r['value']}: "
                       f"{r['measured_ms']:.4f} ms (bound "
                       f"{r['bound_ms']:.4f}, {r['bound_by']}) | model "
                       f"pick {r['model_pick']}, measured best "
                       f"{r['measured_best']}, pick / best "
                       f"{r['pick_over_best']} | {card}")
        else:
            log(phase, f"(c) res-usage {r['kernel']} m{r['multiplier']}: "
                       f"REG {r['regs']} STACK {r['stack']} LOCAL "
                       f"{r['local']} spill {r['spill']} | model spill "
                       f"{r['model_spill']}"
                       f"{'' if r['agree'] else ' | DISAGREE'}")
    for r in fig8_pressure.run("cuda", hw=hw):
        log(phase, f"(c) fig8 triad 2^26 m{r['multiplier']}: "
                   f"{r['grid_blocks']} blocks (x{r['block_reduction']:.0f} "
                   f"fewer), {r['waves']} waves | model "
                   f"{r['predicted_ms']:.4f} ms x"
                   f"{r['predicted_speedup']:.3f} | measured "
                   f"{r['measured_ms']:.4f} ms x{r['measured_speedup']:.3f} "
                   f"| bound {r['bound_ms']:.4f} ms | {card}")
    log(phase, f"(c) {_since(t0):.1f} s")
    t0 = datetime.datetime.now()
    measure_engines(card, excluded)
    log(phase, f"(d) {_since(t0):.1f} s")
    t0 = datetime.datetime.now()
    ex_quick = ex_quickstart.main(["--arch", "granite-3-2b"])
    if not ex_quick["losses"] or not all(np.isfinite(ex_quick["losses"])):
        raise SystemExit(f"(e) quickstart: losses {ex_quick['losses']}")
    ex_serve = ex_serve_decode.main([])
    ex_tune = ex_autotune_demo.main(["--size", "2048"])
    ex_qsim = ex_qsim_demo.main([])
    log(phase, f"(e) examples on the card: quickstart losses "
               f"{ex_quick['losses']}, paged_meta source "
               f"{ex_quick['paged_meta'].get('source')}; serve_decode "
               f"{len(ex_serve['results'])} requests; autotune_demo pick "
               f"m{ex_tune['best']}, max abs err "
               f"{ex_tune['max_abs_err']:.2e}; qsim_demo fidelity "
               + ", ".join(f"{k} {v['fidelity']:.9f}"
                           for k, v in ex_qsim.items())
               + f" | {_since(t0):.1f} s | {card}")
    return {n: launches_of(n) - excluded.get(n, 0) for n in MEASURE_KERNELS}


# ---------------------------------------------------------------------------
def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--profile", action="store_true",
                    help="also profile pure decode forwards (granite bf16 "
                         "and int8, mamba2, qwen3 dense-cache, phi3.5-moe, "
                         "jamba and llama-3.2-vision int8, whisper-base) "
                         "and train steps (qwen3-1.7b, mamba2-780m)")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs on the card",
              file=sys.stderr)
        return 1
    t_start = datetime.datetime.now()
    # Table 1 in a fresh process while this one builds the kernels: the
    # card's kernel records are whole only early in a process
    table1_proc = table1_counters.spawn("cuda")
    try:
        return run_phases(args, t_start, table1_proc)
    finally:
        if table1_proc.poll() is None:
            table1_proc.kill()
            table1_proc.communicate()


def run_phases(args, t_start, table1_proc):
    """Every phase in order; then the kernel record and the last line."""
    def done(what):
        log("wall", f"{what} done, {_since(t_start):.1f} s since the start")

    card = phase_device()
    phase_build()
    phase_sass()
    done("1-2 device, build, sass")
    hw = hw_for(card)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    log("kernel", f"bound rates: {hw.name} {hw.hbm_bw / 1e12:.2f} TB/s, "
                  f"{hw.peak_flops_bf16 / 1e12:.0f} TFLOP/s bf16, "
                  f"{hw.peak_flops_fp32 / 1e12:.0f} fp32, "
                  f"{hw.peak_flops_fp64 / 1e12:.0f} fp64 dense | TF32 "
                  f"matmul {torch.backends.cuda.matmul.allow_tf32}, cudnn "
                  f"{torch.backends.cudnn.allow_tf32}")
    worst, main_case = phase_kernel(card, hw)
    done("3 kernel")
    records = phase_kernels_veceval(card, hw)
    records.update(phase_kernels_paper(card, hw))
    records.update(phase_kernels_train(card, hw))
    records.update(phase_kernels_ssm(card, hw))
    records.update(phase_kernels_int8(card, hw))
    records.update(phase_kernels_serve_dense(card, hw))
    records["paged_partials"] = dict(max_abs_err=worst, **main_case)
    done("4 kernels")
    phase_parity()
    done("5 parity")
    launches = {"paged_partials": phase_serve(card, args.profile)}
    done("6 serve")
    launches["ssd_scan"] = phase_serve_ssm(card, args.profile)
    done("6b serve-ssm")
    launches["wq_gemm"] = phase_serve_int8(card, args.profile)
    done("6c serve-int8")
    launches["flash_decode"] = phase_serve_dense(card, args.profile)
    done("6d serve-dense")
    for what, serve in (
            ("6e serve-moe", lambda: phase_serve_moe(card, args.profile)),
            ("6f serve-grok", lambda: phase_serve_grok(card)),
            ("6g serve-phi3m", lambda: phase_serve_phi3m(card)),
            ("6h serve-hybrid",
             lambda: phase_serve_hybrid(card, args.profile)),
            ("6i serve-vlm", lambda: phase_serve_vlm(card, args.profile)),
            ("6j serve-audio", lambda: phase_serve_audio(card, args.profile)),
            ("6k serve-features", lambda: phase_serve_features(card)),
            ("6l serve-open-loop", lambda: phase_serve_open_loop(card)),
            ("6m serve-mesh", lambda: phase_serve_mesh(card, hw))):
        _add(launches, serve())
        done(what)
    launches["flash_attention"] = phase_train(card, args.profile)
    done("7 train")
    _add(launches, phase_train_families(card, args.profile))
    done("7b train-families")
    veceval_launches, veceval_rows = phase_veceval(card, hw)
    launches.update(veceval_launches)
    done("8 veceval")
    launches.update(phase_paper(card, hw))
    done("9 paper")
    _add(launches, phase_measure(card, hw, table1_proc, veceval_rows))
    done("10 measure")
    record = {"kernels": [dict(
        name=name, route="cuda",
        source=os.path.relpath(source, ROOT), replaces=replaces,
        launches=launches[name], **records[name])
        for name, (_, source, _, replaces) in KERNELS.items()]}
    print(json.dumps(record))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
