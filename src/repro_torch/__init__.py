"""PyTorch port of the ``repro`` serving stack for NVIDIA Hopper (sm_90a).

A package beside ``src/repro/`` (the JAX reference, which stays as it
is): module names follow the JAX package so each file's counterpart is
easy to find.  It imports ``torch`` and numpy only — never ``jax`` and
nothing of ``repro``; what it needs from a ``repro`` module it keeps a
copy of.

Covered so far: the dense family (``granite-3-2b``, ``qwen3-1.7b``)
served by ``serve.engine.ContinuousBatchingEngine``, with paged
attention in a hand-written CUDA kernel
(``kernels/paged_attention/csrc/paged_attention.cu``); and the paper's
proxy-app harness ``core.veceval`` with its STREAM, ELL SpMV, GEMM and
conv2d kernels (``kernels/{stream,spmv,gemm,conv2d}/csrc``), timed by
``perf.measure`` against the ceilings in ``core.costmodel``; and the
paper layer: the Qsim simulator ``quantum.qsim`` with its planar gate
kernel (``kernels/qsim_gate``), the microbenchmark suite
``core.microbench`` with the Fig 2 strided-gather and Fig 3 tail-mask
kernels (``kernels/{strided,tailmask}``), and the drivers of Figs 2, 3
and 9 in ``figures``; and the train stack (``train``, ``optim``,
``data``, ``checkpoint``, ``launch.train``) with the flash-attention
forward in a hand-written CUDA kernel (``kernels/flash_attention``);
and the ssm family (``mamba2-780m``) with its SSD scan kernel
(``kernels/ssd_scan``); and weight-only int8 serving (``models.quant``)
whose every q-pack matmul runs the int8 GEMM kernel
(``kernels/wq_gemm``).  Entry points run on ``cuda`` unless the caller
passes ``device="cpu"``; on the CPU every kernel wrapper runs its plain
PyTorch version.
"""
