"""Serving: paged continuous batching over the port's LM, and the
open-loop front end over it.

``cache.py``, ``scheduler.py`` and ``draft.py`` (the n-gram drafter of
speculative decoding) are verbatim copies of the reference's host-only
numpy modules (only their import path differs), and so are
``arrivals.py`` (the seeded Poisson, gamma, closed-loop and trace
arrival processes; traces keep the ``repro.serve.trace`` schema, so a
trace passes between the two packages) and ``slo.py`` (``SLO``,
``RequestEvents``, ``latency_summary``); ``sampling.py``, ``engine.py``
and ``frontend.py`` are rewritten for PyTorch.  The engine has the
reference's API (``submit``, ``step``, ``run``, ``results``,
``generate``, ``reset``, ``requests``, the ``last_*`` step records,
``check_findings``, ``modeled_step_time``) and its serving features:
``check=`` (the shadow-state checker of ``repro_torch.analysis``),
``prefix_cache=`` / ``prefix_pool=``, ``spec_decode=`` / ``spec_k=`` and
the stall-free chunk policy (``chunk_policy=`` / ``tbt_target_s=``);
``EngineStats`` carries the modeled flops and bytes of
``StepCostModel``.  ``OpenLoopFrontend`` puts requests on a clock:
``clock="wall"`` measures each step between CUDA events on the card,
``clock="model"`` advances by the cost model's step times.  ``retune=``
re-measures the paged kernel's split sweep (``core.autotune``), which
every engine on the card tunes at construction (``paged_meta``).  Not
ported yet: the device mesh and the sequence-parallel KV cache
(``mesh``, ``rules``, ``sp_kv``) and ``analyze``.
"""
from repro_torch.serve.arrivals import (  # noqa: F401
    ArrivalRequest,
    closed_loop_arrivals,
    gamma_arrivals,
    poisson_arrivals,
    save_trace,
    synthetic_requests,
    trace_arrivals,
    trace_payload,
)
from repro_torch.serve.cache import (  # noqa: F401
    PagedKVCache,
    PageTable,
    PrefixEntry,
    context_key,
)
from repro_torch.serve.draft import NGramDrafter  # noqa: F401
from repro_torch.serve.engine import (  # noqa: F401
    ContinuousBatchingEngine,
    EngineStats,
    StaticBatchEngine,
    StepCostModel,
    make_prefill_step,
    make_serve_step,
)
from repro_torch.serve.frontend import (  # noqa: F401
    OpenLoopFrontend,
    OpenLoopResult,
)
from repro_torch.serve.sampling import sample_tokens  # noqa: F401
from repro_torch.serve.scheduler import (  # noqa: F401
    CHUNK_POLICIES,
    Request,
    RequestState,
    Scheduler,
    StepPlan,
)
from repro_torch.serve.slo import (  # noqa: F401
    SLO,
    RequestEvents,
    latency_summary,
    queue_depth_stats,
)
