"""Serving: paged continuous batching over the port's LM.

``cache.py``, ``scheduler.py`` and ``draft.py`` (the n-gram drafter of
speculative decoding) are verbatim copies of the reference's host-only
numpy modules (only their import path differs); ``sampling.py`` and
``engine.py`` are rewritten for PyTorch.  The engine has the reference's
API (``submit``, ``step``, ``run``, ``results``, ``generate``, ``reset``,
``requests``, the ``last_*`` step records, ``check_findings``) and its
serving features: ``check=`` (the shadow-state checker of
``repro_torch.analysis``), ``prefix_cache=`` / ``prefix_pool=`` and
``spec_decode=`` / ``spec_k=``.  Not ported yet: the device mesh and the
sequence-parallel KV cache (``mesh``, ``rules``, ``sp_kv``), the
stall-free chunk policy (``chunk_policy``, ``tbt_target_s``), ``analyze``,
``retune``, ``StepCostModel`` and ``modeled_step_time``, and the
open-loop front end (``arrivals``, ``slo``, ``frontend``).
"""
