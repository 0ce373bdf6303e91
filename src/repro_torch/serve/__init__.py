"""Serving: paged continuous batching over the port's LM.

``cache.py`` and ``scheduler.py`` are verbatim copies of the reference's
host-only numpy modules (only their import path differs);
``sampling.py`` and ``engine.py`` are rewritten for PyTorch.
"""
