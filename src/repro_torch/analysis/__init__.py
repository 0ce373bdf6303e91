"""The serve shadow-state checker, copied from ``repro.analysis``.

``findings.py`` holds a copy of ``Finding`` and ``SEVERITIES``
(``repro/analysis/findings.py``), ``registry.py`` a copy of ``Rule`` and
``SCHED_RULES`` (``repro/analysis/registry.py``), and ``schedcheck.py``
a copy of ``SchedChecker`` (``repro/analysis/schedcheck.py``) whose only
change is its two import lines.  The rest of the reference's analysis
layers (the source lint, the trace lint, the fingerprints, the waivers
file) stays with the reference: the checker needs none of it.  A CPU
test holds each copy against its original.
"""
