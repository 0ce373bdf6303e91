"""The serve shadow-state checker's rule table.

A copy of ``Rule`` (defined in the reference's ``analysis/lint.py``) and
``SCHED_RULES`` (``analysis/registry.py``); the other layers' tables
stay with the reference.  Stdlib only.
"""
from __future__ import annotations

import dataclasses
from typing import Dict


@dataclasses.dataclass(frozen=True)
class Rule:
    rule: str
    severity: str
    description: str


#: serve shadow-state transition rules — ``schedcheck``
SCHED_RULES: Dict[str, Rule] = {r.rule: r for r in (
    Rule("refcount-conservation", "error",
         "page refcounts != slot/prefix owner count (sum over shard)"),
    Rule("double-free", "error",
         "page freed below zero shadow references"),
    Rule("page-leak", "error",
         "allocated pages with no owner survive a drain"),
    Rule("slot-double-bind", "error",
         "one slot bound to two rids (or one rid to two slots)"),
    Rule("prefix-double-claim", "error",
         "a prefix-pool page claimed twice by one entry/slot"),
    Rule("illegal-admission", "error",
         "admission into an occupied/excluded/foreign-shard slot"),
    Rule("illegal-preemption", "error",
         "preemption victim older than the stalled request or off-shard"),
)}
