"""``Finding``: one rule hit — rule id, severity, location, a one-line
explanation and optional machine-readable context.

A copy of ``Finding`` and ``SEVERITIES`` from the reference's
``analysis/findings.py``; the waiver machinery stays there (the waivers
file belongs to the reference).  Stdlib only.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional

SEVERITIES = ("error", "warning", "info")


@dataclasses.dataclass(frozen=True)
class Finding:
    """One rule hit, from either analysis layer."""

    rule: str
    severity: str            # "error" | "warning" | "info"
    path: str                # repo-relative source path or "<trace:label>"
    line: int                # 1-based source line; 0 for trace findings
    message: str
    context: Optional[Dict[str, Any]] = None

    def format(self) -> str:
        loc = f"{self.path}:{self.line}" if self.line else self.path
        return f"{loc} [{self.severity}] {self.rule}: {self.message}"

    def row(self) -> Dict[str, Any]:
        out = {"rule": self.rule, "severity": self.severity,
               "path": self.path, "line": self.line,
               "message": self.message}
        if self.context:
            out["context"] = dict(self.context)
        return out
