"""The benchmark Report schema: a copy of ``repro.perf.report``.

Every benchmark artifact of the port is one serialized :class:`Report`,
in the reference's schema (``SCHEMA``, ``SCHEMA_VERSION``, the keys that
``validate`` checks), so one validator reads both packages' artifacts:
benchmark name, rows, optional channel summary, the reliability
verdicts the rows were read under, the hardware ceiling the model
columns refer to, and environment metadata.  ``validate`` and
``validate_path`` are the reference's, verbatim; the open-loop front
end's ``latency`` block (``serve.slo.latency_summary``) passes them.

What differs is what describes the machine: ``hw_meta`` describes the
card's ``HWSpec`` (``core.costmodel``), ``environment_meta`` names torch,
the CUDA runtime, the device and, on the card, its power limit
(nvidia-smi), where the reference names jax; and ``created_unix`` is the
file system's modification time of a new temporary file, as the
checkpointer stamps its manifests, since nothing of the port reads the
host's clock.
"""
from __future__ import annotations

import dataclasses
import json
import os
import pathlib
import platform
import subprocess
import tempfile
from typing import Any, Dict, List, Optional

import torch

from repro_torch.core.costmodel import H100_SXM, HWSpec

SCHEMA = "repro.perf.report"
SCHEMA_VERSION = 1


def created_unix() -> float:
    """Seconds since the epoch, from the modification time the file
    system gives a new temporary file."""
    with tempfile.TemporaryFile() as f:
        return os.fstat(f.fileno()).st_mtime


def _power_limit() -> Optional[str]:
    """The card's power limit as nvidia-smi reports it (None off the
    card)."""
    if not torch.cuda.is_available():
        return None
    smi = subprocess.run(["nvidia-smi", "--query-gpu=power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True)
    return smi.stdout.strip().splitlines()[0]


def environment_meta() -> Dict[str, Any]:
    on_card = torch.cuda.is_available()
    return {
        "torch_version": torch.__version__,
        "cuda_runtime": torch.version.cuda,
        "backend": "cuda" if on_card else "cpu",
        "device_kind": (torch.cuda.get_device_name(0) if on_card
                        else "cpu"),
        "power_limit": _power_limit(),
        "python": platform.python_version(),
        "platform": platform.platform(),
    }


def hw_meta(hw: HWSpec = H100_SXM) -> Dict[str, Any]:
    return dataclasses.asdict(hw)


def roofline_fraction(flops: float, hbm_bytes: float, wall_s: float,
                      hw: HWSpec = H100_SXM) -> float:
    """Fraction of the modeled roofline a measured run achieved.

    ``max(flops/peak, bytes/bw)`` (bf16 peak) is the modeled bound time
    for the work; dividing by the measured time gives how close to the
    modeled ceiling the run came (1.0 = at the roofline).
    """
    if wall_s <= 0:
        return 0.0
    t_bound = max(flops / hw.peak_flops_bf16, hbm_bytes / hw.hbm_bw)
    return t_bound / wall_s


@dataclasses.dataclass
class Report:
    benchmark: str
    rows: List[Dict[str, Any]]
    meta: Dict[str, Any] = dataclasses.field(default_factory=dict)
    reliability: Dict[str, bool] = dataclasses.field(default_factory=dict)
    channels: Optional[Dict[str, Any]] = None
    hw: Dict[str, Any] = dataclasses.field(default_factory=hw_meta)
    environment: Dict[str, Any] = dataclasses.field(
        default_factory=environment_meta)
    created_unix: float = dataclasses.field(default_factory=created_unix)

    def to_payload(self) -> Dict[str, Any]:
        return {
            "schema": SCHEMA,
            "schema_version": SCHEMA_VERSION,
            "benchmark": self.benchmark,
            "created_unix": self.created_unix,
            "environment": self.environment,
            "hw": self.hw,
            "meta": self.meta,
            "reliability": self.reliability,
            "channels": self.channels,
            "rows": self.rows,
        }

    def to_json(self) -> str:
        return json.dumps(self.to_payload(), indent=2, default=str)

    @classmethod
    def from_payload(cls, payload: Dict[str, Any]) -> "Report":
        errors = validate(payload)
        if errors:
            raise ValueError(f"invalid Report payload: {errors}")
        return cls(benchmark=payload["benchmark"], rows=payload["rows"],
                   meta=payload["meta"], reliability=payload["reliability"],
                   channels=payload.get("channels"), hw=payload["hw"],
                   environment=payload["environment"],
                   created_unix=payload["created_unix"])


def make_report(benchmark: str, rows: List[Dict[str, Any]], *,
                meta: Optional[Dict[str, Any]] = None,
                reliability: Optional[Dict[str, bool]] = None,
                channels: Optional[Dict[str, Any]] = None,
                hw: HWSpec = H100_SXM) -> Report:
    return Report(benchmark=benchmark, rows=list(rows), meta=dict(meta or {}),
                  reliability=dict(reliability or {}), channels=channels,
                  hw=hw_meta(hw))


_REQUIRED = {
    "schema": str,
    "schema_version": int,
    "benchmark": str,
    "created_unix": (int, float),
    "environment": dict,
    "hw": dict,
    "meta": dict,
    "reliability": dict,
    "rows": list,
}
_HW_KEYS = ("name", "peak_flops_bf16", "hbm_bw")

# open-loop serving rows (serve_bench --open-loop) carry a "latency"
# block produced by repro.serve.slo.latency_summary; when present it
# must be the full telemetry surface, not a partial dict
_LATENCY_KEYS = ("requests", "completed", "goodput_tok_s", "makespan_s",
                 "queue_depth")
_LATENCY_DISTS = ("ttft_s", "tbt_s", "e2e_s", "queue_wait_s")
_DIST_KEYS = ("p50", "p90", "p99", "mean", "max", "n")
_SLO_KEYS = ("ttft_s", "tbt_s", "attainment", "good_requests")

# serve_bench meta carries the trace-lint analysis block per traced
# engine (``engine.analysis_meta``); each program record must carry the
# canonical compile-drift fingerprint (``repro.analysis.fingerprint``)
# so the artifact pins program *shape* next to the measured numbers —
# the same dict ``python -m repro.analysis --diff`` gates on
_FINGERPRINT_KEYS = ("version", "label", "op_histogram", "total_ops",
                     "gather_ops", "while_bodies", "input_dtypes",
                     "donated", "alias_pairs", "counters", "finding_rules")


def _validate_latency(lat: Any, where: str, errors: List[str]) -> None:
    if not isinstance(lat, dict):
        errors.append(f"{where} is {type(lat).__name__}, expected object")
        return
    for key in _LATENCY_KEYS:
        if key not in lat:
            errors.append(f"{where} missing key {key!r}")
    for dist in _LATENCY_DISTS:
        blk = lat.get(dist)
        if not isinstance(blk, dict):
            errors.append(f"{where}[{dist!r}] missing or not an object")
            continue
        for key in _DIST_KEYS:
            if not isinstance(blk.get(key), (int, float)):
                errors.append(
                    f"{where}[{dist!r}][{key!r}] missing or non-numeric")
    slo = lat.get("slo")
    if slo is not None:
        if not isinstance(slo, dict):
            errors.append(f"{where}['slo'] is not an object")
        else:
            for key in _SLO_KEYS:
                if not isinstance(slo.get(key), (int, float)):
                    errors.append(
                        f"{where}['slo'][{key!r}] missing or non-numeric")


def _validate_analysis(block: Any, where: str, errors: List[str]) -> None:
    """An analysis block's traced programs must each carry a complete
    fingerprint dict (missing keys mean the artifact cannot back the
    compile-drift gate)."""
    if not isinstance(block, dict):
        return
    programs = block.get("programs")
    if not isinstance(programs, dict):
        return
    for label, prog in programs.items():
        loc = f"{where}['programs'][{label!r}]"
        if not isinstance(prog, dict):
            errors.append(f"{loc} is not an object")
            continue
        fp = prog.get("fingerprint")
        if not isinstance(fp, dict):
            errors.append(f"{loc} missing its 'fingerprint' block")
            continue
        for key in _FINGERPRINT_KEYS:
            if key not in fp:
                errors.append(f"{loc}['fingerprint'] missing key {key!r}")
        cnt = fp.get("counters")
        if not isinstance(cnt, dict) or "verdict" not in cnt:
            errors.append(
                f"{loc}['fingerprint']['counters'] missing 'verdict'")


def validate(payload: Any) -> List[str]:
    """Schema check; returns a list of error strings (empty = valid)."""
    errors: List[str] = []
    if not isinstance(payload, dict):
        return [f"payload is {type(payload).__name__}, expected object"]
    for key, typ in _REQUIRED.items():
        if key not in payload:
            errors.append(f"missing required key {key!r}")
        elif not isinstance(payload[key], typ):
            errors.append(
                f"key {key!r} is {type(payload[key]).__name__}, "
                f"expected {typ}")
    if errors:
        return errors
    if payload["schema"] != SCHEMA:
        errors.append(f"schema is {payload['schema']!r}, expected {SCHEMA!r}")
    if payload["schema_version"] > SCHEMA_VERSION:
        errors.append(
            f"schema_version {payload['schema_version']} is newer than "
            f"this reader ({SCHEMA_VERSION})")
    for i, row in enumerate(payload["rows"]):
        if not isinstance(row, dict):
            errors.append(f"rows[{i}] is {type(row).__name__}, "
                          "expected object")
        elif "latency" in row:
            _validate_latency(row["latency"], f"rows[{i}]['latency']",
                              errors)
    meta = payload["meta"]
    _validate_analysis(meta.get("analysis"), "meta['analysis']", errors)
    paged = meta.get("paged")
    if isinstance(paged, dict) and isinstance(paged.get("engines"), dict):
        for name, blk in paged["engines"].items():
            _validate_analysis(
                blk, f"meta['paged']['engines'][{name!r}]", errors)
    for ch, verdict in payload["reliability"].items():
        if not isinstance(verdict, bool):
            errors.append(f"reliability[{ch!r}] is not a bool")
    for key in _HW_KEYS:
        if key not in payload["hw"]:
            errors.append(f"hw missing key {key!r}")
    ch = payload.get("channels")
    if ch is not None and not isinstance(ch, dict):
        errors.append(f"channels is {type(ch).__name__}, expected object")
    return errors


def validate_path(path: pathlib.Path) -> List[str]:
    try:
        payload = json.loads(path.read_text())
    except (OSError, json.JSONDecodeError) as e:
        return [f"unreadable JSON: {e}"]
    return validate(payload)
