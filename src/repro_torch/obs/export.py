"""Trace and metrics serialization.

Own copy of ``repro/obs/export.py``.

Two output formats, each with a validator the tests and ci.sh gate on:

* **Chrome-trace / Perfetto JSON** (``to_chrome`` / ``export_trace``): the
  Trace Event Format — ``{"traceEvents": [...]}`` with complete ("X"),
  instant ("i"), async ("b"/"e", used for ``queued`` intervals which may
  overlap) and metadata ("M") events.  One process per replica track, one
  thread per slot row, so ``serve.py --trace out.json`` opens directly in
  chrome://tracing or https://ui.perfetto.dev.

* **Metrics JSON** (``metrics_payload`` / ``validate_metrics``): the one
  schema shared by ``benchmarks/common.persist`` (``BENCH_<name>.json``)
  and ``serve.py --metrics-json`` — same top-level latency / throughput /
  utilization / SLO fields, plus the monitor's metrics (histogram quantile
  blocks included) so a benchmark artifact and a serve run are directly
  comparable.
"""
from __future__ import annotations

import json
import pathlib
from typing import Optional, Union

from repro_torch.obs.trace import (EVENT_NAMES, TraceEvent, Tracer, row_name)

# ------------------------------------------------------------- chrome trace

_US = 1e6     # run clock is seconds; chrome wants microseconds


def to_chrome(source: Union[Tracer, list], *,
              track_names: Optional[dict] = None) -> dict:
    """Convert TraceEvents to a Chrome-trace JSON object.  ``track_names``
    optionally maps track id -> display name (default ``replica <id>``)."""
    events = source.events if isinstance(source, Tracer) else source
    out: list[dict] = []
    seen_rows: set = set()
    seen_tracks: set = set()
    for ev in events:
        seen_tracks.add(ev.track)
        seen_rows.add((ev.track, ev.row))
        base = {"name": ev.name, "ts": ev.t0 * _US,
                "pid": ev.track, "tid": ev.row, "cat": "serving"}
        if ev.args:
            base["args"] = ev.args
        if ev.ph == "X" and ev.name == "queued":
            # concurrent waits overlap; async begin/end pairs (keyed by rid)
            # give each its own sub-track in the viewer
            rid = (ev.args or {}).get("rid", id(ev))
            out.append({**base, "ph": "b", "id": rid, "cat": "request"})
            out.append({**base, "ph": "e", "id": rid, "cat": "request",
                        "ts": (ev.t0 + ev.dur) * _US})
        elif ev.ph == "X":
            out.append({**base, "ph": "X", "dur": ev.dur * _US})
        else:
            out.append({**base, "ph": "i", "s": "t"})
    meta: list[dict] = []
    for track in sorted(seen_tracks):
        name = (track_names or {}).get(track, f"replica {track}")
        meta.append({"name": "process_name", "ph": "M", "pid": track,
                     "args": {"name": name}})
    for track, row in sorted(seen_rows):
        meta.append({"name": "thread_name", "ph": "M", "pid": track,
                     "tid": row, "args": {"name": row_name(row)}})
        meta.append({"name": "thread_sort_index", "ph": "M", "pid": track,
                     "tid": row, "args": {"sort_index": row}})
    return {"traceEvents": meta + out, "displayTimeUnit": "ms"}


def export_trace(source: Union[Tracer, list], path, *,
                 track_names: Optional[dict] = None) -> dict:
    """Write the Chrome-trace JSON to ``path``; returns the object."""
    obj = to_chrome(source, track_names=track_names)
    pathlib.Path(path).write_text(json.dumps(obj))
    return obj


_REQUIRED_EVENT_KEYS = ("name", "ph", "ts", "pid", "tid")


def validate_trace(obj: dict) -> list[str]:
    """Schema check of an exported trace (empty list = valid): top-level
    shape, per-event required keys, phase-specific fields, and that every
    non-metadata event uses the shared span vocabulary."""
    errs: list[str] = []
    if not isinstance(obj, dict) or "traceEvents" not in obj:
        return ["missing traceEvents"]
    if not isinstance(obj["traceEvents"], list):
        return ["traceEvents is not a list"]
    for i, ev in enumerate(obj["traceEvents"]):
        if not isinstance(ev, dict):
            errs.append(f"event {i} not an object")
            continue
        ph = ev.get("ph")
        if ph == "M":
            continue
        for k in _REQUIRED_EVENT_KEYS:
            if k not in ev:
                errs.append(f"event {i} ({ev.get('name')!r}) missing {k!r}")
        if ph not in ("X", "i", "b", "e"):
            errs.append(f"event {i} unknown phase {ph!r}")
        if ph == "X" and ev.get("dur", -1.0) < 0:
            errs.append(f"event {i} ({ev.get('name')!r}) bad dur")
        if ev.get("ts", -1.0) < 0:
            errs.append(f"event {i} ({ev.get('name')!r}) negative ts")
        if ev.get("name") not in EVENT_NAMES:
            errs.append(f"event {i} name {ev.get('name')!r} not in the "
                        f"span vocabulary")
    return errs


def event_names(obj: dict) -> set:
    """Distinct non-metadata event names in an exported trace."""
    return {ev.get("name") for ev in obj.get("traceEvents", [])
            if isinstance(ev, dict) and ev.get("ph") != "M"}


# ------------------------------------------------------------- metrics JSON

METRICS_SCHEMA_VERSION = 6
# oldest schema validate_metrics still accepts: v3->v4 only changed the
# profile block (per-replica drift attribution, pricing coverage counters),
# v4->v5 adds the heterogeneous-fleet blocks (per-model/per-tier SLO
# attainment in the monitor, per-model coverage and drift in the profile),
# and v5->v6 adds the monitor's ``faults`` block (replica failures by kind,
# retry/dedup/brownout counters) — all additive, so existing artifacts
# stay readable
METRICS_SCHEMA_MIN = 3

_METRIC_FIELDS = ("latency_s", "p99_latency_s", "throughput",
                  "utilization", "slo_attainment")


def metrics_payload(name: str, *, latency_s=None, p99_latency_s=None,
                    throughput=None, utilization=None, slo_attainment=None,
                    monitor: Optional[dict] = None,
                    profile: Optional[dict] = None,
                    extra: Optional[dict] = None) -> dict:
    """The shared metrics schema: identical top-level fields whether the
    producer is a benchmark harness (``common.persist``) or a serve run
    (``--metrics-json``).  ``monitor`` carries ``Monitor.metrics()``
    verbatim — including the per-axis histogram quantile blocks — and is
    ``{}`` for harnesses that run without a monitor (schema v5: the
    monitor block may carry ``slo_by_key`` per-model/per-tier attainment;
    v6: also a ``faults`` block with failure/retry/brownout counters).
    ``profile`` carries ``CostProfiler.metrics()`` — coverage counters,
    residual quantiles, drift counts (v4: attributed per replica, plus
    optional ``pricing`` coverage counters from the run's calibrated
    models; v5: also per-model blocks and ``drift_by_model``), and
    measured speculative acceptance — and is ``{}`` for runs that served
    without the cost profiler."""
    return {
        "bench": name,
        "schema": METRICS_SCHEMA_VERSION,
        "latency_s": latency_s,
        "p99_latency_s": p99_latency_s,
        "throughput": throughput,
        "utilization": utilization,
        "slo_attainment": slo_attainment,
        "monitor": monitor or {},
        "profile": profile or {},
        "extra": extra or {},
    }


def write_metrics(path, payload: dict) -> None:
    pathlib.Path(path).write_text(json.dumps(payload, indent=1, default=str))


def validate_metrics(obj: dict) -> list[str]:
    """Schema check of a metrics payload (empty list = valid)."""
    errs: list[str] = []
    if not isinstance(obj, dict):
        return ["payload is not an object"]
    if not isinstance(obj.get("bench"), str):
        errs.append("missing/invalid 'bench'")
    if not isinstance(obj.get("schema"), int) \
            or obj.get("schema", 0) < METRICS_SCHEMA_MIN:
        errs.append(f"schema must be an int >= {METRICS_SCHEMA_MIN}")
    for k in _METRIC_FIELDS:
        if k not in obj:
            errs.append(f"missing field {k!r}")
        elif obj[k] is not None and not isinstance(obj[k], (int, float)):
            errs.append(f"field {k!r} must be numeric or null")
    for k in ("monitor", "profile", "extra"):
        if not isinstance(obj.get(k), dict):
            errs.append(f"missing/invalid {k!r}")
    return errs
