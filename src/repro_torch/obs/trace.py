"""Request-lifecycle tracing: one shared span vocabulary for the live paged
engine, the iteration-level simulator, and the cluster layer.

Own copy of ``repro/obs/trace.py``.

Every serving subsystem used to improvise its own ad-hoc
``time.perf_counter()`` deltas; this module standardizes the *event
vocabulary* so a simulated run and a live run produce diffable timelines:

    span name        | emitted on          | meaning
    -----------------+---------------------+----------------------------------
    queued           | queue row           | arrival (or requeue) -> admission
    prefill_chunk    | slot row            | one (chunked) prefill call
    decode           | slot row            | one decode iteration for the slot
    verify           | slot row            | one speculative verify iteration
    batch_prefill    | engine row          | padded-replica batch prefill
    batch_decode     | engine row          | padded-replica batch decode drain

    instant name     | emitted on          | meaning
    -----------------+---------------------+----------------------------------
    admitted         | slot row            | request enters a slot
    admission_reject | engine row          | queue head blocked on pool demand
    preempt          | slot row            | resident evicted for recompute
    cow_fork         | slot row            | shared tail block forked pre-write
    finish           | slot row            | request completed (EOS/budget)
    shed             | queue row           | router refused (SLO infeasible)
    route            | engine row          | router dispatch decision
    scale_up         | engine row          | autoscaler ordered replicas
    scale_down       | engine row          | autoscaler drained replicas
    replica_failed   | engine row          | health layer detected a failure
    retry            | queue row           | lost request re-dispatched
    brownout         | engine row          | tier-shedding level changed

Tracks map to replicas (Chrome-trace ``pid``) and rows to slots within a
replica (``tid``): row 0 is the engine/iteration row, row 1 the queue row,
row ``2+k`` slot ``k`` — so a serve run opens directly in chrome://tracing
(or Perfetto) with one swimlane per slot.

Timestamps are seconds on the *run clock*: the workload's arrival timeline
for simulators, ``perf_counter() - serve_t0`` for live engines — the same
axis ``Request.finish_time`` already uses, so spans and SLO accounting
agree.  A disabled tracer (``Tracer(enabled=False)`` / ``NULL_TRACER``) is
a no-op on every call; engines hold one unconditionally and hot paths guard
argument construction behind ``tracer.enabled``.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Optional

# ------------------------------------------------------------ row addressing

ROW_ENGINE = 0          # iteration-level events of a replica
ROW_QUEUE = 1           # waiting requests (queued spans, sheds)


def slot_row(slot: int) -> int:
    """Row id of engine slot ``slot`` within its replica track."""
    return 2 + slot


ROW_NAMES = {ROW_ENGINE: "engine", ROW_QUEUE: "queue"}


def row_name(row: int) -> str:
    return ROW_NAMES.get(row, f"slot {row - 2}")


# ---------------------------------------------------------- span vocabulary

SPAN_NAMES = frozenset({
    "queued", "prefill_chunk", "decode", "verify",
    "batch_prefill", "batch_decode",
})
INSTANT_NAMES = frozenset({
    "admitted", "admission_reject", "preempt", "cow_fork", "finish",
    "shed", "route", "scale_up", "scale_down", "profile_drift",
    "replica_failed", "retry", "brownout",
})
EVENT_NAMES = SPAN_NAMES | INSTANT_NAMES


@dataclass
class TraceEvent:
    """One timeline event (seconds on the run clock; ``dur`` only for
    spans)."""
    name: str
    ph: str                     # "X" span | "i" instant
    t0: float
    dur: float = 0.0
    track: int = 0              # replica id -> chrome pid
    row: int = ROW_ENGINE       # slot/engine/queue row -> chrome tid
    args: Optional[dict] = None


class Tracer:
    """Collects TraceEvents; a disabled tracer drops everything at the call
    boundary so instrumented code needs no branches of its own (hot loops
    may still guard args-dict construction behind ``tracer.enabled``).

    ``sinks`` are callbacks fed every event as it is emitted — the online
    cost profiler (``obs.profile.CostProfiler``) attaches here to learn
    measured phase times from the span stream.  ``retain=False`` turns the
    tracer into a pure measurement bus: sinks still see every event but
    nothing is stored, so profiling a long serve run costs O(1) memory."""

    def __init__(self, enabled: bool = True, retain: bool = True):
        self.enabled = enabled
        self.retain = retain
        self.events: list[TraceEvent] = []
        self.sinks: list = []

    def __bool__(self) -> bool:
        return self.enabled

    def add_sink(self, sink) -> None:
        """Register a callback invoked with each emitted TraceEvent."""
        self.sinks.append(sink)

    def span(self, name: str, t0: float, t1: float, *, track: int = 0,
             row: int = ROW_ENGINE, args: Optional[dict] = None) -> None:
        if not self.enabled:
            return
        ev = TraceEvent(name, "X", t0, max(0.0, t1 - t0), track, row, args)
        if self.retain:
            self.events.append(ev)
        for sink in self.sinks:
            sink(ev)

    def instant(self, name: str, t: float, *, track: int = 0,
                row: int = ROW_ENGINE, args: Optional[dict] = None) -> None:
        if not self.enabled:
            return
        ev = TraceEvent(name, "i", t, 0.0, track, row, args)
        if self.retain:
            self.events.append(ev)
        for sink in self.sinks:
            sink(ev)

    def clear(self) -> None:
        self.events.clear()


NULL_TRACER = Tracer(enabled=False)


def check_invariants(events: list[TraceEvent]) -> list[str]:
    """Structural invariants every producer must hold (tests gate on this):

    * every event name belongs to the shared vocabulary;
    * spans have non-negative duration, instants zero;
    * on any one (track, row) lane, *work* spans are properly nested or
      disjoint — a lane is a call stack, and partially overlapping spans
      would render as garbage in any trace viewer.  ``queued`` spans are
      exempt: many requests wait concurrently, so they are intervals, not
      stack frames (the exporter emits them as async events for the same
      reason).
    Returns human-readable violations (empty = clean)."""
    errs = []
    lanes: dict = {}
    for ev in events:
        if ev.name not in EVENT_NAMES:
            errs.append(f"unknown event name {ev.name!r}")
        if ev.ph == "X" and ev.name not in SPAN_NAMES:
            errs.append(f"{ev.name!r} emitted as span but not in SPAN_NAMES")
        if ev.ph == "i" and ev.name not in INSTANT_NAMES:
            errs.append(f"{ev.name!r} emitted as instant but not in "
                        f"INSTANT_NAMES")
        if ev.dur < 0:
            errs.append(f"{ev.name!r} negative duration {ev.dur}")
        if ev.ph == "X" and ev.name != "queued":
            lanes.setdefault((ev.track, ev.row), []).append(ev)
    for (track, row), spans in lanes.items():
        spans.sort(key=lambda e: (e.t0, -e.dur))
        stack: list[TraceEvent] = []
        for ev in spans:
            while stack and stack[-1].t0 + stack[-1].dur <= ev.t0 + 1e-12:
                stack.pop()
            if stack and ev.t0 + ev.dur > stack[-1].t0 + stack[-1].dur + 1e-9:
                errs.append(
                    f"track {track} row {row}: span {ev.name!r} "
                    f"[{ev.t0:.6f}, {ev.t0 + ev.dur:.6f}] partially overlaps "
                    f"{stack[-1].name!r}")
            stack.append(ev)
    return errs


# ------------------------------------------------------- latency attribution

@dataclass
class LatencyBreakdown:
    """Per-request phase attribution, attached to finished ``Request``s so
    an SLO violation decomposes into *where the time went* instead of one
    opaque end-to-end number.  All values are seconds on the run clock."""
    queue_wait_s: float = 0.0    # waiting for admission (requeues included)
    prefill_s: float = 0.0       # prefill compute spent on this request
    recompute_s: float = 0.0     # share of prefill_s replaying preempted work
    decode_s: float = 0.0        # first token -> finish
    ttft_s: float = 0.0          # arrival -> first emitted token
    e2e_s: float = 0.0           # arrival -> finish
    preemptions: int = 0         # times this request was evicted/requeued

    @property
    def stall_s(self) -> float:
        """Residual time not attributed to queue/prefill/decode — scheduling
        gaps (e.g. iterations spent mid-prefill while others ran)."""
        return max(0.0, self.e2e_s - self.queue_wait_s - self.prefill_s
                   - self.decode_s)

    def phases(self) -> dict:
        """The decomposition EXPERIMENTS.md tables are built from."""
        return {
            "queue_wait_s": round(self.queue_wait_s, 6),
            "prefill_s": round(self.prefill_s, 6),
            "recompute_s": round(self.recompute_s, 6),
            "decode_s": round(self.decode_s, 6),
            "stall_s": round(self.stall_s, 6),
            "ttft_s": round(self.ttft_s, 6),
            "e2e_s": round(self.e2e_s, 6),
            "preemptions": self.preemptions,
        }
