"""Request-lifecycle tracing: one span vocabulary for the paged engine, the
iteration-level simulator and the cluster layer.

Own copy of ``repro/obs/trace.py``, trimmed to what those emit through:
the tracer, its no-op instance, the row addressing and the per-request
latency breakdown.  Sinks, the invariant checker and the exporters come with
the observability slice.

    span name        | emitted on | meaning
    -----------------+------------+-----------------------------------
    queued           | queue row  | arrival (or requeue) -> admission
    prefill_chunk    | slot row   | one (chunked) prefill call
    decode           | slot row   | one decode iteration for the slot
    verify           | slot row   | one speculative verify iteration
    batch_prefill    | engine row | padded-replica batch prefill
    batch_decode     | engine row | padded-replica batch decode drain

    instant name     | emitted on | meaning
    -----------------+------------+-----------------------------------
    admitted         | slot row   | request enters a slot
    admission_reject | engine row | queue head blocked on pool demand
    preempt          | slot row   | resident evicted for recompute
    cow_fork         | slot row   | shared tail block forked pre-write
    finish           | slot row   | request completed (EOS/budget)
    shed             | queue row  | router refused (SLO infeasible)
    route            | engine row | router dispatch decision
    scale_up         | engine row | autoscaler ordered replicas
    scale_down       | engine row | autoscaler drained replicas
    replica_failed   | engine row | health layer detected a failure
    retry            | queue row  | lost request re-dispatched
    brownout         | engine row | tier-shedding level changed

Tracks map to replicas (Chrome-trace ``pid``) and rows to slots (``tid``):
row 0 is the engine row, row 1 the queue row, row ``2+k`` slot ``k``.
Timestamps are seconds on the run clock: the workload's arrival timeline
for the simulators, ``perf_counter() - serve_t0`` for live engines, the
axis ``Request.finish_time`` uses.  A disabled tracer (``NULL_TRACER``) is
a no-op on every call; engines and simulators hold one unconditionally and
guard argument construction behind ``tracer.enabled``.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

ROW_ENGINE = 0          # iteration-level events of a replica
ROW_QUEUE = 1           # waiting requests (queued spans, sheds)


def slot_row(slot: int) -> int:
    """Row id of engine slot ``slot`` within its replica track."""
    return 2 + slot


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
    boundary."""

    def __init__(self, enabled: bool = True):
        self.enabled = enabled
        self.events: list[TraceEvent] = []

    def span(self, name: str, t0: float, t1: float, *, track: int = 0,
             row: int = ROW_ENGINE, args: Optional[dict] = None) -> None:
        if self.enabled:
            self.events.append(
                TraceEvent(name, "X", t0, max(0.0, t1 - t0), track, row, args))

    def instant(self, name: str, t: float, *, track: int = 0,
                row: int = ROW_ENGINE, args: Optional[dict] = None) -> None:
        if self.enabled:
            self.events.append(TraceEvent(name, "i", t, 0.0, track, row, args))


NULL_TRACER = Tracer(enabled=False)


@dataclass
class LatencyBreakdown:
    """Per-request phase attribution, attached to finished ``Request``s so
    an SLO violation decomposes into where the time went.  All values are
    seconds on the run clock."""
    queue_wait_s: float = 0.0    # waiting for admission (requeues included)
    prefill_s: float = 0.0       # prefill compute spent on this request
    recompute_s: float = 0.0     # share of prefill_s replaying preempted work
    decode_s: float = 0.0        # first token -> finish
    ttft_s: float = 0.0          # arrival -> first emitted token
    e2e_s: float = 0.0           # arrival -> finish
    preemptions: int = 0         # times this request was evicted/requeued
