"""Failure injection and fault-tolerance policy for the cluster simulator.

The cluster layer of PRs 3-9 measured SLO attainment in a world where no
replica ever breaks; this module supplies the vocabulary the simulator's
fault mode speaks:

* ``FaultEvent`` / ``FaultPlan`` — *what goes wrong and when*: scripted
  events plus an optional seeded MTBF/MTTR random model, materialized into
  one deterministic event list before the run starts (same seed, same
  faults — the retry-identity gates depend on it);
* ``HealthConfig`` — *how failures are noticed and answered*: heartbeat
  cadence and detection lag (``distributed.fault_tolerance.HeartbeatTracker``
  does the bookkeeping), straggler policing, and the tier order brownout
  sheds under detected capacity loss;
* ``RetryConfig`` — *what happens to the lost work*: re-dispatch budget and
  exponential backoff for requests that died with a crashed/partitioned
  replica, carrying already-generated tokens as a recompute prefix so a
  retried request stays token-identical to an unfailed run.

Four fault kinds:

    kind       | replica effect                     | recovery
    -----------+------------------------------------+----------------------
    crash      | inflight + queued work lost, KV    | never (autoscaler
               | gone; silent until detected        | respawns capacity)
    degrade    | physics slow down by ``factor``    | after ``duration``
               | while pricing keeps healthy belief | (0 = permanent)
               | -> calibration drift must fire     |
    stall      | replica busy for ``duration``      | automatic
    partition  | unreachable by the router; work    | after ``duration``
               | continues and may finish late      | (rejoin + dedup)
"""
from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

FAULT_KINDS = ("crash", "degrade", "stall", "partition")


@dataclass
class FaultEvent:
    """One scripted fault: at time ``t`` replica ``rid`` suffers ``kind``.
    ``duration`` is the recovery horizon for stall/partition (required > 0)
    and degrade (0 = permanent); crashes never self-heal.  ``factor`` is
    the degrade slowdown (physics run ``factor`` times slower)."""
    t: float
    kind: str
    rid: int
    duration: float = 0.0
    factor: float = 2.0

    def __post_init__(self):
        if self.kind not in FAULT_KINDS:
            raise ValueError(f"unknown fault kind {self.kind!r} "
                             f"(expected one of {FAULT_KINDS})")
        if self.kind in ("stall", "partition") and self.duration <= 0:
            raise ValueError(f"{self.kind} fault needs duration > 0")
        if self.kind == "degrade" and self.factor <= 1.0:
            raise ValueError("degrade factor must exceed 1.0")


@dataclass
class FaultPlan:
    """The full injection schedule: scripted events plus an optional
    random crash model.  With ``mtbf > 0`` each of the first
    ``n_replicas`` lanes draws exponential inter-failure gaps (seeded, so
    runs are reproducible); ``kinds`` cycles the random events' classes.
    ``mttr`` becomes the ``duration`` of recoverable random faults."""
    events: list = field(default_factory=list)
    mtbf: float = 0.0
    mttr: float = 0.0
    seed: int = 0
    kinds: tuple = ("crash",)

    def materialize(self, n_replicas: int, horizon: float) -> list:
        """The deterministic, time-sorted event list a run injects."""
        out = list(self.events)
        if self.mtbf > 0:
            rng = np.random.default_rng(self.seed)
            for rid in range(n_replicas):
                t = float(rng.exponential(self.mtbf))
                k = 0
                while t < horizon:
                    kind = self.kinds[k % len(self.kinds)]
                    out.append(FaultEvent(
                        t=t, kind=kind, rid=rid,
                        duration=self.mttr if kind != "crash" else 0.0))
                    if kind == "crash":
                        break          # a crashed lane stays dead
                    t += float(rng.exponential(self.mtbf))
                    k += 1
        return sorted(out, key=lambda e: (e.t, e.rid))


@dataclass
class RetryConfig:
    """Re-dispatch policy for requests lost to a crash/partition.  A lost
    request is retried at most ``budget`` times with exponential backoff
    ``backoff_base * backoff_mult**attempt`` (attempt 0 = first retry);
    past the budget it counts as a shed.  ``budget=0`` disables retry —
    the crash-without-retry ablation arm."""
    budget: int = 2
    backoff_base: float = 0.25
    backoff_mult: float = 2.0

    def backoff(self, attempt: int) -> float:
        return self.backoff_base * self.backoff_mult ** attempt


@dataclass
class HealthConfig:
    """Detection and degraded-mode policy.  ``check_interval`` is the
    heartbeat/health-scan cadence; a replica silent for ``detect_lag``
    seconds is declared down (the lag is the window in which a crashed
    replica still looks routable — exactly the attainment cost the
    §Robustness decomposition measures).  ``brownout_tiers`` lists SLO
    tiers in shed-first order: detected loss of k replicas sheds arrivals
    of the first k listed tiers.  ``straggler_factor > 0`` arms the
    ``StragglerMitigator``: replicas whose measured/predicted batch-time
    ratio exceeds ``factor`` times the fleet median are drained."""
    check_interval: float = 0.5
    detect_lag: float = 1.0
    brownout_tiers: tuple = ()
    straggler_factor: float = 0.0
