"""Fault-tolerance bookkeeping of the serving cluster's health layer.

Own copy of the serving half of ``repro/distributed/fault_tolerance.py``
(the mesh re-planning of the training restart path stays there):

* ``HeartbeatTracker`` — per-node liveness from periodic heartbeats; a node
  missing ``timeout`` seconds is declared failed.  ``simulate_cluster``'s
  fault mode beats it for live replicas at every health scan and declares
  down whoever ages past ``timeout`` (= ``HealthConfig.detect_lag``);
  crashed and partitioned replicas stop beating, so detection lag is a
  measured quantity, not an assumption.
* ``StragglerMitigator`` — tracks per-replica step latencies (EWMA);
  replicas slower than ``factor`` × the fleet median get drained.  With
  ``HealthConfig.straggler_factor > 0`` the simulator records each
  replica's measured/predicted batch-time ratio and drains whoever
  ``mitigate()`` flags.
"""
from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Optional

import numpy as np


@dataclass
class HeartbeatTracker:
    timeout: float = 30.0
    last_seen: dict[int, float] = field(default_factory=dict)

    def beat(self, node_id: int, now: Optional[float] = None):
        self.last_seen[node_id] = now if now is not None else time.monotonic()

    def failed(self, now: Optional[float] = None) -> list[int]:
        now = now if now is not None else time.monotonic()
        return [n for n, t in self.last_seen.items() if now - t > self.timeout]

    def healthy(self, now: Optional[float] = None) -> list[int]:
        now = now if now is not None else time.monotonic()
        return [n for n, t in self.last_seen.items() if now - t <= self.timeout]


@dataclass
class StragglerMitigator:
    factor: float = 1.5
    ewma: float = 0.2
    lat: dict[int, float] = field(default_factory=dict)
    drained: set[int] = field(default_factory=set)

    def record(self, replica: int, step_latency: float):
        prev = self.lat.get(replica)
        self.lat[replica] = (step_latency if prev is None
                             else (1 - self.ewma) * prev + self.ewma * step_latency)

    def median(self) -> float:
        vals = [v for k, v in self.lat.items() if k not in self.drained]
        return float(np.median(vals)) if vals else 0.0

    def stragglers(self) -> list[int]:
        med = self.median()
        if med <= 0:
            return []
        return [r for r, v in self.lat.items()
                if r not in self.drained and v > self.factor * med]

    def drain(self, replica: int):
        self.drained.add(replica)

    def active_replicas(self) -> list[int]:
        return [r for r in self.lat if r not in self.drained]

    def mitigate(self) -> list[int]:
        """Drain all current stragglers; returns who was drained."""
        out = self.stragglers()
        for r in out:
            self.drain(r)
        return out
