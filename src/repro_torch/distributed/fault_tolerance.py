"""Fault-tolerance bookkeeping: the serving cluster's health layer and
the training restart's mesh plan.  Own copy of
``repro/distributed/fault_tolerance.py``:

* ``HeartbeatTracker`` — per-node liveness from periodic heartbeats; a node
  missing ``timeout`` seconds is declared failed.  ``simulate_cluster``'s
  fault mode beats it for live replicas at every health scan and declares
  down whoever ages past ``timeout`` (= ``HealthConfig.detect_lag``);
  crashed and partitioned replicas stop beating, so detection lag is a
  measured quantity, not an assumption.
* ``ElasticTopology`` — the training restart contract: after host
  failures, the largest healthy mesh (whole multiples of the pod
  granularity) to map the job to; the checkpoint's restore places the
  leaves on it.
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
class ElasticTopology:
    """Largest-healthy-mesh computation.  Node granularity = one host
    (4 chips on v5e); meshes must keep whole data-axis rows."""
    pods: int
    hosts_per_pod: int
    chips_per_host: int = 4

    def plan_after_failures(self, failed_hosts: set[int]) -> dict:
        """Returns {'pods': k, 'data': rows, 'mesh_shape': (...)} for the
        largest rectangular mesh avoiding failed hosts.  Strategy: drop any
        pod with a failure if other pods are clean; otherwise shrink the
        data axis to the healthy host rows (whole-row granularity)."""
        per_pod = {p: [] for p in range(self.pods)}
        for h in failed_hosts:
            per_pod[h // self.hosts_per_pod].append(h % self.hosts_per_pod)
        clean = [p for p in range(self.pods) if not per_pod[p]]
        if clean:
            k = len(clean)
            return {"pods": clean, "mesh_shape": (k, self.hosts_per_pod *
                                                  self.chips_per_host // 16, 16),
                    "degraded": False}
        # all pods hit: shrink the data axis of every pod to the minimum
        # healthy-row count so the mesh stays rectangular
        healthy_rows = min(self.hosts_per_pod - len(set(v))
                           for v in per_pod.values())
        rows = max(healthy_rows * self.chips_per_host // 16, 1)
        return {"pods": list(range(self.pods)),
                "mesh_shape": (self.pods, rows, 16), "degraded": True}


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
