"""Forecast-driven autoscaling of the replica set.

SageServe's observation (PAPERS.md, arXiv 2502.14617): LLM arrival traffic
is forecastable at short horizons, and reactive-only scaling pays the cold
-start penalty inside every burst.  The controller here:

* ``ArrivalForecaster`` — Holt double-EWMA (level + trend) over per-tick
  arrival rates; ``forecast(k)`` extrapolates k ticks ahead so a replica
  ordered *now* (``spawn_delay`` seconds before it can serve) lands when
  the load it was ordered for actually arrives;
* ``Autoscaler.tick`` — desired replicas = ceil((forecast rate + queued
  backlog pressure) / (per-replica capacity x target utilization)), clamped
  to [min, max].  Scale-up is immediate; scale-down requires
  ``down_patience`` consecutive low ticks (hysteresis — a single quiet tick
  inside a burst train must not trigger a drain/respawn cycle).

Placement is joint with scaling: the cluster keeps a list of node
partitions, and each scale-up runs HELR over the next free partition to
produce the new replica's DeviceMap — the paper's deployer applied at
replica-spawn time rather than once at cluster start.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Optional

from repro_torch.serving.cluster.replica import Replica


@dataclass
class AutoscalerConfig:
    interval: float = 2.0          # control period (s)
    level_alpha: float = 0.5       # Holt level smoothing
    trend_beta: float = 0.3        # Holt trend smoothing
    horizon: float = 4.0           # forecast lookahead (s)
    target_util: float = 0.75      # headroom: provision to 75% of capacity
    min_replicas: int = 1
    max_replicas: int = 8
    spawn_delay: float = 1.0       # HELR deploy + weight-load lead time (s)
    down_patience: int = 3         # consecutive low ticks before scale-down
    backlog_weight: float = 1.0    # queued work folded into demand


class ArrivalForecaster:
    """Holt linear (double-EWMA) smoothing over evenly spaced rate samples."""

    def __init__(self, level_alpha: float = 0.5, trend_beta: float = 0.3):
        self.a = level_alpha
        self.b = trend_beta
        self.level: Optional[float] = None
        self.trend = 0.0

    def observe(self, rate: float) -> None:
        if self.level is None:
            self.level = rate
            return
        prev = self.level
        self.level = self.a * rate + (1 - self.a) * (self.level + self.trend)
        self.trend = self.b * (self.level - prev) + (1 - self.b) * self.trend

    def forecast(self, k_ticks: float) -> float:
        """Projected rate k ticks ahead (>= 0)."""
        if self.level is None:
            return 0.0
        return max(0.0, self.level + self.trend * k_ticks)


@dataclass
class ScaleEvent:
    time: float
    direction: int                 # +1 scale-up order, -1 drain order
    n_replicas: int                # accepting replicas after the decision
    forecast_rps: float
    desired: int


class Autoscaler:
    """Periodic controller mapping forecast load to a replica count.

    ``capacity_rps`` comes from ``Replica.capacity_rps``, which prices
    through the replica's *tail* model — by default the mean belief, or a
    quantile-``CalibratedLatencyModel`` when tail pricing is configured,
    so SLO-backed provisioning headroom reflects the measured slow tail
    rather than the average.  ``set_capacity`` lets a caller refresh the
    denominator as online calibration sharpens it mid-run."""

    def __init__(self, cfg: AutoscalerConfig, capacity_rps: float):
        if capacity_rps <= 0:
            raise ValueError("capacity_rps must be positive")
        self.cfg = cfg
        self.capacity = capacity_rps
        self.forecaster = ArrivalForecaster(cfg.level_alpha, cfg.trend_beta)
        self.events: list[ScaleEvent] = []
        self._low_streak = 0

    def set_capacity(self, capacity_rps: float) -> None:
        """Replace the per-replica capacity estimate (online recalibration;
        forecaster state and hysteresis streaks are preserved)."""
        if capacity_rps <= 0:
            raise ValueError("capacity_rps must be positive")
        self.capacity = capacity_rps

    def desired_replicas(self, forecast_rps: float,
                         queued: int = 0) -> int:
        """Replicas needed for the forecast rate plus queued-backlog
        pressure (queued requests must drain within ~the horizon)."""
        demand = forecast_rps + self.cfg.backlog_weight * queued \
            / max(self.cfg.horizon, 1e-9)
        need = math.ceil(demand / (self.capacity * self.cfg.target_util)) \
            if demand > 0 else self.cfg.min_replicas
        return max(self.cfg.min_replicas, min(self.cfg.max_replicas, need))

    def tick(self, now: float, arrivals: int, replicas: list[Replica],
             pending_spawns: int = 0) -> int:
        """One control step.  ``arrivals`` = requests since the last tick;
        ``pending_spawns`` = replicas already ordered but not yet serving
        (they count toward capacity, so a spawn in flight is not re-ordered
        — and not re-logged — every tick of its delay).  Returns the target
        number of accepting-or-pending replicas (scale-up applies
        immediately — modulo spawn_delay, which the caller models;
        scale-down only after ``down_patience`` consecutive low ticks)."""
        self.forecaster.observe(arrivals / self.cfg.interval)
        f = self.forecaster.forecast(self.cfg.horizon / self.cfg.interval)
        accepting = [r for r in replicas if r.accepting]
        queued = sum(r.queue_depth for r in accepting)
        cur = len(accepting) + pending_spawns
        want = self.desired_replicas(f, queued)
        if want > cur:
            self._low_streak = 0
            self.events.append(ScaleEvent(now, +1, want, f, want))
            return want
        if want < cur:
            self._low_streak += 1
            if self._low_streak >= self.cfg.down_patience:
                self._low_streak = 0
                self.events.append(ScaleEvent(now, -1, want, f, want))
                return want
            return cur
        self._low_streak = 0
        return cur
