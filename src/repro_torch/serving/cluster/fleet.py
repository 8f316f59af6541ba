"""Heterogeneous multi-model fleet: per-model replica pools over a shared
node budget, plus the joint placement/scaling controller.

UELLM's setting is an MLaaS cloud serving *many* models under per-request
SLOs.  ``Fleet`` groups Replicas into per-model pools drawing partitions
from one shared pool of node partitions; ``FleetAutoscaler`` runs one Holt
forecaster per pool and allocates the shared replica budget *jointly* by
marginal SLO-attainment value (Aladdin, PAPERS.md) — including the
model-swap action (drain pool A's replica, spawn one for pool B on the
freed partition) whose latency is priced at ``swap_delay``.

The value function: one more replica for pool *m* at allocation *k* is
worth the extra demand it can actually serve,

    marginal(m, k) = weight_m * (min(d_m, (k+1)*c_m*u) - min(d_m, k*c_m*u))

where ``d_m`` is forecast + backlog-pressure demand (rps), ``c_m`` the
pool's per-replica capacity, ``u`` the target utilization, and
``weight_m`` the pool's SLO-tier value (tight-tier-heavy pools bid more
per served rps).  Greedy allocation of the budget by this marginal is
optimal here because each pool's served demand ``min(d, k*c*u)`` is
concave in ``k`` — the same structure Aladdin exploits.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Callable, Optional, Sequence

from repro_torch.configs.base import ModelConfig
from repro_torch.serving.cluster.autoscaler import ArrivalForecaster
from repro_torch.serving.cluster.replica import HardwareProfile, Replica


@dataclass
class ModelPoolSpec:
    """One model pool of the fleet: which model, how many replicas to start
    with, which hardware lane, and how much one served rps is worth to the
    joint allocator (SLO-tier value)."""
    model: str                              # arch id (configs.get_config)
    cfg: Optional[ModelConfig] = None       # resolved via get_config if None
    replicas: int = 1                       # initial pool size (>= 1)
    weight: float = 1.0                     # marginal-value weight
    hw: Optional[HardwareProfile] = None    # fast/slow lane

    def resolve(self) -> ModelConfig:
        if self.cfg is None:
            from repro_torch.configs import get_config
            self.cfg = get_config(self.model)
        return self.cfg


class Fleet:
    """Replica pools over a shared partition budget.  ``factory`` builds a
    Replica for ``(rid, spec, nodes, latency, now)``; partition selection
    reproduces the single-pool simulator exactly (free list first, then
    round-robin) so legacy runs stay byte-identical."""

    def __init__(self, partitions: Sequence, specs: Sequence[ModelPoolSpec],
                 factory: Callable):
        self.partitions = list(partitions)
        self.free_parts = list(range(len(self.partitions)))
        self.replicas: list[Replica] = []
        self.specs = {s.model: s for s in specs}
        self._factory = factory

    @property
    def models(self) -> list[str]:
        return list(self.specs)

    def pool(self, model: str) -> list[Replica]:
        return [r for r in self.replicas if r.model == model]

    def accepting(self, model: Optional[str] = None) -> list[Replica]:
        return [r for r in self.replicas if r.accepting
                and (model is None or r.model == model)]

    @property
    def has_free_partition(self) -> bool:
        return bool(self.free_parts)

    def spawn(self, model: str, now: float) -> Replica:
        spec = self.specs[model]
        idx = len(self.replicas)
        # take a *free* partition — a retired replica returns its nodes, so
        # a respawn never double-books hardware a live replica still holds
        pi = self.free_parts.pop(0) if self.free_parts \
            else idx % len(self.partitions)
        nodes, lat = self.partitions[pi]
        rep = self._factory(idx, spec, nodes, lat, now)
        rep.partition = pi
        self.replicas.append(rep)
        return rep

    def retire(self, rep: Replica, now: float) -> None:
        rep.retire(now)
        self.free_parts.append(rep.partition)


@dataclass
class FleetAutoscalerConfig:
    """Joint controller knobs.  ``budget`` is the shared replica budget
    (node partitions); ``swap_delay`` prices the model-swap scale action
    (drain A + load B's weights on the freed partition) and must be >=
    ``spawn_delay`` (a swap is a spawn that first waits out a drain)."""
    interval: float = 2.0
    level_alpha: float = 0.5
    trend_beta: float = 0.3
    horizon: float = 4.0
    target_util: float = 0.75
    budget: int = 8
    min_per_pool: int = 1          # floor for any *active* pool
    idle_patience: int = 8         # demand-free ticks before a pool loses
    #                                its floor (momentarily-quiet pools keep
    #                                a warm replica; dormant ones drain)
    spawn_delay: float = 1.0
    swap_delay: float = 2.5
    down_patience: int = 3
    backlog_weight: float = 1.0


@dataclass
class FleetScaleEvent:
    time: float
    model: str
    direction: int                 # +1 grow order, -1 drain order
    n_replicas: int                # pool target after the decision
    forecast_rps: float
    desired: int
    swap: bool = False             # forced drain paired with another
    #                                pool's grow (model-swap action)


class FleetAutoscaler:
    """Per-pool Holt forecasts -> joint greedy allocation of the shared
    budget by marginal SLO-attainment value.  Scale-up per pool is
    immediate; scale-down waits ``down_patience`` low ticks *unless* the
    budget is exhausted and another pool is bidding higher — then the most
    over-provisioned pool drains now (swap) so the bidder's spawn can take
    its partition."""

    def __init__(self, cfg: FleetAutoscalerConfig,
                 capacities: dict, weights: Optional[dict] = None):
        for m, c in capacities.items():
            if c <= 0:
                raise ValueError(f"capacity for pool {m!r} must be positive")
        self.cfg = cfg
        self.capacity = dict(capacities)
        self.weights = {m: 1.0 for m in capacities}
        self.weights.update(weights or {})
        self.forecasters = {m: ArrivalForecaster(cfg.level_alpha,
                                                 cfg.trend_beta)
                            for m in capacities}
        self.events: list[FleetScaleEvent] = []
        self._low = {m: 0 for m in capacities}
        self._idle = {m: 0 for m in capacities}   # demand-free tick streaks

    def set_capacity(self, model: str, capacity_rps: float) -> None:
        if capacity_rps <= 0:
            raise ValueError("capacity_rps must be positive")
        self.capacity[model] = capacity_rps

    def marginal(self, model: str, k: int, demand: float) -> float:
        """Value of replica k+1 for ``model``: extra demand it serves,
        weighted by the pool's SLO-tier value."""
        c = self.capacity[model] * self.cfg.target_util
        return self.weights[model] * (min(demand, (k + 1) * c)
                                      - min(demand, k * c))

    def desired_allocation(self, demand: dict,
                           active: Optional[set] = None) -> dict:
        """Greedy budget split by marginal value (optimal: served demand is
        concave in pool size).  ``active`` pools (default: pools with live
        demand) keep a ``min_per_pool`` availability floor — ``tick``
        passes every pool seen trafficked within ``idle_patience`` ticks,
        so a momentarily-quiet trickle pool keeps its warm replica instead
        of churning through drain/cold-start cycles — while dormant pools
        get nothing and their floor is reallocated to the bidders."""
        alloc = {m: 0 for m in demand}
        used = 0
        for m in sorted(demand):
            live = demand[m] > 1e-9 if active is None else m in active
            if live and used < self.cfg.budget:
                take = min(self.cfg.min_per_pool, self.cfg.budget - used)
                alloc[m] = take
                used += take
        while used < self.cfg.budget:
            best, gain = None, 1e-9
            for m in sorted(demand):
                g = self.marginal(m, alloc[m], demand[m])
                if g > gain:
                    best, gain = m, g
            if best is None:
                break
            alloc[best] += 1
            used += 1
        return alloc

    def tick(self, now: float, arrivals: dict, replicas: list,
             pending: Optional[dict] = None) -> dict:
        """One joint control step.  ``arrivals`` maps model -> requests
        since the last tick; ``pending`` maps model -> spawns in flight.
        Returns model -> target pool size (accepting + pending)."""
        pending = pending or {}
        demand = {}
        for m, f in self.forecasters.items():
            got = arrivals.get(m, 0)
            self._idle[m] = 0 if got else self._idle[m] + 1
            f.observe(got / self.cfg.interval)
            fc = f.forecast(self.cfg.horizon / self.cfg.interval)
            queued = sum(r.queue_depth for r in replicas
                         if r.accepting and r.model == m)
            demand[m] = fc + self.cfg.backlog_weight * queued \
                / max(self.cfg.horizon, 1e-9)
        active = {m for m in demand
                  if demand[m] > 1e-9
                  or self._idle[m] < self.cfg.idle_patience}
        want = self.desired_allocation(demand, active)
        targets = {}
        for m in self.forecasters:
            cur = sum(1 for r in replicas if r.accepting and r.model == m) \
                + pending.get(m, 0)
            if want[m] > cur:
                self._low[m] = 0
                self.events.append(FleetScaleEvent(
                    now, m, +1, want[m], demand[m], want[m]))
                targets[m] = want[m]
            elif want[m] < cur:
                self._low[m] += 1
                if self._low[m] >= self.cfg.down_patience:
                    self._low[m] = 0
                    self.events.append(FleetScaleEvent(
                        now, m, -1, want[m], demand[m], want[m]))
                    targets[m] = want[m]
                else:
                    targets[m] = cur
            else:
                self._low[m] = 0
                targets[m] = cur
        # shared-budget conflict: a grow order with every partition taken
        # forces the most over-provisioned held-down pool to drain *now* —
        # the model-swap action; its partner spawn prices swap_delay
        total = sum(targets.values())
        if total > self.cfg.budget:
            overs = sorted(((targets[m] - want[m], m) for m in targets
                            if targets[m] > want[m]), reverse=True)
            for _, m in overs:
                if total <= self.cfg.budget:
                    break
                give = min(targets[m] - want[m], total - self.cfg.budget)
                targets[m] -= give
                total -= give
                self._low[m] = 0
                self.events.append(FleetScaleEvent(
                    now, m, -1, targets[m], demand[m], want[m], swap=True))
        return targets
