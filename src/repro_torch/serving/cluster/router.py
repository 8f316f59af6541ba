"""SLO-aware request routing across replicas.

Four pluggable dispatch policies (Aladdin/SageServe's cluster layer over
UELLM's signals — PAPERS.md):

* ``round_robin``     — the baseline every serving frontend ships with;
* ``least_loaded``    — power-of-d-choices on *projected backlog seconds*
  (profiler-predicted lengths priced through each replica's LatencyModel),
  not queue length: a queue of 3 long-answer requests outweighs one of 5
  short ones;
* ``prefix_affinity`` — route to the replica whose radix tree holds the
  longest prompt match (hits skip prefill and discount block demand);
  cold prompts fall back to rendezvous (highest-random-weight) hashing of
  the leading prompt block, so every template is sticky to one replica
  *and* stays sticky when the autoscaler changes the replica set — HRW
  only remaps keys owned by a removed replica;
* ``slo_aware``       — earliest-projected-finish among replicas that can
  still meet the request's deadline; when none can, the request is **shed**
  at admission (counted as an SLO violation) instead of poisoning every
  queue behind it.  ``projected_finish`` prices through each replica's
  *tail* model — per-replica and quantile-calibrated when configured
  (``Replica.tail``) — because an admit decision backing a p99-gated SLO
  off a fleet-mean ratio systematically under-prices slow replicas.

All four policies are **model-aware**: a request tagged ``r.model`` is
ranked only within its compatible pool (replicas serving that model), and
affinity/rendezvous keys are namespaced by model so two pools' identical
templates never collide.  A tagged request whose pool has no live replica
is counted as a ``pool_fault`` and shed deterministically (``dispatch``
returns None) — never a silent misroute, and never an exception out of
the hot dispatch path: with failure injection an entire pool can be down
between detection and respawn, and routing must degrade, not crash.
``model_aware=False``
is the ablation baseline: policies rank the whole fleet, and a pick that
lands outside the compatible pool is counted as a **misroute** and bounced
into the pool — the caller charges the forward hop (``forward_delay``).

``Router.dispatch`` only *selects*; the caller enqueues, so live-engine and
simulated paths share the policy code.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Optional

import numpy as np

from repro_torch.core.types import Request
from repro_torch.serving.cluster.replica import Replica

POLICIES = ("round_robin", "least_loaded", "prefix_affinity", "slo_aware")


class NoCompatiblePoolError(RuntimeError):
    """A model-tagged request found no live replica serving its model."""

    def __init__(self, model: str):
        super().__init__(f"no live replica serves model {model!r} "
                         f"(compatible pool is empty)")
        self.model = model


@dataclass
class RouterConfig:
    policy: str = "round_robin"
    d_choices: int = 2             # replicas sampled by least_loaded
    affinity_block: int = 16       # leading tokens keyed by the HRW fallback
    min_affinity_hit: int = 1      # tokens a match must cover to count
    shed_slack: float = 0.0        # extra seconds granted before shedding
    seed: int = 0
    # model-blind ablation: rank the whole fleet, bounce misroutes into the
    # compatible pool at a forward-hop cost the caller charges
    model_aware: bool = True
    forward_delay: float = 0.25    # seconds a bounced misroute pays

    def __post_init__(self):
        if self.policy not in POLICIES:
            raise ValueError(f"unknown router policy {self.policy!r}; "
                             f"choose from {POLICIES}")


@dataclass
class RouterStats:
    dispatched: int = 0
    shed: int = 0
    affinity_hits: int = 0         # routed by a radix-tree match
    hash_fallbacks: int = 0        # routed by rendezvous hash (cold prompt)
    misroutes: int = 0             # model-blind picks bounced into the pool
    pool_faults: int = 0           # NoCompatiblePoolError raised
    shed_by_tier: dict = field(default_factory=dict)

    def summary(self) -> dict:
        out = {"dispatched": self.dispatched, "shed": self.shed,
               "affinity_hits": self.affinity_hits,
               "hash_fallbacks": self.hash_fallbacks}
        if self.misroutes:
            out["misroutes"] = self.misroutes
        if self.pool_faults:
            out["pool_faults"] = self.pool_faults
        if self.shed_by_tier:
            out["shed_by_tier"] = dict(self.shed_by_tier)
        return out


def _hrw(key: tuple, rid: int) -> int:
    """Rendezvous weight of (key, replica) — deterministic for int tokens
    (CPython salts only str/bytes hashing)."""
    return hash((key, rid))


class Router:
    def __init__(self, cfg: RouterConfig = RouterConfig()):
        self.cfg = cfg
        self.stats = RouterStats()
        self._rr = 0                   # legacy shared round-robin cursor
        self._rr_by_pool: dict = {}    # model -> per-pool cursor
        self._rng = np.random.default_rng(cfg.seed)

    # -------------------------------------------------------------- policies
    def _round_robin(self, r: Request, alive: list[Replica],
                     now: float) -> Replica:
        model = getattr(r, "model", "")
        if model and self.cfg.model_aware:
            # per-pool cursor: interleaved multi-model arrivals must still
            # cycle evenly *within* each pool
            idx = self._rr_by_pool.get(model, 0)
            self._rr_by_pool[model] = idx + 1
        else:
            idx = self._rr
            self._rr += 1
        return alive[idx % len(alive)]

    def _least_loaded(self, r: Request, alive: list[Replica],
                      now: float) -> Replica:
        d = min(self.cfg.d_choices, len(alive))
        picks = self._rng.choice(len(alive), size=d, replace=False)
        return min((alive[i] for i in picks),
                   key=lambda rep: rep.projected_backlog(now))

    def _prefix_affinity(self, r: Request, alive: list[Replica],
                         now: float) -> Replica:
        hits = [(rep.prefix_peek(r.tokens), rep) for rep in alive]
        best_hit, best = max(hits, key=lambda h: (h[0], -h[1].rid))
        if best_hit >= self.cfg.min_affinity_hit:
            self.stats.affinity_hits += 1
            return best
        # namespace the rendezvous key by model so identical templates in
        # two pools stay sticky independently; untagged requests keep the
        # legacy key (stable HRW assignment across this change)
        key = tuple(r.tokens[:self.cfg.affinity_block])
        model = getattr(r, "model", "")
        if model:
            key = (model,) + key
        self.stats.hash_fallbacks += 1
        return max(alive, key=lambda rep: _hrw(key, rep.rid))

    def _slo_aware(self, r: Request, alive: list[Replica],
                   now: float) -> Optional[Replica]:
        deadline = r.arrival + r.slo + self.cfg.shed_slack
        # projected_finish is tail-priced (Replica.tail): heterogeneous
        # fleets rank replicas by their own calibrated cost, not a shared
        # mean, so the slow replica stops winning ties it cannot honor
        ranked = sorted(((rep.projected_finish(r, now), rep.rid, rep)
                         for rep in alive))
        finish, _, rep = ranked[0]
        if finish > deadline:
            return None                       # nobody can make it: shed
        return rep

    # -------------------------------------------------------------- dispatch
    def _select(self, r: Request, cands: list[Replica],
                now: float) -> Optional[Replica]:
        # pool backpressure: a replica whose projected block demand has
        # exhausted its pool only receives work when every pool is full
        roomy = [rep for rep in cands if rep.free_blocks > 0]
        cands = roomy or cands
        return getattr(self, f"_{self.cfg.policy}")(r, cands, now)

    def _shed(self, r: Request) -> None:
        self.stats.shed += 1
        tier = getattr(r, "tier", "") or "default"
        self.stats.shed_by_tier[tier] = \
            self.stats.shed_by_tier.get(tier, 0) + 1

    def dispatch(self, r: Request, replicas: list[Replica],
                 now: float) -> Optional[Replica]:
        """Select a replica for ``r`` (None = shed).  Draining / retired /
        unhealthy replicas never receive new work.  A model-tagged request
        whose pool has no live replica is a counted ``pool_fault`` and is
        shed (None) — every policy degrades to the same deterministic
        shed instead of raising, so a fleet mid-failure (all replicas of
        one model down, not yet respawned) cannot crash the dispatch
        path.  ``NoCompatiblePoolError`` remains exported for callers
        that want to probe pool liveness themselves."""
        alive = [rep for rep in replicas if rep.accepting]
        model = getattr(r, "model", "")
        if model:
            pool = [rep for rep in alive if rep.model == model]
            if not pool:
                self.stats.pool_faults += 1
                self._shed(r)
                return None
        else:
            pool = alive
        if not alive:
            self._shed(r)
            return None
        if self.cfg.model_aware or pool is alive:
            rep = self._select(r, pool, now)
        else:
            # model-blind baseline: rank the whole fleet; a wrong-pool pick
            # is a misroute, bounced into the compatible pool (the caller
            # charges cfg.forward_delay for the extra hop)
            rep = self._select(r, alive, now)
            if rep is not None and rep.model != model:
                self.stats.misroutes += 1
                rep = self._select(r, pool, now)
        if rep is None:
            self._shed(r)
            return None
        self.stats.dispatched += 1
        return rep
