"""Log-bucketed latency histograms.

Own copy of ``repro/obs/hist.py``.

The monitor used to keep only sums and last-snapshot gauges, which cannot
answer *where a violated SLO's time went* — a p99 needs a distribution.
``Histogram`` buckets positive values geometrically: bucket ``i`` covers
``[v_min * growth**i, v_min * growth**(i+1))``, so memory is O(occupied
buckets) regardless of sample count and any reported quantile is within a
bounded *relative* error of the true order statistic:

    rel_err <= sqrt(growth) - 1        (~4.5% at the default growth 2**1/8)

because a bucket's representative value is the geometric midpoint of its
edges.  That bound is what the tests gate on; it holds for every quantile,
not just the tails.  Merging is exact (bucket-wise addition), so per-run or
per-replica histograms can be folded into one fleet-wide distribution.
"""
from __future__ import annotations

import math
from dataclasses import dataclass, field

# 2**(1/8): 8 buckets per octave, <= ~4.5% relative quantile error
DEFAULT_GROWTH = 2.0 ** 0.125
# values at or below this collapse into bucket 0 (sub-0.1us latencies are
# measurement noise on every clock this repo uses)
DEFAULT_V_MIN = 1e-7


@dataclass
class Histogram:
    """Sparse log-bucketed histogram of non-negative values (seconds)."""
    growth: float = DEFAULT_GROWTH
    v_min: float = DEFAULT_V_MIN
    counts: dict = field(default_factory=dict)     # bucket index -> count
    n: int = 0
    total: float = 0.0
    min_v: float = float("inf")
    max_v: float = float("-inf")

    def __post_init__(self):
        # cached 1/log(growth): record() sits on the profiler's span hot
        # path, where the repeated log of a constant is measurable
        self._ilg = 1.0 / math.log(self.growth)

    # ------------------------------------------------------------- recording
    def _bucket(self, v: float) -> int:
        if v <= self.v_min:
            return 0
        return 1 + int(math.log(v / self.v_min) * self._ilg)

    def _rep(self, idx: int) -> float:
        """Representative value of a bucket: geometric midpoint of its
        edges (bucket 0 reports v_min itself)."""
        if idx <= 0:
            return self.v_min
        lo = self.v_min * self.growth ** (idx - 1)
        return lo * math.sqrt(self.growth)

    def record(self, v: float) -> None:
        v = float(v)
        if v < 0.0:
            v = 0.0
        # _bucket inlined: this is the profiler's per-span hot path
        idx = 0 if v <= self.v_min \
            else 1 + int(math.log(v / self.v_min) * self._ilg)
        c = self.counts
        c[idx] = c.get(idx, 0) + 1
        self.n += 1
        self.total += v
        if v < self.min_v:
            self.min_v = v
        if v > self.max_v:
            self.max_v = v

    def record_idx(self, idx: int, v: float) -> None:
        """``record()`` for a caller that already bucketed ``v`` (the
        profiler folds one sample into several identically-bucketed
        histograms and computes the log once)."""
        c = self.counts
        c[idx] = c.get(idx, 0) + 1
        self.n += 1
        self.total += v
        if v < self.min_v:
            self.min_v = v
        if v > self.max_v:
            self.max_v = v

    def record_many(self, vs) -> None:
        for v in vs:
            self.record(v)

    def merge(self, other: "Histogram") -> None:
        """Fold another histogram in (exact: bucket-wise addition)."""
        if other.growth != self.growth or other.v_min != self.v_min:
            raise ValueError("histogram merge requires identical bucketing")
        for idx, c in other.counts.items():
            self.counts[idx] = self.counts.get(idx, 0) + c
        self.n += other.n
        self.total += other.total
        self.min_v = min(self.min_v, other.min_v)
        self.max_v = max(self.max_v, other.max_v)

    # ------------------------------------------------------------- reporting
    @property
    def mean(self) -> float:
        return self.total / self.n if self.n else float("nan")

    def quantile(self, q: float) -> float:
        """Value at quantile ``q`` in [0, 1], within the relative error
        bound; the extreme quantiles return the exact observed min/max."""
        if not self.n:
            return float("nan")
        if q <= 0.0:
            return self.min_v
        if q >= 1.0:
            return self.max_v
        rank = q * (self.n - 1)
        seen = 0
        for idx in sorted(self.counts):
            seen += self.counts[idx]
            if seen > rank:
                # clamp into the observed range so a sparsely filled tail
                # bucket cannot report past the true extremes
                return min(max(self._rep(idx), self.min_v), self.max_v)
        return self.max_v

    def summary(self, *, digits: int = 6) -> dict:
        """The quantile block Monitor.metrics() and the metrics-JSON schema
        publish for each latency axis."""
        if not self.n:
            return {"count": 0}
        return {
            "count": self.n,
            "mean": round(self.mean, digits),
            "p50": round(self.quantile(0.50), digits),
            "p95": round(self.quantile(0.95), digits),
            "p99": round(self.quantile(0.99), digits),
            "max": round(self.max_v, digits),
        }

    @property
    def rel_error_bound(self) -> float:
        """Guaranteed worst-case relative quantile error."""
        return math.sqrt(self.growth) - 1.0


class RotatingHistogram:
    """Two-window rotating histogram: a ``Histogram`` with bounded memory.

    A plain ``Histogram`` never forgets, so a replica that was throttled,
    migrated, or re-provisioned keeps averaging new behaviour against its
    entire stale history.  ``RotatingHistogram`` keeps two fixed-capacity
    windows — ``active`` (currently filling) and ``previous`` (the last
    full window) — and reports every statistic over their **exact
    bucket-wise merge**.  When ``active`` reaches ``window`` samples it
    rotates into ``previous`` and a fresh window starts, so:

    * at most ``2 * window`` samples ever influence a quantile, and any
      individual sample's influence is gone after at most ``2 * window``
      subsequent samples;
    * the merged view keeps the plain histogram's ~4.5% relative quantile
      error bound — rotation discards old samples, it never re-buckets.
    """

    def __init__(self, window: int = 256, *, growth: float = DEFAULT_GROWTH,
                 v_min: float = DEFAULT_V_MIN, active: Histogram = None,
                 previous: Histogram = None):
        if window < 1:
            raise ValueError(f"window must be >= 1, got {window}")
        self.window = int(window)
        self.growth = growth
        self.v_min = v_min
        self.active = active if active is not None \
            else Histogram(growth=growth, v_min=v_min)
        self.previous = previous if previous is not None \
            else Histogram(growth=growth, v_min=v_min)

    # ------------------------------------------------------------- recording
    def record(self, v: float) -> None:
        self.active.record(v)
        if self.active.n >= self.window:
            self.previous = self.active
            self.active = Histogram(growth=self.growth, v_min=self.v_min)

    def record_idx(self, idx: int, v: float) -> None:
        a = self.active
        a.record_idx(idx, v)
        if a.n >= self.window:
            self.previous = a
            self.active = Histogram(growth=self.growth, v_min=self.v_min)

    def record_many(self, vs) -> None:
        for v in vs:
            self.record(v)

    # ------------------------------------------------------------- reporting
    def merged(self) -> Histogram:
        """Exact bucket-wise merge of both windows (the retained view all
        statistics report over)."""
        m = Histogram(growth=self.growth, v_min=self.v_min)
        m.merge(self.previous)
        m.merge(self.active)
        return m

    @property
    def n(self) -> int:
        return self.previous.n + self.active.n

    @property
    def total(self) -> float:
        return self.previous.total + self.active.total

    @property
    def mean(self) -> float:
        return self.total / self.n if self.n else float("nan")

    @property
    def min_v(self) -> float:
        return min(self.previous.min_v, self.active.min_v)

    @property
    def max_v(self) -> float:
        return max(self.previous.max_v, self.active.max_v)

    def quantile(self, q: float) -> float:
        return self.merged().quantile(q)

    def summary(self, *, digits: int = 6) -> dict:
        return self.merged().summary(digits=digits)

    @property
    def rel_error_bound(self) -> float:
        return math.sqrt(self.growth) - 1.0
