"""Log-bucketed latency histograms.

Own copy of ``Histogram`` from ``repro/obs/hist.py`` (the rotating variant
belongs to the profile slice).  Bucket ``i`` covers
``[v_min * growth**i, v_min * growth**(i+1))``, so memory is O(occupied
buckets) and any reported quantile is within ``sqrt(growth) - 1`` relative
error of the true order statistic (~4.5% at the default growth 2**1/8).
"""
from __future__ import annotations

import math
from dataclasses import dataclass, field

DEFAULT_GROWTH = 2.0 ** 0.125
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

    def _rep(self, idx: int) -> float:
        """Representative value of a bucket: geometric midpoint of its edges."""
        if idx <= 0:
            return self.v_min
        lo = self.v_min * self.growth ** (idx - 1)
        return lo * math.sqrt(self.growth)

    def record(self, v: float) -> None:
        v = max(float(v), 0.0)
        idx = 0 if v <= self.v_min \
            else 1 + int(math.log(v / self.v_min) * (1.0 / math.log(self.growth)))
        self.counts[idx] = self.counts.get(idx, 0) + 1
        self.n += 1
        self.total += v
        self.min_v = min(self.min_v, v)
        self.max_v = max(self.max_v, v)

    def record_many(self, vs) -> None:
        for v in vs:
            self.record(v)

    @property
    def mean(self) -> float:
        return self.total / self.n if self.n else float("nan")

    def quantile(self, q: float) -> float:
        """Value at quantile ``q`` in [0, 1]; the extremes are exact."""
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
                return min(max(self._rep(idx), self.min_v), self.max_v)
        return self.max_v

    def summary(self, *, digits: int = 6) -> dict:
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
