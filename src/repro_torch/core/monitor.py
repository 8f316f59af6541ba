"""Backend monitor (paper §1/§4): watches finished requests, detects
erroneous length predictions, feeds online-learning updates back to the
predictor, and adapts the profiler's memory-reservation factor (EWMA of
true/predicted).

Own copy of ``repro/core/monitor.py``, trimmed to ``observe`` and
``metrics`` as the single-engine serve path uses them; the paged-pool,
prefix, cluster, drift and fault gauges come with their slices."""
from __future__ import annotations

from dataclasses import dataclass, field

from repro_torch.core.profiler import ResourceProfiler
from repro_torch.core.types import Request
from repro_torch.obs.hist import Histogram


@dataclass
class MonitorStats:
    observed: int = 0
    bucket_hits: int = 0
    overpredict_tokens: int = 0
    underpredict_tokens: int = 0
    online_updates: int = 0
    # (predicted_bucket, true_bucket) -> count
    bucket_confusion: dict = field(default_factory=dict)
    queue_wait: Histogram = field(default_factory=Histogram)
    ttft: Histogram = field(default_factory=Histogram)
    e2e: Histogram = field(default_factory=Histogram)
    slo_observed: int = 0
    slo_violations: int = 0

    @property
    def bucket_accuracy(self) -> float:
        return self.bucket_hits / self.observed if self.observed else 0.0

    @property
    def slo_attainment(self) -> float:
        return 1.0 - self.slo_violations / self.slo_observed \
            if self.slo_observed else 1.0


class Monitor:
    def __init__(self, profiler: ResourceProfiler, *, ewma: float = 0.1,
                 update_on_miss: bool = True):
        self.profiler = profiler
        self.ewma = ewma
        self.update_on_miss = update_on_miss
        self.stats = MonitorStats()

    def observe(self, req: Request) -> None:
        """Called by the serving loop when a request finishes."""
        pred = req.predicted_output_len or 0
        true = req.true_output_len
        st = self.stats
        st.observed += 1
        met = req.slo_met
        if met is not None:
            st.slo_observed += 1
            st.slo_violations += not met
        if req.latency is not None:
            st.e2e.record(req.latency)
        if req.start_time is not None:
            st.queue_wait.record(max(0.0, req.start_time - req.arrival))
        if req.ttft is not None:
            st.ttft.record(req.ttft)
        true_bucket = int(self.profiler.predictor.length_to_bucket([true])[0])
        if req.predicted_bucket is not None:
            key = (int(req.predicted_bucket), true_bucket)
            st.bucket_confusion[key] = st.bucket_confusion.get(key, 0) + 1
        if req.predicted_bucket == true_bucket:
            st.bucket_hits += 1
        elif self.update_on_miss:
            self.profiler.predictor.online_update(req.tokens, true)
            st.online_updates += 1
        if pred >= true:
            st.overpredict_tokens += pred - true
        else:
            st.underpredict_tokens += true - pred
        # adapt memory reservation: under-prediction inflates future estimates
        if pred > 0:
            self.profiler.memory_adjust = (
                (1 - self.ewma) * self.profiler.memory_adjust
                + self.ewma * max(true / pred, 1.0))

    def metrics(self) -> dict:
        st = self.stats
        out = {
            "observed": st.observed,
            "bucket_accuracy": st.bucket_accuracy,
            "online_updates": st.online_updates,
            "over_tokens": st.overpredict_tokens,
            "under_tokens": st.underpredict_tokens,
            "memory_adjust": self.profiler.memory_adjust,
        }
        if st.slo_observed:
            out["slo_observed"] = st.slo_observed
            out["slo_violations"] = st.slo_violations
            out["slo_attainment"] = round(st.slo_attainment, 4)
        if st.bucket_confusion:
            pred_totals: dict[int, int] = {}
            pred_hits: dict[int, int] = {}
            for (p, t), c in st.bucket_confusion.items():
                pred_totals[p] = pred_totals.get(p, 0) + c
                if p == t:
                    pred_hits[p] = pred_hits.get(p, 0) + c
            out["length_prediction"] = {
                "accuracy": round(st.bucket_accuracy, 4),
                "per_bucket_precision": {
                    str(p): round(pred_hits.get(p, 0) / n, 4)
                    for p, n in sorted(pred_totals.items())},
                "confusion": {f"{p}->{t}": c for (p, t), c in
                              sorted(st.bucket_confusion.items())},
            }
        for key, h in (("queue_wait", st.queue_wait), ("ttft", st.ttft),
                       ("e2e", st.e2e)):
            if h.n:
                out[key] = h.summary()
        return out
