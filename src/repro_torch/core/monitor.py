"""Backend monitor (paper §1/§4): watches finished requests, detects
erroneous length predictions, feeds online-learning updates back to the
predictor, and adapts the profiler's memory-reservation factor (EWMA of
true/predicted).

Own copy of ``repro/core/monitor.py``, trimmed to what the single-engine
serve paths feed: ``observe`` and ``metrics``, and the paged engine's KV,
pool, prefix and interleave gauges; the cluster, drift and fault gauges come
with their slices."""
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
    # --- paged-KV gauges (fed by PagedEngine.run_continuous) ---
    kv_samples: int = 0
    kv_util_sum: float = 0.0
    kv_waste_sum: float = 0.0
    # --- block-pool gauges (latest BlockAllocator.stats() snapshot) ---
    pool_total_blocks: int = 0
    pool_free_blocks: int = 0
    pool_used_blocks: int = 0
    pool_cached_blocks: int = 0
    pool_fragmentation: float = 0.0   # 1 - valid tokens / allocated slots
    # --- prefix-cache counters (serving.prefix_cache.PrefixCacheStats) ---
    prefix_lookups: int = 0
    prefix_hits: int = 0
    prefix_hit_tokens: int = 0
    prefix_hit_blocks: int = 0
    prefix_evicted_blocks: int = 0
    prefix_cow_forks: int = 0
    # --- iteration-level scheduling (chunked prefill + preemption) ---
    prefill_chunks: int = 0
    preemptions: int = 0
    preempted_tokens: int = 0
    queue_wait: Histogram = field(default_factory=Histogram)
    ttft: Histogram = field(default_factory=Histogram)
    itl: Histogram = field(default_factory=Histogram)       # inter-token
    prefill_stall: Histogram = field(default_factory=Histogram)  # per chunk
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

    @property
    def kv_utilization(self) -> float:
        """Mean valid-token / allocated-block-slot ratio of the paged pool."""
        return self.kv_util_sum / self.kv_samples if self.kv_samples else 0.0

    @property
    def kv_waste_vs_padded(self) -> float:
        """Mean memory saved vs per-slot max-length reservation."""
        return self.kv_waste_sum / self.kv_samples if self.kv_samples else 0.0

    @property
    def prefix_hit_rate(self) -> float:
        """Fraction of prompts that reused at least one cached block."""
        return self.prefix_hits / self.prefix_lookups \
            if self.prefix_lookups else 0.0

    @property
    def prefill_stall_s(self) -> float:
        """Total prefill time co-resident decoders sat out."""
        return self.prefill_stall.total


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
        # prefer the paged engine's per-phase breakdown; fall back to the
        # request stamps
        bd = req.breakdown
        if bd is not None:
            st.queue_wait.record(bd.queue_wait_s)
            if bd.ttft_s > 0 or req.first_token_time is not None:
                st.ttft.record(bd.ttft_s)
        else:
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

    def observe_kv(self, utilization: float, waste_vs_padded: float) -> None:
        """The paged engine's pool gauges, so KV efficiency lands next to the
        prediction-quality feedback loop."""
        st = self.stats
        st.kv_samples += 1
        st.kv_util_sum += utilization
        st.kv_waste_sum += waste_vs_padded

    def observe_pool(self, pool_stats: dict, *,
                     fragmentation: float = 0.0) -> None:
        """Latest ``BlockAllocator.stats()`` snapshot plus the engine's
        internal-fragmentation gauge (allocated-but-invalid token slots)."""
        st = self.stats
        st.pool_total_blocks = pool_stats.get("total", 0)
        st.pool_free_blocks = pool_stats.get("free", 0)
        st.pool_used_blocks = pool_stats.get("used", 0)
        st.pool_cached_blocks = pool_stats.get("cached", 0)
        st.pool_fragmentation = fragmentation

    def observe_prefix(self, prefix_stats, *, cow_forks: int = 0) -> None:
        """Accumulate a run's prefix-cache counters
        (serving.prefix_cache.PrefixCacheStats)."""
        st = self.stats
        st.prefix_lookups += prefix_stats.lookups
        st.prefix_hits += prefix_stats.hits
        st.prefix_hit_tokens += prefix_stats.hit_tokens
        st.prefix_hit_blocks += prefix_stats.hit_blocks
        st.prefix_evicted_blocks += prefix_stats.evicted_blocks
        st.prefix_cow_forks += cow_forks

    def observe_interleave(self, *, stall_s: float = 0.0, chunks: int = 0,
                           preemptions: int = 0,
                           preempted_tokens: int = 0,
                           stalls=(), itl=()) -> None:
        """Iteration-level scheduling gauges of a serving run: decode stall
        imposed by prefill (per-chunk ``stalls``, else the ``stall_s``
        aggregate as one sample), chunk count, preemptions, and the
        per-emission inter-token gaps ``itl``."""
        st = self.stats
        st.prefill_chunks += chunks
        st.preemptions += preemptions
        st.preempted_tokens += preempted_tokens
        if len(stalls):
            st.prefill_stall.record_many(stalls)
        elif stall_s > 0:
            st.prefill_stall.record(stall_s)
        st.itl.record_many(itl)

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
        if st.kv_samples:
            out["kv_utilization"] = round(st.kv_utilization, 4)
            out["kv_waste_vs_padded"] = round(st.kv_waste_vs_padded, 4)
        if st.pool_total_blocks:
            out["pool_free_blocks"] = st.pool_free_blocks
            out["pool_used_blocks"] = st.pool_used_blocks
            out["pool_cached_blocks"] = st.pool_cached_blocks
            out["pool_fragmentation"] = round(st.pool_fragmentation, 4)
        if st.prefix_lookups:
            out["prefix_hit_rate"] = round(st.prefix_hit_rate, 4)
            out["prefix_hit_tokens"] = st.prefix_hit_tokens
            out["prefix_evicted_blocks"] = st.prefix_evicted_blocks
            out["prefix_cow_forks"] = st.prefix_cow_forks
        if st.prefill_chunks:
            out["prefill_chunks"] = st.prefill_chunks
            out["prefill_stall_s"] = round(st.prefill_stall_s, 4)
        if st.preemptions:
            out["preemptions"] = st.preemptions
            out["preempted_tokens"] = st.preempted_tokens
        if st.slo_observed:
            out["slo_observed"] = st.slo_observed
            out["slo_violations"] = st.slo_violations
            out["slo_attainment"] = round(st.slo_attainment, 4)
            out["shed_requests"] = 0       # the port has no router to shed
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
                       ("itl", st.itl), ("e2e", st.e2e),
                       ("prefill_stall", st.prefill_stall)):
            if h.n:
                out[key] = h.summary()
        return out
