"""Backend monitor (paper §1/§4): watches finished requests, detects
erroneous length predictions, feeds online-learning updates back to the
predictor, and adapts the profiler's memory-reservation factor so KV
allocations track reality (EWMA of true/predicted).

Own copy of ``repro/core/monitor.py``, with the engines', simulator's and
cluster's gauges and the cost profiler's calibration-drift counter
(``observe_drift``)."""
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
    # (predicted_bucket, true_bucket) -> count: the length predictor's
    # confusion matrix, from which metrics() derives per-bucket precision —
    # aggregate accuracy hides *which* bucket the predictor bleeds on (and
    # over- vs under-bucket misses cost differently: wasted blocks vs
    # admission optimism)
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
    # --- iteration-level scheduling gauges (chunked prefill + preemption,
    # fed by PagedEngine.run_continuous / simulate_continuous) ---
    prefill_chunks: int = 0        # prefill calls issued (1/prompt unchunked)
    preemptions: int = 0           # residents evicted for tighter arrivals
    preempted_tokens: int = 0      # generated tokens recomputed after evict
    # --- latency histograms (log-bucketed; p50/p95/p99 in metrics()) ---
    # one per lifecycle phase so a violated SLO decomposes by where the
    # time went, not just that it went
    queue_wait: Histogram = field(default_factory=Histogram)
    ttft: Histogram = field(default_factory=Histogram)
    itl: Histogram = field(default_factory=Histogram)       # inter-token
    prefill_stall: Histogram = field(default_factory=Histogram)  # per chunk
    e2e: Histogram = field(default_factory=Histogram)
    # --- SLO accounting (one code path: engines, simulator, cluster) ---
    slo_observed: int = 0          # finished (or shed) requests with a deadline
    slo_violations: int = 0        # missed deadlines, shed requests included
    shed_requests: int = 0         # router admission-shed (never served)
    # segmented SLO counters: key -> [observed, violations].  Keys come from
    # the ``key=`` dimension of observe/observe_shed, or automatically from
    # a request's model/tier tags ("model:<id>" / "tier:<name>") — per-model
    # attainment is first-class in metrics(), not recomputed by benches
    slo_by_key: dict = field(default_factory=dict)
    # --- cluster gauges (accumulated over every snapshot of the run, not
    # last-writer-wins: the peak and mean are what capacity planning reads,
    # and the final sample of a drained cluster is always zeros) ---
    cluster_replicas: int = 0                 # latest accepting-replica count
    cluster_queue_depths: list = field(default_factory=list)   # latest
    cluster_utilizations: list = field(default_factory=list)   # latest
    cluster_snapshots: int = 0
    cluster_queue_peak: int = 0               # max per-replica depth seen
    cluster_queue_mean_sum: float = 0.0       # sum of per-snapshot means
    cluster_util_peak: float = 0.0            # max per-replica busy fraction
    cluster_util_mean_sum: float = 0.0        # sum of per-snapshot means
    scale_up_events: int = 0
    scale_down_events: int = 0
    # --- calibration drift (fed by CostProfiler.monitor hook): band
    # crossings of a replica's observed/predicted phase ratio, attributed
    # per (replica, phase) so the dashboard shows *which* replica's
    # hardware stopped matching its pricing model ---
    profile_drift_events: int = 0
    drift_by_replica: dict = field(default_factory=dict)  # rid -> count
    drift_by_phase: dict = field(default_factory=dict)    # phase -> count
    # --- fault tolerance (fed by the cluster health layer): detected
    # replica failures by kind, retry/re-dispatch activity, and
    # brownout-policy sheds (tier-ordered drops under capacity loss) ---
    replica_failures: int = 0
    failures_by_kind: dict = field(default_factory=dict)  # kind -> count
    request_retries: int = 0       # lost requests re-dispatched
    retries_exhausted: int = 0     # retry budget spent -> counted as shed
    retries_deduped: int = 0       # late finish beat the pending retry
    brownout_sheds: int = 0        # requests dropped by brownout policy

    @property
    def bucket_accuracy(self) -> float:
        return self.bucket_hits / self.observed if self.observed else 0.0

    @property
    def slo_attainment(self) -> float:
        """Fraction of deadline-carrying requests served within their SLO."""
        return 1.0 - self.slo_violations / self.slo_observed \
            if self.slo_observed else 1.0

    @property
    def kv_utilization(self) -> float:
        """Mean valid-token / allocated-block-slot ratio of the paged pool."""
        return self.kv_util_sum / self.kv_samples if self.kv_samples else 0.0

    @property
    def kv_waste_vs_padded(self) -> float:
        """Mean memory saved vs per-slot max-length reservation (the padding
        regime the paper's Fig. 3 counts tokens for)."""
        return self.kv_waste_sum / self.kv_samples if self.kv_samples else 0.0

    @property
    def prefix_hit_rate(self) -> float:
        """Fraction of prompts that reused at least one cached block."""
        return self.prefix_hits / self.prefix_lookups \
            if self.prefix_lookups else 0.0

    @property
    def prefill_stall_s(self) -> float:
        """Total prefill time co-resident decoders sat out (the histogram's
        sum — kept as a property so the old scalar key survives)."""
        return self.prefill_stall.total

    @property
    def cluster_queue_mean(self) -> float:
        """Mean (over snapshots) of the mean per-replica queue depth."""
        return self.cluster_queue_mean_sum / self.cluster_snapshots \
            if self.cluster_snapshots else 0.0

    @property
    def cluster_util_mean(self) -> float:
        """Mean (over snapshots) of the mean per-replica busy fraction."""
        return self.cluster_util_mean_sum / self.cluster_snapshots \
            if self.cluster_snapshots else 0.0


class Monitor:
    def __init__(self, profiler: ResourceProfiler, *, ewma: float = 0.1,
                 update_on_miss: bool = True):
        self.profiler = profiler
        self.ewma = ewma
        self.update_on_miss = update_on_miss
        self.stats = MonitorStats()

    @staticmethod
    def _slo_keys(req: Request, key) -> list:
        """Segmentation keys for SLO counters: an explicit ``key`` (a
        string or an iterable of strings) wins; otherwise the request's
        model/tier tags segment automatically."""
        if key is not None:
            return [key] if isinstance(key, str) else list(key)
        keys = []
        m = getattr(req, "model", "")
        if m:
            keys.append(f"model:{m}")
        tr = getattr(req, "tier", "")
        if tr:
            keys.append(f"tier:{tr}")
        return keys

    def _slo_segment(self, req: Request, key, violated: bool) -> None:
        for k in self._slo_keys(req, key):
            cell = self.stats.slo_by_key.setdefault(k, [0, 0])
            cell[0] += 1
            cell[1] += bool(violated)

    def observe(self, req: Request, key=None) -> None:
        """Called by the engine/simulator when a request finishes.  ``key``
        optionally segments the SLO counters (model, tier, ...); without it
        a tagged request segments by its own model/tier."""
        pred = req.predicted_output_len or 0
        true = req.true_output_len
        st = self.stats
        st.observed += 1
        met = req.slo_met
        if met is not None:
            st.slo_observed += 1
            st.slo_violations += not met
            self._slo_segment(req, key, not met)
        # latency histograms: prefer the serving path's per-phase breakdown
        # (obs.trace.LatencyBreakdown); fall back to the request stamps
        lat = req.latency
        if lat is not None:
            st.e2e.record(lat)
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
            ratio = true / pred
            self.profiler.memory_adjust = (
                (1 - self.ewma) * self.profiler.memory_adjust
                + self.ewma * max(ratio, 1.0))

    def observe_kv(self, utilization: float, waste_vs_padded: float) -> None:
        """Called by the paged serving runtime with its pool gauges so KV
        efficiency lands next to the prediction-quality feedback loop."""
        st = self.stats
        st.kv_samples += 1
        st.kv_util_sum += utilization
        st.kv_waste_sum += waste_vs_padded

    def observe_pool(self, pool_stats: dict, *,
                     fragmentation: float = 0.0) -> None:
        """Latest ``BlockAllocator.stats()`` snapshot (free/used/cached
        block counts) plus the engine's internal-fragmentation gauge
        (allocated-but-invalid token slots)."""
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
        """Iteration-level scheduling gauges from a serving run: decode
        stall time imposed by prefill work, chunk count, and SLO-slack
        preemption activity (evictions + recomputed tokens).  ``stalls``
        carries per-chunk stall durations and ``itl`` per-emission
        inter-token gaps; both land in the latency histograms (a producer
        without per-sample data may still pass the ``stall_s`` aggregate,
        recorded as one sample)."""
        st = self.stats
        st.prefill_chunks += chunks
        st.preemptions += preemptions
        st.preempted_tokens += preempted_tokens
        if len(stalls):
            st.prefill_stall.record_many(stalls)
        elif stall_s > 0:
            st.prefill_stall.record(stall_s)
        st.itl.record_many(itl)

    def observe_shed(self, req: Request, key=None) -> None:
        """A request the router refused (no replica could meet its SLO):
        counted as an SLO violation — shedding is not a free pass."""
        st = self.stats
        st.shed_requests += 1
        st.slo_observed += 1
        st.slo_violations += 1
        self._slo_segment(req, key, True)

    def observe_drift(self, replica: int, phase: str) -> None:
        """One calibration-drift band crossing, attributed to the replica
        and phase it fired on (``CostProfiler`` calls this when its
        ``monitor`` hook is set)."""
        st = self.stats
        st.profile_drift_events += 1
        st.drift_by_replica[replica] = st.drift_by_replica.get(replica, 0) + 1
        st.drift_by_phase[phase] = st.drift_by_phase.get(phase, 0) + 1

    def observe_failure(self, replica: int, kind: str) -> None:
        """The health layer detected a replica failure (``kind`` is the
        injected/diagnosed class: crash, partition, straggler, ...)."""
        st = self.stats
        st.replica_failures += 1
        st.failures_by_kind[kind] = st.failures_by_kind.get(kind, 0) + 1

    def observe_retry(self, *, exhausted: bool = False,
                      deduped: bool = False) -> None:
        """Retry accounting for a request lost to a failure: a re-dispatch,
        a spent budget (the request is shed — ``observe_shed`` is called
        separately so SLO math stays in one place), or a dedup (the
        partitioned replica's late finish landed first)."""
        st = self.stats
        if exhausted:
            st.retries_exhausted += 1
        elif deduped:
            st.retries_deduped += 1
        else:
            st.request_retries += 1

    def observe_brownout(self) -> None:
        """One request dropped by the brownout policy (tier-ordered
        shedding under detected capacity loss)."""
        self.stats.brownout_sheds += 1

    def observe_scale(self, direction: int, n: int = 1) -> None:
        """Autoscaler event: ``direction`` > 0 adds replicas, < 0 drains."""
        if direction > 0:
            self.stats.scale_up_events += n
        elif direction < 0:
            self.stats.scale_down_events += n

    def observe_replicas(self, queue_depths: list, utilizations: list) -> None:
        """One cluster snapshot: a queue depth / busy-fraction gauge per
        accepting replica.  Keeps the latest sample *and* accumulates the
        run's peak and mean — the final snapshot of a drained cluster is
        always zeros, so last-writer-wins gauges understated every run."""
        st = self.stats
        st.cluster_replicas = len(queue_depths)
        st.cluster_queue_depths = list(queue_depths)
        st.cluster_utilizations = [round(u, 4) for u in utilizations]
        st.cluster_snapshots += 1
        if queue_depths:
            st.cluster_queue_peak = max(st.cluster_queue_peak,
                                        max(queue_depths))
            st.cluster_queue_mean_sum += \
                sum(queue_depths) / len(queue_depths)
        if utilizations:
            st.cluster_util_peak = max(st.cluster_util_peak,
                                       max(utilizations))
            st.cluster_util_mean_sum += \
                sum(utilizations) / len(utilizations)

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
            out["shed_requests"] = st.shed_requests
        if st.slo_by_key:
            out["slo_by_key"] = {
                k: {"observed": o, "violations": v,
                    "attainment": round(1.0 - v / o, 4) if o else 1.0}
                for k, (o, v) in sorted(st.slo_by_key.items())}
        if st.cluster_snapshots or st.cluster_replicas:
            out["cluster_replicas"] = st.cluster_replicas
            out["cluster_queue_depths"] = st.cluster_queue_depths
            out["cluster_utilizations"] = st.cluster_utilizations
            out["cluster_queue_peak"] = st.cluster_queue_peak
            out["cluster_queue_mean"] = round(st.cluster_queue_mean, 4)
            out["cluster_util_peak"] = round(st.cluster_util_peak, 4)
            out["cluster_util_mean"] = round(st.cluster_util_mean, 4)
            out["scale_up_events"] = st.scale_up_events
            out["scale_down_events"] = st.scale_down_events
        if st.profile_drift_events:
            out["profile_drift"] = {
                "events": st.profile_drift_events,
                "by_replica": {str(r): c for r, c in
                               sorted(st.drift_by_replica.items())},
                "by_phase": dict(sorted(st.drift_by_phase.items())),
            }
        if st.replica_failures or st.request_retries or st.retries_exhausted \
                or st.brownout_sheds:
            out["faults"] = {
                "replica_failures": st.replica_failures,
                "by_kind": dict(sorted(st.failures_by_kind.items())),
                "retries": st.request_retries,
                "retries_exhausted": st.retries_exhausted,
                "retries_deduped": st.retries_deduped,
                "brownout_sheds": st.brownout_sheds,
            }
        if st.bucket_confusion:
            # per-bucket precision: of requests *predicted* into bucket b,
            # the fraction whose true length landed there too
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
        # per-phase latency quantiles (log-bucketed, <=4.5% relative error)
        for key, h in (("queue_wait", st.queue_wait), ("ttft", st.ttft),
                       ("itl", st.itl), ("e2e", st.e2e),
                       ("prefill_stall", st.prefill_stall)):
            if h.n:
                out[key] = h.summary()
        return out
