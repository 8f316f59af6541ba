"""Batch schedulers: the paper's SLO-ODBS (Algorithm 1) and its SLO-DBS /
ODBS projections, plus the FIFO and S³-style bin-packing baselines.

Own copy of ``repro/core/scheduler.py``: with ``derive_chunk_tokens`` for
the paged engine's ``--chunk-tokens -1``, the prefix-affinity grouping, and
the speculative-decoding discount the cluster paths price by.
"""
from __future__ import annotations

from dataclasses import dataclass, replace
from typing import Callable, Iterable, Optional

from repro_torch.core.types import Batch, Request


@dataclass
class SchedulerConfig:
    w1: float = 1.0                # weight of the latency/SLO term
    w2: float = 1.0                # weight of the output-length term
    threshold: float = 2.5e4       # composite budget per batch
    l1: float = 1.0                # parallel-overhead factor on T_l (paper Eq.1)
    l2: float = 1.0                # parallel-overhead factor on T_o (paper Eq.2)
    max_batch: int = 64            # hardware cap
    memory_budget: float = 16e9    # KV budget per replica (bytes)
    base_cap: int = 64             # CM-driven dynamic cap baseline (line 20)
    # cache-aware batching (beyond-paper; serving.prefix_cache): group
    # shared-prefix requests into the same batch window so the radix tree
    # serves their hits while the blocks are hot
    prefix_aware: bool = False
    prefix_block: int = 16         # tokens of leading prompt that define a group
    # speculative decoding (beyond-paper; serving.speculative): expected
    # tokens emitted per engine iteration (= spec_speedup(K, acceptance)).
    # The composite's output term counts decode *iterations*, so speculation
    # widens the effective per-batch decode budget by this factor
    spec_speedup: float = 1.0

    def with_speculation(self, spec_tokens: int,
                         acceptance: float) -> "SchedulerConfig":
        """This config re-priced at a (K, acceptance) operating point —
        the one constructor every serve path uses, so the measured-
        acceptance EMA flows into the composite the same way everywhere."""
        return replace(self,
                       spec_speedup=spec_speedup(spec_tokens, acceptance))


def spec_speedup(spec_tokens: int, acceptance: float) -> float:
    """Expected tokens emitted per verify iteration under greedy speculative
    decoding with window K and i.i.d. per-draft acceptance probability a:
    ``E = 1 + a + a^2 + ... + a^K = (1 - a^(K+1)) / (1 - a)`` (the run of
    accepted drafts plus the always-emitted bonus token)."""
    k = max(0, int(spec_tokens))
    a = min(max(float(acceptance), 0.0), 1.0)
    if k == 0:
        return 1.0
    if a >= 1.0:
        return float(k + 1)
    return (1.0 - a ** (k + 1)) / (1.0 - a)


def prefix_affinity_key(requests: list, block: int = 16
                        ) -> Callable[[Request], tuple]:
    """Cache-aware sort key for slo_odbs: requests sharing their first KV
    block sort adjacently (one prefill computes the prefix, the rest hit the
    radix tree), and groups are ordered by their most urgent member's SLO so
    affinity never strands a tight deadline behind a slack group."""
    urgency: dict[tuple, float] = {}
    for r in requests:
        key = tuple(r.tokens[:block])
        urgency[key] = min(urgency.get(key, float("inf")), r.slo)

    def sort_key(r: Request) -> tuple:
        key = tuple(r.tokens[:block])
        return (urgency[key], key, r.slo)
    return sort_key


def _dynamic_cap(cm: float, cfg: SchedulerConfig) -> int:
    """Paper line 20: 'dynamically adjust batch size according to CM'.
    The heavier the current composite metric, the smaller the cap — halving
    per threshold multiple."""
    if cm <= 0:
        return cfg.max_batch
    scale = 1.0 + cm / max(cfg.threshold, 1e-9)
    return max(1, min(cfg.max_batch, int(cfg.base_cap / scale) + 1))


def derive_chunk_tokens(cfg: SchedulerConfig, *, block_size: int = 16,
                        max_chunk_blocks: int = 16) -> int:
    """Per-iteration prefill token budget for the paged engine's chunked
    prefill, derived from the batch-close composite threshold: chunk blocks
    scale with ``threshold / (w1 + w2)`` (1e3 composite units ~ one KV
    block of prefill), clamped to [1, max_chunk_blocks] blocks."""
    w = max(cfg.w1 + cfg.w2, 1e-9)
    blocks = int(cfg.threshold / w / 1e3)
    return block_size * max(1, min(max_chunk_blocks, blocks))


def slo_odbs(requests: Iterable[Request], cfg: SchedulerConfig,
             *, sort_key: Optional[Callable[[Request], float]] = None
             ) -> list[Batch]:
    """Algorithm 1 (SLO and Output-Driven Dynamic Batch Scheduler).  With
    ``cfg.prefix_aware`` (and no explicit sort_key) requests are grouped by
    shared leading prompt block before the SLO-ascending walk, so batches
    pack prefix-cache hits together."""
    reqs = list(requests)
    if sort_key is None and cfg.prefix_aware:
        sort_key = prefix_affinity_key(reqs, cfg.prefix_block)
    reqs = sorted(reqs, key=sort_key or (lambda r: r.slo))
    batches: list[Batch] = []
    cur = Batch()
    l_cm = o_cm = cm = 0.0
    # speculation compresses output length into fewer engine iterations, so
    # the output term is charged in expected *iterations*, not tokens
    sp = max(cfg.spec_speedup, 1.0)
    for q in reqs:
        t_l = (q.slo + l_cm) * (len(cur) + 1) * cfg.l1
        t_o = (q.sched_output_len + o_cm) / sp * (len(cur) + 1) * cfg.l2
        total = cfg.w1 * t_l + cfg.w2 * t_o
        kv_after = sum(r.kv_bytes_estimate for r in cur.requests) + q.kv_bytes_estimate
        cap = _dynamic_cap(cm, cfg)
        if len(cur) == 0 or (total <= cfg.threshold and len(cur) < cap
                             and kv_after <= cfg.memory_budget):
            cur.requests.append(q)
            l_cm = max(l_cm, q.slo)
            o_cm = max(o_cm, q.sched_output_len)
            cm = max(cm, cfg.w1 * q.slo + cfg.w2 * q.sched_output_len / sp)
        else:
            batches.append(cur)
            cur = Batch(requests=[q])
            l_cm, o_cm = q.slo, q.sched_output_len
            cm = cfg.w1 * q.slo + cfg.w2 * q.sched_output_len / sp
    if len(cur):
        batches.append(cur)
    return batches


def slo_dbs(requests, cfg: SchedulerConfig) -> list[Batch]:
    """SLO-focused projection: the composite reduces to the SLO term."""
    return slo_odbs(requests, replace(cfg, w1=1.0, w2=0.0))


def odbs(requests, cfg: SchedulerConfig) -> list[Batch]:
    """Output-driven projection: sort by predicted output length, pack by
    the output term (the S³ insight)."""
    return slo_odbs(requests, replace(cfg, w1=0.0, w2=1.0),
                    sort_key=lambda r: r.sched_output_len)


def fifo(requests, cfg: SchedulerConfig, batch_size: int = 8) -> list[Batch]:
    """Default batching (paper Fig. 3/4 baseline): arrival order, fixed size."""
    reqs = sorted(requests, key=lambda r: r.arrival)
    return [Batch(requests=list(reqs[i:i + batch_size]))
            for i in range(0, len(reqs), batch_size)]


def s3_binpack(requests, cfg: SchedulerConfig) -> list[Batch]:
    """S³-style first-fit-decreasing bin packing on predicted KV memory."""
    reqs = sorted(requests, key=lambda r: r.kv_bytes_estimate, reverse=True)
    bins: list[tuple[float, Batch]] = []
    out: list[Batch] = []
    for q in reqs:
        for i, (used, b) in enumerate(bins):
            if used + q.kv_bytes_estimate <= cfg.memory_budget \
                    and len(b) < cfg.max_batch:
                b.requests.append(q)
                bins[i] = (used + q.kv_bytes_estimate, b)
                break
        else:
            b = Batch(requests=[q])
            bins.append((q.kv_bytes_estimate, b))
            out.append(b)
    return out


SCHEDULERS: dict[str, Callable] = {
    "slo-odbs": slo_odbs,
    "slo-dbs": slo_dbs,
    "odbs": odbs,
    "fifo": fifo,
    "s3": s3_binpack,
}


def get_scheduler(name: str) -> Callable:
    return SCHEDULERS[name]
