"""Batch schedulers: the paper's SLO-ODBS (Algorithm 1) and its SLO-DBS /
ODBS projections, plus the FIFO and S³-style bin-packing baselines.

Own copy of ``repro/core/scheduler.py`` for the single-engine serve paths,
with ``derive_chunk_tokens`` for the paged engine's ``--chunk-tokens -1``.
The prefix-affinity grouping and the speculative-decoding discount feed only
the cluster paths and are left out, so every config here behaves like the
reference's default (``prefix_aware=False``, ``spec_speedup=1``).
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
    """Algorithm 1 (SLO and Output-Driven Dynamic Batch Scheduler)."""
    reqs = sorted(requests, key=sort_key or (lambda r: r.slo))
    batches: list[Batch] = []
    cur = Batch()
    l_cm = o_cm = cm = 0.0
    for q in reqs:
        t_l = (q.slo + l_cm) * (len(cur) + 1) * cfg.l1
        t_o = (q.sched_output_len + o_cm) * (len(cur) + 1) * cfg.l2
        total = cfg.w1 * t_l + cfg.w2 * t_o
        kv_after = sum(r.kv_bytes_estimate for r in cur.requests) + q.kv_bytes_estimate
        cap = _dynamic_cap(cm, cfg)
        if len(cur) == 0 or (total <= cfg.threshold and len(cur) < cap
                             and kv_after <= cfg.memory_budget):
            cur.requests.append(q)
            l_cm = max(l_cm, q.slo)
            o_cm = max(o_cm, q.sched_output_len)
            cm = max(cm, cfg.w1 * q.slo + cfg.w2 * q.sched_output_len)
        else:
            batches.append(cur)
            cur = Batch(requests=[q])
            l_cm, o_cm = q.slo, q.sched_output_len
            cm = cfg.w1 * q.slo + cfg.w2 * q.sched_output_len
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
