"""Discrete-event cluster simulator.

Reproduces the paper's evaluation environment (§5.1): a 4-GPU heterogeneous
cluster (Table 2 power caps -> per-device performance scalars; PIX/NODE link
latencies), ChatGLM2-6B, Poisson request loads with random SLOs in [1, 350] s.
The latency model derives per-iteration times from the analytic cost model
(repro_torch.perf.cost_model) applied to the deployer's DeviceMap: pipeline
stage compute + link latency per token (sequential execution — the paper's
Observation #1), so deployment quality and batching quality interact exactly
as in the paper.

Semantics of padded batching (§4.2 / Fig. 3): a batch prefills together at
max input length and decodes for max-true-output iterations; each request's
*answer* completes at its own EOS, but the replica stays busy until the batch
drains.  GPU utilization = useful token work / (peak work available over the
makespan) — the simulator's analogue of nvidia-smi utilization.

Own copy of ``repro/serving/simulator.py``: host code on numpy, with every
name, default and order of floating-point operations of the reference, so
a seed gives the same summaries; it deploys through the port's HELR and
prices through the port's ``ModelConfig``.  The simulator's only device work
is the resource profiler's length predictor.
"""
from __future__ import annotations

import copy
import heapq
import inspect
import warnings
from dataclasses import dataclass, field
from typing import Callable, Optional, Sequence

import numpy as np

from repro_torch.configs.base import ModelConfig
from repro_torch.core.deployer import HELRConfig, bgs, helr
from repro_torch.core.monitor import Monitor
from repro_torch.core.profiler import ResourceProfiler
from repro_torch.core.scheduler import SchedulerConfig
from repro_torch.core.types import Batch, DeviceMap, DeviceNode, Request
from repro_torch.obs.trace import (NULL_TRACER, ROW_QUEUE, LatencyBreakdown,
                                   Tracer, slot_row)


# ------------------------------------------------------ paper's cluster (T2)

def paper_cluster() -> tuple[list[DeviceNode], list[list[float]]]:
    """4 GPUs with Table-2 power caps scaled to effective TFLOP/s, and the
    PIX/NODE topology."""
    perf = [35e12, 30e12, 25e12, 15e12]     # 350W/300W/250W/150W caps
    nodes = [DeviceNode(i, memory=24e9, performance=perf[i], name=f"GPU#{i}")
             for i in range(4)]
    pix, node = 5e-5, 2e-4                  # per-token link latencies (s)
    lat = [[0.0, pix, node, node],
           [pix, 0.0, node, node],
           [node, node, 0.0, pix],
           [node, node, pix, 0.0]]
    return nodes, lat


# ------------------------------------------------------------- latency model

@dataclass
class LatencyModel:
    """Roofline iteration times for a model deployed per DeviceMap.

    Decode stages are max(compute, HBM) bound: the weight read is
    batch-independent, so batching is nearly free until the compute term
    crosses it — the physics behind the paper's Observation #2 (batching
    raises token rate because weights are shared)."""
    cfg: ModelConfig
    nodes: list[DeviceNode]
    latency: list[list[float]]
    dmap: DeviceMap
    efficiency: float = 0.45          # fraction of peak a real kernel hits
    hbm_bw: float = 900e9             # bytes/s (RTX3090-class)

    def _stage_flops_token(self, layers: int, kv: int) -> float:
        c = self.cfg
        per_layer = 2.0 * (c._attn_params() + c._mlp_params(c.d_ff))
        attn = 4.0 * kv * c.n_heads * c.head_dim_eff
        return layers * (per_layer + attn)

    def _stage_bytes(self, layers: int, batch: int, kv: int) -> float:
        c = self.cfg
        per_layer_w = 2.0 * (c._attn_params() + c._mlp_params(c.d_ff))
        kv_bytes = 2.0 * 2.0 * kv * c.n_kv_heads * c.head_dim_eff * batch
        return layers * (per_layer_w + kv_bytes)

    def _active_path(self) -> list:
        """Cached [(device, layers)] of occupied pipeline stages: the
        online profiler prices a reference prediction per measured span,
        so token_time/prefill_time are on a hot path and must not rebuild
        this list per call.  DeviceMaps are never mutated after deploy."""
        p = self.__dict__.get("_path_cache")
        if p is None:
            p = [(d, self.dmap.layers[d]) for d in self.dmap.path
                 if self.dmap.layers.get(d, 0) > 0]
            self.__dict__["_path_cache"] = p
        return p

    def token_time(self, batch: int, kv: int, q_tokens: int = 1) -> float:
        """One decode iteration for the whole batch (pipeline stages execute
        sequentially per token — paper Observation #1).  ``q_tokens > 1``
        prices a speculative *verify* iteration: the window's query
        positions multiply the compute term but share one weight/cache HBM
        sweep — exactly why collapsing K decode steps into one verify pass
        wins on the memory-bound decode roofline."""
        t = 0.0
        path = self._active_path()
        for idx, (dev, nl) in enumerate(path):
            t_comp = self._stage_flops_token(nl, kv) * batch * q_tokens \
                / (self.nodes[dev].performance * self.efficiency)
            t_mem = self._stage_bytes(nl, batch, kv) / self.hbm_bw
            t += max(t_comp, t_mem)
            if idx + 1 < len(path):
                t += self.latency[dev][path[idx + 1][0]]
        return t

    def prefill_time(self, batch: int, in_len: int) -> float:
        t = 0.0
        path = self._active_path()
        for idx, (dev, nl) in enumerate(path):
            fl = self._stage_flops_token(nl, in_len / 2) * batch * in_len
            t_comp = fl / (self.nodes[dev].performance * self.efficiency)
            t_mem = self._stage_bytes(nl, batch, in_len) / self.hbm_bw
            t += max(t_comp, t_mem)
            if idx + 1 < len(path):
                t += self.latency[dev][path[idx + 1][0]]
        return t

    @property
    def peak_flops(self) -> float:
        return sum(self.nodes[d].performance for d in self.dmap.path
                   if self.dmap.layers.get(d, 0) > 0)


# ---------------------------------------------------------------- simulation

@dataclass
class SimResult:
    requests: list[Request]
    makespan: float
    useful_flops: float
    busy_flops_capacity: float
    deploy_overhead: float = 0.0
    batch_count: int = 0
    total_padded_tokens: int = 0
    total_true_tokens: int = 0
    # --- paged-KV accounting (kv_block_size-granular alternative to the
    # padded per-batch reservation that total_padded_tokens measures) ---
    kv_block_size: int = 16
    paged_kv_blocks: int = 0       # sum of ceil(seq_len / block) per request
    total_seq_tokens: int = 0      # sum of input + true output per request
    # --- prefix-cache accounting (simulate(prefix_cache=True): a radix
    # block tree over prompt chains discounts prefill work per hit) ---
    prefill_tokens_saved: int = 0  # prompt tokens served from cached blocks
    prefix_hit_requests: int = 0   # requests matching >= 1 cached block

    @property
    def avg_latency(self) -> float:
        ls = [r.latency for r in self.requests if r.latency is not None]
        return float(np.mean(ls)) if ls else float("nan")

    @property
    def p99_latency(self) -> float:
        ls = [r.latency for r in self.requests if r.latency is not None]
        return float(np.percentile(ls, 99)) if ls else float("nan")

    @property
    def slo_violation_rate(self) -> float:
        met = [r.slo_met for r in self.requests if r.slo_met is not None]
        return 1.0 - float(np.mean(met)) if met else float("nan")

    @property
    def throughput(self) -> float:
        """tokens/s over the serving window (paper metric 2)."""
        return self.total_true_tokens / self.makespan if self.makespan else 0.0

    @property
    def gpu_util(self) -> float:
        return self.useful_flops / self.busy_flops_capacity \
            if self.busy_flops_capacity else 0.0

    @property
    def paged_kv_tokens(self) -> int:
        """KV slots a paged allocator holds for the same work."""
        return self.paged_kv_blocks * self.kv_block_size

    @property
    def paged_kv_util(self) -> float:
        """Valid tokens / allocated paged slots (block-rounding overhead)."""
        return self.total_seq_tokens / self.paged_kv_tokens \
            if self.paged_kv_tokens else 1.0

    @property
    def waste_vs_padded(self) -> float:
        """KV memory a paged pool saves vs the padded per-batch reservation
        (Fig-4/5 style paged-vs-padded comparison axis)."""
        return 1.0 - self.paged_kv_tokens / self.total_padded_tokens \
            if self.total_padded_tokens else 0.0

    @property
    def prefill_saved_frac(self) -> float:
        """Fraction of prompt tokens whose prefill the prefix cache skipped."""
        total_in = sum(r.input_len for r in self.requests)
        return self.prefill_tokens_saved / total_in if total_in else 0.0

    def summary(self) -> dict:
        return {
            "avg_latency_s": round(self.avg_latency, 3),
            "p99_latency_s": round(self.p99_latency, 3),
            "slo_violation": round(self.slo_violation_rate, 4),
            "throughput_tok_s": round(self.throughput, 2),
            "gpu_util": round(self.gpu_util, 4),
            "batches": self.batch_count,
            "padded_tokens": self.total_padded_tokens,
            "true_tokens": self.total_true_tokens,
            "paged_kv_tokens": self.paged_kv_tokens,
            "paged_kv_util": round(self.paged_kv_util, 4),
            "waste_vs_padded": round(self.waste_vs_padded, 4),
            "prefill_tokens_saved": self.prefill_tokens_saved,
            "prefill_saved_frac": round(self.prefill_saved_frac, 4),
        }


def simulate(
    requests: list[Request],
    model_cfg: ModelConfig,
    scheduler: Callable[[list[Request], SchedulerConfig], list[Batch]],
    sched_cfg: SchedulerConfig,
    *,
    profiler: Optional[ResourceProfiler] = None,
    monitor: Optional[Monitor] = None,
    deploy: Callable = helr,
    deploy_overhead: float = 0.0,
    nodes=None, latency=None,
    model_mem: Optional[float] = None,
    window: float = 10.0,
    kv_block_size: int = 16,
    prefix_cache: bool = False,
) -> SimResult:
    """Event loop: requests arrive; every scheduling window (or whenever the
    replica goes idle) the pending pool is profiled and batched; batches run
    sequentially on the deployed pipeline (single replica, like the paper's
    testbed).

    ``prefix_cache=True`` models the serving runtime's radix-tree prefix
    cache (serving.prefix_cache): each request's prompt is matched against
    the block tree of previously served prompts, hit tokens skip prefill
    (the batch's prefill time is charged on its longest *uncached* prompt),
    and ``SimResult.prefill_tokens_saved`` accumulates the discount."""
    if nodes is None:
        nodes, latency = paper_cluster()
    model_mem = model_mem or model_cfg.param_count() * 2.0
    dmap = deploy(model_mem, model_cfg.n_layers, nodes, latency)
    if not dmap.path:
        raise RuntimeError("deployment infeasible")
    lm = LatencyModel(model_cfg, nodes, latency, dmap)

    reqs = sorted(requests, key=lambda r: r.arrival)
    t = deploy_overhead
    i = 0
    pending: list[Request] = []
    useful = 0.0
    busy_time = 0.0
    batches_run = 0
    padded_total = 0
    true_total = 0
    paged_blocks = 0
    seq_tokens = 0
    saved_tokens = 0
    hit_requests = 0
    prefix_tree = None
    if prefix_cache:
        from repro_torch.serving.prefix_cache import RadixBlockTree
        prefix_tree = RadixBlockTree(kv_block_size)

    while i < len(reqs) or pending:
        # admit everything that has arrived by t (plus wait if idle)
        while i < len(reqs) and reqs[i].arrival <= t:
            pending.append(reqs[i])
            i += 1
        if not pending:
            t = max(t, reqs[i].arrival)
            continue
        if profiler is not None:
            profiler.profile(pending)
        else:
            for r in pending:
                r.predicted_output_len = r.true_output_len   # oracle fallback
        batches = scheduler(pending, sched_cfg)
        # event-driven: run only the FIRST batch, then re-admit arrivals and
        # re-schedule the remainder — a real serving loop reconsiders the
        # queue every time the replica frees up
        b = next((b_ for b_ in batches if b_.requests), None)
        pending = [r for b_ in batches for r in b_.requests
                   if b is None or r not in b.requests]
        if b is None:
            continue
        in_len = b.padded_input
        n = len(b)
        pre_len = in_len
        if prefix_tree is not None:
            # hit tokens skip prefill; the batch pads to its longest
            # *uncached* prompt.  Prompts are matched-then-inserted one at a
            # time, mirroring PagedEngine's sequential per-prompt prefill
            # (which publishes at prefill) — same-batch siblings of a shared
            # template therefore hit, exactly as in the live engine
            net = []
            for r in b.requests:
                hit = prefix_tree.match(r.tokens).hit_tokens
                saved_tokens += hit
                hit_requests += hit > 0
                net.append(r.input_len - hit)
                prefix_tree.insert(r.tokens)
            pre_len = max(net)
        t_pre = lm.prefill_time(n, pre_len)
        t_cursor = t + t_pre
        remaining = sorted(b.requests, key=lambda r: r.true_output_len)
        kv = in_len
        step_start = 0
        for r in remaining:
            steps = r.true_output_len - step_start
            if steps > 0:
                tt = lm.token_time(n, kv + step_start + steps / 2)
                t_cursor += steps * tt
                step_start = r.true_output_len
            r.start_time = t
            r.first_token_time = t + t_pre
            r.finish_time = t_cursor
            if monitor is not None:
                monitor.observe(r)
        busy_time += t_cursor - t
        useful += sum(lm._stage_flops_token(model_cfg.n_layers,
                                            in_len / 2 + r.true_output_len / 2)
                      * (r.input_len + r.true_output_len)
                      for r in b.requests)
        padded_total += b.total_tokens
        true_total += sum(r.true_output_len for r in b.requests)
        paged_blocks += sum(
            -(-(r.input_len + r.true_output_len) // kv_block_size)
            for r in b.requests)
        seq_tokens += sum(r.input_len + r.true_output_len for r in b.requests)
        batches_run += 1
        t = t_cursor

    return SimResult(
        requests=reqs, makespan=t, useful_flops=useful,
        busy_flops_capacity=lm.peak_flops * lm.efficiency * max(t, 1e-9),
        deploy_overhead=deploy_overhead, batch_count=batches_run,
        total_padded_tokens=padded_total, total_true_tokens=true_total,
        kv_block_size=kv_block_size, paged_kv_blocks=paged_blocks,
        total_seq_tokens=seq_tokens, prefill_tokens_saved=saved_tokens,
        prefix_hit_requests=hit_requests)


# ------------------------------------- iteration-level (continuous) serving

@dataclass
class ContinuousSimResult:
    """Outcome of an iteration-level continuous-batching simulation — the
    model of ``PagedEngine.run_continuous``'s interleaved loop, where the
    decode-stall/chunking/preemption trade-offs live (a padded-batch run is
    ``simulate``'s job)."""
    requests: list[Request]
    makespan: float
    steps: int = 0
    prefill_chunks: int = 0
    inter_token_s: list = field(default_factory=list)
    prefill_stall_s: float = 0.0   # prefill time co-resident decoders sat out
    preemptions: int = 0
    preempted_tokens: int = 0      # generated tokens recomputed after evict
    emitted_tokens: int = 0        # decode emissions (speculation: > steps)

    @property
    def p99_inter_token_s(self) -> float:
        if not self.inter_token_s:
            return float("nan")
        return float(np.percentile(self.inter_token_s, 99))

    @property
    def iterations_per_token(self) -> float:
        """Engine iterations per emitted token — the axis speculative
        decoding compresses below 1 step/token."""
        return self.steps / self.emitted_tokens if self.emitted_tokens \
            else float("nan")

    @property
    def max_inter_token_s(self) -> float:
        return max(self.inter_token_s) if self.inter_token_s else float("nan")

    @property
    def avg_latency(self) -> float:
        ls = [r.latency for r in self.requests if r.latency is not None]
        return float(np.mean(ls)) if ls else float("nan")

    @property
    def slo_violation_rate(self) -> float:
        met = [r.slo_met for r in self.requests if r.slo_met is not None]
        return 1.0 - float(np.mean(met)) if met else float("nan")

    @property
    def throughput(self) -> float:
        toks = sum(r.true_output_len for r in self.requests
                   if r.finish_time is not None)
        return toks / self.makespan if self.makespan else 0.0

    def summary(self) -> dict:
        return {
            "avg_latency_s": round(self.avg_latency, 3),
            "slo_violation": round(self.slo_violation_rate, 4),
            "throughput_tok_s": round(self.throughput, 2),
            "p99_itl_s": round(self.p99_inter_token_s, 5),
            "max_itl_s": round(self.max_inter_token_s, 5),
            "prefill_stall_s": round(self.prefill_stall_s, 4),
            "prefill_chunks": self.prefill_chunks,
            "preemptions": self.preemptions,
            "preempted_tokens": self.preempted_tokens,
            "iterations_per_token": round(self.iterations_per_token, 4),
        }


def simulate_continuous(
    requests: list[Request],
    model_cfg: ModelConfig,
    *,
    profiler: Optional[ResourceProfiler] = None,
    monitor: Optional[Monitor] = None,
    deploy: Callable = helr,
    nodes=None, latency=None,
    model_mem: Optional[float] = None,
    max_batch: int = 8,
    max_new: int = 512,
    chunk_tokens: int = 0,
    preempt: bool = False,
    block_size: int = 16,
    n_blocks: int = 4096,
    spec_tokens: int = 0,
    spec_acceptance: float = 0.0,
    tracer: Optional[Tracer] = None,
    track: int = 0,
    latency_model=None,
) -> ContinuousSimResult:
    """Iteration-level continuous-batching simulation on one replica — the
    analytic twin of ``PagedEngine.run_continuous``.

    Each iteration runs (a) at most one prefill chunk of ``chunk_tokens``
    tokens from the admission frontier (``0`` = the *whole* prompt in one
    iteration — the monolithic-prefill baseline whose decode stall this PR
    measures) and (b) one decode token for every resident past prefill, so
    an iteration costs ``prefill_time(chunk) + token_time(batch)`` and every
    decoding resident's inter-token gap is exactly that iteration time —
    the stall distribution the paged engine's ``inter_token_s`` measures.

    Admission reserves worst-case blocks from the *predicted* output length
    clamped to ``max_new`` (the same oracle-free charge as
    ``PagedEngine.can_admit``).  With ``preempt``, a blocked arrival with
    less SLO slack than the slack-most decoding resident evicts it:
    its blocks free, its prompt + generated tokens requeue as recompute
    prefill (work is re-spent; tokens already emitted stay emitted).

    ``spec_tokens > 0`` models speculative decoding at the measured
    ``spec_acceptance``: each decode iteration is priced as a verify pass
    over the K+1-token window (compute × window, one shared HBM sweep —
    ``LatencyModel.token_time(q_tokens=...)``) and emits
    ``spec_speedup(K, a)`` expected tokens, carried per-resident as
    fractional credit so the accounting is deterministic.

    ``tracer`` records the same span schema as the live engine (queued /
    prefill_chunk / decode / verify / preempt / finish on the same
    queue/slot rows), so a simulated and a live timeline diff directly.
    ``latency_model`` overrides the internally-built analytic model —
    e.g. a ``CalibratedLatencyModel`` warm-started from a profile
    registry, or a deliberately perturbed model in calibration tests."""
    from repro_torch.core.scheduler import spec_speedup as _speedup
    tracer = tracer if tracer is not None else NULL_TRACER
    if nodes is None:
        nodes, latency = paper_cluster()
    model_mem = model_mem or model_cfg.param_count() * 2.0
    if latency_model is not None:
        lm = latency_model
    else:
        dmap = deploy(model_mem, model_cfg.n_layers, nodes, latency)
        if not dmap.path:
            raise RuntimeError("deployment infeasible")
        lm = LatencyModel(model_cfg, nodes, latency, dmap)

    reqs = sorted(requests, key=lambda r: r.arrival)
    if profiler is not None:
        profiler.profile(reqs)
    usable = n_blocks - 1                      # engine parity: null block

    def worst_blocks(r: Request, gen: int) -> int:
        plan = min(max_new, max(min(r.sched_output_len, max_new), gen + 1))
        return -(-(r.input_len + plan) // block_size)

    for r in reqs:
        # engine parity: a request must fit the pool alone at its budgeted
        # horizon, or it would block the admission head forever
        wb = -(-(r.input_len + max_new) // block_size)
        if wb > usable:
            raise ValueError(f"request {r.rid}: needs {wb} blocks, "
                             f"pool has {usable} usable")

    class _Entry:
        __slots__ = ("r", "pre_rem", "out_done", "last_emit", "credit",
                     "slot", "pre_total", "recompute")

        def __init__(self, r: Request, pre_rem: int, out_done: int,
                     slot: int):
            self.r, self.pre_rem, self.out_done = r, pre_rem, out_done
            self.last_emit: Optional[float] = None
            self.credit = 0.0          # fractional speculative emissions
            self.slot = slot           # timeline row (engine slot analogue)
            self.pre_total = max(1, pre_rem)
            self.recompute = max(0, out_done - 1)   # replayed tokens

    res = ContinuousSimResult(requests=reqs, makespan=0.0)
    gen_sofar: dict[int, int] = {}             # rid -> tokens already emitted
    inflight: list[_Entry] = []
    pending: list[Request] = []
    free_slots = list(range(max_batch))        # min-slot assignment, engine-like
    qstart = {r.rid: r.arrival for r in reqs}  # rid -> queue-entry time
    bds: dict[int, LatencyBreakdown] = {}      # rid -> breakdown
    stalls: list = []                          # per-chunk decode-stall samples
    t, i = 0.0, 0

    def reserved() -> int:
        return sum(worst_blocks(e.r, e.out_done) for e in inflight)

    def admit() -> None:
        nonlocal pending
        while pending and len(inflight) < max_batch:
            cand = pending[0]
            gen = gen_sofar.get(cand.rid, 0)
            need = worst_blocks(cand, gen)
            if reserved() + need > usable:
                if not preempt:
                    if tracer.enabled:
                        tracer.instant("admission_reject", t, track=track,
                                       args={"rid": cand.rid,
                                             "queued": len(pending)})
                    break
                slack_c = cand.arrival + cand.slo - t
                decoding = [e for e in inflight if e.pre_rem == 0]
                victim = max(decoding,
                             key=lambda e: e.r.arrival + e.r.slo - t,
                             default=None)
                if victim is None or \
                        victim.r.arrival + victim.r.slo - t <= slack_c:
                    if tracer.enabled:
                        tracer.instant("admission_reject", t, track=track,
                                       args={"rid": cand.rid,
                                             "queued": len(pending)})
                    break
                inflight.remove(victim)
                free_slots.append(victim.slot)
                gen_sofar[victim.r.rid] = victim.out_done
                res.preemptions += 1
                res.preempted_tokens += victim.out_done
                qstart[victim.r.rid] = t
                vbd = bds.get(victim.r.rid)
                if vbd is not None:
                    vbd.preemptions += 1
                if tracer.enabled:
                    tracer.instant("preempt", t, track=track,
                                   row=slot_row(victim.slot),
                                   args={"rid": victim.r.rid,
                                         "tokens": victim.out_done})
                pending.insert(1, victim.r)
                continue
            pending.pop(0)
            if cand.start_time is None:
                cand.start_time = t
            slot = min(free_slots)
            free_slots.remove(slot)
            bd = bds.setdefault(cand.rid, LatencyBreakdown())
            q0 = qstart.pop(cand.rid, cand.arrival)
            bd.queue_wait_s += max(0.0, t - q0)
            if tracer.enabled:
                tracer.span("queued", min(q0, t), t, track=track,
                            row=ROW_QUEUE, args={"rid": cand.rid})
                tracer.instant("admitted", t, track=track,
                               row=slot_row(slot), args={"rid": cand.rid})
            # recompute prefix: prompt + all-but-last generated token
            inflight.append(_Entry(cand, cand.input_len + max(0, gen - 1),
                                   gen, slot))

    while i < len(reqs) or pending or inflight:
        while i < len(reqs) and reqs[i].arrival <= t:
            pending.append(reqs[i])
            i += 1
        admit()
        if not inflight:
            if i < len(reqs):
                t = max(t, reqs[i].arrival)
                continue
            break
        t_iter0 = t
        t_pre = 0.0
        prefilling = [e for e in inflight if e.pre_rem > 0]
        completed: Optional[_Entry] = None
        chunked: Optional[_Entry] = None
        chunk_n = 0
        if prefilling:
            e = prefilling[0]
            c = e.pre_rem if chunk_tokens <= 0 else min(chunk_tokens,
                                                        e.pre_rem)
            t_pre = lm.prefill_time(1, c)
            e.pre_rem -= c
            res.prefill_chunks += 1
            chunked, chunk_n = e, c
            bd = bds.get(e.r.rid)
            if bd is not None:
                bd.prefill_s += t_pre
                bd.recompute_s += t_pre * e.recompute / e.pre_total
            if e.pre_rem == 0:
                completed = e
        decoding = [e for e in inflight
                    if e.pre_rem == 0 and e is not completed]
        t_dec = 0.0
        if decoding:
            kv = float(np.mean([e.r.input_len + e.out_done
                                for e in decoding]))
            t_dec = lm.token_time(len(decoding), kv,
                                  q_tokens=spec_tokens + 1)
            res.prefill_stall_s += t_pre
            if t_pre > 0:
                stalls.append(t_pre)
        t_iter = t_pre + t_dec
        t += t_iter
        res.steps += 1
        if tracer.enabled:
            if chunked is not None:
                tracer.span("prefill_chunk", t_iter0, t_iter0 + t_pre,
                            track=track, row=slot_row(chunked.slot),
                            args={"rid": chunked.r.rid, "tokens": chunk_n,
                                  "remaining": chunked.pre_rem})
            dec_name = "verify" if spec_tokens > 0 else "decode"
            for e in decoding:
                tracer.span(dec_name, t_iter0 + t_pre, t, track=track,
                            row=slot_row(e.slot),
                            args={"rid": e.r.rid, "batch": len(decoding),
                                  "kv": kv, "q_tokens": spec_tokens + 1})
        if completed is not None and completed.out_done == 0:
            # first token out of prefill; a recompute completion (out_done
            # carried over from before eviction) restores the resume token
            # without emitting, exactly like the engine
            completed.out_done += 1
            completed.last_emit = t
            res.emitted_tokens += 1
            completed.r.first_token_time = t
            bd = bds.get(completed.r.rid)
            if bd is not None:
                bd.ttft_s = max(0.0, t - completed.r.arrival)
        exp_extra = _speedup(spec_tokens, spec_acceptance) - 1.0
        for e in decoding:
            n_emit = 1
            if spec_tokens > 0:
                e.credit += exp_extra
                extra = int(e.credit)
                e.credit -= extra
                n_emit += extra
            n_emit = min(n_emit,
                         min(e.r.true_output_len, max_new) - e.out_done)
            e.out_done += n_emit
            res.emitted_tokens += n_emit
            if e.last_emit is not None:
                res.inter_token_s.extend([(t - e.last_emit) / n_emit]
                                         * n_emit)
            e.last_emit = t
        done = [e for e in inflight
                if e.out_done >= min(e.r.true_output_len, max_new)]
        for e in done:
            inflight.remove(e)
            free_slots.append(e.slot)
            e.r.finish_time = t
            bd = bds.pop(e.r.rid, None)
            if bd is not None:
                bd.e2e_s = e.r.latency or 0.0
                if e.r.first_token_time is not None:
                    bd.decode_s = max(0.0, t - e.r.first_token_time)
                e.r.breakdown = bd
            if tracer.enabled:
                tracer.instant("finish", t, track=track,
                               row=slot_row(e.slot),
                               args={"rid": e.r.rid, "tokens": e.out_done,
                                     "slo_met": e.r.slo_met})
            if monitor is not None:
                monitor.observe(e.r)
    res.makespan = t
    if monitor is not None:
        monitor.observe_interleave(
            stall_s=res.prefill_stall_s, chunks=res.prefill_chunks,
            preemptions=res.preemptions,
            preempted_tokens=res.preempted_tokens,
            stalls=stalls, itl=res.inter_token_s)
    return res


# ------------------------------------------------- multi-replica simulation

def replicated_cluster(n: Optional[int] = None, *, scale: Optional[float] = None,
                       profiles: Optional[Sequence] = None
                       ) -> list[tuple[list[DeviceNode], list[list[float]]]]:
    """Node partitions, each a paper_cluster island (one per replica).

    ``profiles`` is the heterogeneity spec: one entry per partition, each a
    float performance scale, a ``{"scale": s}`` dict, or anything with a
    ``.scale`` attribute (``HardwareProfile``) — fast/slow lanes from one
    topology.  The legacy ``(n, scale=...)`` form (one global float) still
    works but explicitly passing ``scale`` is deprecated; omit it (every
    partition at 1.0) or pass ``profiles``.
    """
    if profiles is not None:
        if n is not None and n != len(profiles):
            raise ValueError(f"n={n} disagrees with len(profiles)="
                             f"{len(profiles)}")
        scales = []
        for p in profiles:
            if isinstance(p, dict):
                scales.append(float(p.get("scale", 1.0)))
            elif hasattr(p, "scale"):
                scales.append(float(p.scale))
            else:
                scales.append(float(p))
    else:
        if n is None:
            raise TypeError("replicated_cluster: pass n or profiles")
        if scale is not None:
            warnings.warn(
                "replicated_cluster(scale=...) is deprecated; pass "
                "profiles=[scale]*n (per-replica heterogeneity spec)",
                DeprecationWarning, stacklevel=2)
        scales = [scale if scale is not None else 1.0] * n
    parts = []
    for s in scales:
        nodes, lat = paper_cluster()
        if s != 1.0:
            nodes = [DeviceNode(d.node_id, d.memory, d.performance * s,
                                d.name) for d in nodes]
        parts.append((nodes, lat))
    return parts


@dataclass
class ClusterSimResult:
    """Outcome of a multi-replica run: request fates plus the elasticity
    accounting (replica-seconds) the autoscaler is judged on."""
    requests: list[Request]            # everything offered (finished + shed)
    shed: list[Request]
    makespan: float
    replica_seconds: float
    peak_replicas: int
    replica_stats: list[dict]
    router_stats: dict = field(default_factory=dict)
    scale_events: list = field(default_factory=list)

    @property
    def finished(self) -> list[Request]:
        return [r for r in self.requests if r.finish_time is not None]

    @property
    def slo_attainment(self) -> float:
        """Met deadlines over ALL offered requests — a shed request is a
        violation, not a statistics opt-out."""
        if not self.requests:
            return 1.0
        met = sum(bool(r.slo_met) for r in self.finished)
        return met / len(self.requests)

    @property
    def avg_latency(self) -> float:
        ls = [r.latency for r in self.finished]
        return float(np.mean(ls)) if ls else float("nan")

    @property
    def p99_latency(self) -> float:
        ls = [r.latency for r in self.finished]
        return float(np.percentile(ls, 99)) if ls else float("nan")

    @property
    def true_tokens(self) -> int:
        return sum(s["true_tokens"] for s in self.replica_stats)

    @property
    def throughput(self) -> float:
        return self.true_tokens / self.makespan if self.makespan else 0.0

    @property
    def prefill_tokens(self) -> int:
        return sum(s["prefill_tokens"] for s in self.replica_stats)

    @property
    def prefill_tokens_saved(self) -> int:
        return sum(s["prefill_tokens_saved"] for s in self.replica_stats)

    @property
    def prefix_hit_requests(self) -> int:
        return sum(s["prefix_hit_requests"] for s in self.replica_stats)

    @property
    def prefix_hit_rate(self) -> float:
        served = sum(s["served"] for s in self.replica_stats)
        return self.prefix_hit_requests / served if served else 0.0

    @property
    def mean_utilization(self) -> float:
        us = [s["utilization"] for s in self.replica_stats]
        return float(np.mean(us)) if us else 0.0

    def attainment_by(self, attr: str) -> dict:
        """Per-group SLO attainment over ALL offered requests, grouped by a
        request tag (``"model"`` or ``"tier"``); shed requests count as
        violations in their group, exactly like the scalar."""
        offered: dict = {}
        met: dict = {}
        for r in self.requests:
            key = getattr(r, attr, "") or "default"
            offered[key] = offered.get(key, 0) + 1
            if r.finish_time is not None and r.slo_met:
                met[key] = met.get(key, 0) + 1
        return {k: round(met.get(k, 0) / n, 4)
                for k, n in sorted(offered.items())}

    def summary(self) -> dict:
        out = self._summary_base()
        if any(getattr(r, "model", "") for r in self.requests):
            out["by_model"] = self.attainment_by("model")
        if any(getattr(r, "tier", "") for r in self.requests):
            out["by_tier"] = self.attainment_by("tier")
        return out

    def _summary_base(self) -> dict:
        return {
            "offered": len(self.requests),
            "finished": len(self.finished),
            "shed": len(self.shed),
            "slo_attainment": round(self.slo_attainment, 4),
            "avg_latency_s": round(self.avg_latency, 3),
            "p99_latency_s": round(self.p99_latency, 3),
            "throughput_tok_s": round(self.throughput, 2),
            "makespan_s": round(self.makespan, 3),
            "replica_seconds": round(self.replica_seconds, 2),
            "peak_replicas": self.peak_replicas,
            "mean_utilization": round(self.mean_utilization, 4),
            "prefill_tokens": self.prefill_tokens,
            "prefill_tokens_saved": self.prefill_tokens_saved,
            "prefix_hit_rate": round(self.prefix_hit_rate, 4),
            "router": self.router_stats,
            "scale_events": len(self.scale_events),
        }


def _call_price_factory(factory: Callable, lm, rid: int, model: str = ""):
    """Invoke a pricing-model factory with the arity it declares: legacy
    one-parameter factories get the replica's analytic model; two-parameter
    factories also get the replica id (per-replica calibrated pricing);
    three-parameter factories additionally get the replica's model tag
    (per-model fleet-fallback pricing)."""
    try:
        params = [p for p in inspect.signature(factory).parameters.values()
                  if p.kind in (p.POSITIONAL_ONLY, p.POSITIONAL_OR_KEYWORD,
                                p.VAR_POSITIONAL)]
        var = any(p.kind == p.VAR_POSITIONAL for p in params)
        n = 3 if var or len(params) >= 3 else (2 if len(params) >= 2 else 1)
    except (TypeError, ValueError):     # builtins/partials w/o signature
        n = 1
    if n == 3:
        return factory(lm, rid, model)
    return factory(lm, rid) if n == 2 else factory(lm)


def simulate_cluster(
    requests: list[Request],
    model_cfg: ModelConfig,
    scheduler: Callable[[list[Request], SchedulerConfig], list[Batch]],
    sched_cfg: SchedulerConfig,
    *,
    n_replicas: int = 2,
    router="round_robin",
    autoscale=None,
    partitions=None,
    pools=None,
    profiler: Optional[ResourceProfiler] = None,
    monitor: Optional[Monitor] = None,
    deploy: Callable = helr,
    model_mem: Optional[float] = None,
    max_batch: Optional[int] = None,
    block_size: int = 16,
    n_blocks: int = 4096,
    prefix_cache: bool = True,
    chunk_tokens: int = 0,
    preempt: bool = False,
    spec_tokens: int = 0,
    spec_acceptance: float = 0.0,
    tracer: Optional[Tracer] = None,
    price: Optional[Callable] = None,
    tail_price: Optional[Callable] = None,
    faults=None,
    retry=None,
    health=None,
) -> ClusterSimResult:
    """Discrete-event simulation of a replicated cluster: arrivals are
    routed on landing (``router``: a policy name, RouterConfig, or Router),
    each replica runs padded batches on its own HELR-deployed LatencyModel
    (same per-batch semantics as ``simulate``), and an optional
    ``autoscale`` (AutoscalerConfig) grows/drains the replica set against
    forecast load — new replicas take the next node partition and pay
    ``spawn_delay`` before accepting.

    Requests never routable (shed) get no ``finish_time`` and are counted
    as SLO violations by ``ClusterSimResult.slo_attainment`` and by the
    monitor (``observe_shed``) — one accounting for sim and engines.

    ``chunk_tokens``/``preempt`` describe engine-side iteration-level
    scheduling to the *replica load projections*: chunked prefill prices an
    interleave overhead into ``_chunk_time`` (drain/backlog/finish get
    slower, honestly), and preemption shrinks the busy-tail barrier in
    ``projected_finish`` for tight arrivals (so slo_aware does not shed
    requests the engine would serve by evicting slack residents).
    ``spec_tokens``/``spec_acceptance`` likewise describe engine-side
    speculative decoding: replicas price decode at the expected
    tokens-per-verify-iteration of that operating point.

    ``price`` is a factory ``analytic_lm -> pricing model`` (or
    ``(analytic_lm, rid) -> model`` — two-parameter factories also get the
    replica id, for per-replica calibrated pricing) applied to each
    replica's own LatencyModel: projections, capacity, and shedding
    decisions use the returned model while *execution* keeps the analytic
    physics — how a ``CalibratedLatencyModel`` (or a deliberately
    miscalibrated belief, in tests) is threaded through the whole
    routing/autoscaling stack without touching ground truth.
    ``tail_price`` is the same kind of factory for the replica's *tail*
    model: ``projected_finish`` (slo_aware shed/admit) and
    ``capacity_rps`` (autoscaler) price through it, so SLO-gated
    decisions can run on a quantile-calibrated model while throughput
    projections stay on the mean ``price``.

    ``pools`` turns the run into a heterogeneous multi-model fleet: a
    sequence of ``ModelPoolSpec`` (model tag, config, initial replicas,
    hardware lane, value weight) sharing one partition budget.  Requests
    tagged ``r.model`` route only within their pool; an empty pool is a
    typed fault (shed + counted, never a silent misroute).  ``autoscale``
    then accepts a ``FleetAutoscalerConfig`` (*joint* allocation of the
    shared budget by marginal SLO value, with model-swap as a scale
    action priced at ``swap_delay``), or a ``{model: AutoscalerConfig}``
    dict / single ``AutoscalerConfig`` (*independent* per-pool
    controllers — the uncoordinated baseline).

    ``faults`` arms failure injection (a ``cluster.faults.FaultPlan`` or a
    plain list of ``FaultEvent``): replicas can crash (in-flight + queued
    work lost, silently until detected), degrade (physics slow down while
    the pricing belief stays healthy — per-replica calibration drift and
    the straggler mitigator must notice), stall, or partition from the
    router.  In fault mode a health layer (``health``: ``HealthConfig``)
    heartbeats the fleet through ``distributed.fault_tolerance
    .HeartbeatTracker`` and detects failures after ``detect_lag``; lost
    requests are re-dispatched per ``retry`` (``RetryConfig``) carrying
    their generated-so-far count as a recompute prefix, so a retried
    request is token-identical to an unfailed run; late finishes of
    partitioned-but-alive replicas dedup against the retry.  Detected
    capacity loss sheds ``health.brownout_tiers`` in order (graceful
    brownout) until respawns restore the fleet.
    """
    from repro_torch.serving.cluster import (
        Autoscaler, Fleet, FleetAutoscaler, FleetAutoscalerConfig,
        ModelPoolSpec, NoCompatiblePoolError, Replica, Router, RouterConfig)
    from repro_torch.serving.cluster.faults import (FaultPlan, HealthConfig,
                                                    RetryConfig)

    tracer = tracer if tracer is not None else NULL_TRACER
    fault_mode = faults is not None
    if fault_mode:
        if not isinstance(faults, FaultPlan):
            faults = FaultPlan(events=list(faults))
        retry = retry if retry is not None else RetryConfig()
        health = health if health is not None else HealthConfig()
    if isinstance(router, str):
        router = Router(RouterConfig(policy=router))
    elif isinstance(router, RouterConfig):
        router = Router(router)
    if max_batch is None:
        # the replicas' backlog projections must price queue drain at the
        # width the scheduler actually packs, or slo_aware over-sheds
        max_batch = sched_cfg.max_batch

    multi = pools is not None
    if multi:
        specs = list(pools)
        for s in specs:
            s.resolve()
    else:
        specs = [ModelPoolSpec(model=model_cfg.name, cfg=model_cfg,
                               replicas=max(1, n_replicas))]

    scale_mode = "none"
    if autoscale is not None:
        if isinstance(autoscale, FleetAutoscalerConfig):
            scale_mode = "joint"
        elif isinstance(autoscale, dict):
            scale_mode = "independent"
        elif not multi:
            scale_mode = "single"
        else:
            autoscale = {s.model: autoscale for s in specs}
            scale_mode = "independent"

    if partitions is None:
        if scale_mode == "single":
            partitions = replicated_cluster(autoscale.max_replicas)
        elif scale_mode == "joint":
            partitions = replicated_cluster(
                max(autoscale.budget,
                    sum(max(1, s.replicas) for s in specs)))
        elif scale_mode == "independent":
            partitions = replicated_cluster(
                sum(c.max_replicas for c in autoscale.values()))
        else:
            partitions = replicated_cluster(
                sum(max(1, s.replicas) for s in specs))

    def factory(idx: int, spec, nodes, lat, now: float):
        rep = Replica(idx, spec.cfg, nodes, lat, deploy=deploy,
                      model_mem=model_mem, max_batch=max_batch,
                      block_size=block_size, n_blocks=n_blocks,
                      prefix_cache=prefix_cache, chunk_tokens=chunk_tokens,
                      preempt=preempt, spec_tokens=spec_tokens,
                      spec_acceptance=spec_acceptance, spawned_at=now,
                      tracer=tracer, model=spec.model, hw=spec.hw)
        rep.defer_finalize = fault_mode
        if price is not None:
            rep.price = _call_price_factory(price, rep.lm, idx, spec.model)
        if tail_price is not None:
            rep.tail = _call_price_factory(tail_price, rep.lm, idx,
                                           spec.model)
        return rep

    fleet = Fleet(partitions, specs, factory)
    replicas = fleet.replicas             # alias: Fleet mutates in place

    for spec in specs:
        for _ in range(max(1, spec.replicas)):
            fleet.spawn(spec.model, 0.0)

    def _pool_means(model: Optional[str] = None):
        rs = [r for r in requests
              if model is None or getattr(r, "model", "") == model] \
            or list(requests)
        ins = [r.input_len for r in rs] or [64]
        outs = [r.predicted_output_len or r.true_output_len
                for r in rs] or [64]
        return float(np.mean(ins)), float(np.mean(outs))

    autoscaler = None                     # legacy single-pool controller
    autoscalers: dict = {}                # independent: model -> Autoscaler
    fleet_asc = None                      # joint fleet controller
    tick_interval = None
    if scale_mode == "single":
        mean_in, mean_out = _pool_means()
        # capacity prices through replica 0's tail model: the mean belief
        # by default, the quantile-calibrated one when tail_price is set
        autoscaler = Autoscaler(autoscale,
                                replicas[0].capacity_rps(mean_in, mean_out))
        tick_interval = autoscale.interval
    elif scale_mode == "independent":
        for spec in specs:
            mean_in, mean_out = _pool_means(spec.model)
            cap = fleet.pool(spec.model)[0].capacity_rps(mean_in, mean_out)
            autoscalers[spec.model] = Autoscaler(autoscale[spec.model], cap)
        tick_interval = min(c.interval for c in autoscale.values())
    elif scale_mode == "joint":
        caps = {}
        for spec in specs:
            mean_in, mean_out = _pool_means(spec.model)
            caps[spec.model] = fleet.pool(spec.model)[0].capacity_rps(
                mean_in, mean_out)
        fleet_asc = FleetAutoscaler(autoscale, caps,
                                    {s.model: s.weight for s in specs})
        tick_interval = autoscale.interval

    heap: list = []
    seq = 0

    def push(t: float, kind: str, obj=None):
        nonlocal seq
        heapq.heappush(heap, (t, seq, kind, obj))
        seq += 1

    reqs = sorted(requests, key=lambda r: r.arrival)
    for r in reqs:
        push(r.arrival, "arrive", r)
    if tick_interval is not None:
        push(tick_interval, "tick")

    shed: list[Request] = []
    arrivals_since_tick = 0
    arrivals_by_model: dict = {}
    n_arrived = 0
    pending_spawns = 0
    pending_by_model: dict = {}
    peak = sum(rep.accepting for rep in replicas)
    t_end = 0.0

    # --- fault-mode state ---
    hb = None
    mitigator = None
    lost_work: dict[int, list] = {}    # replica rid -> undetected lost work
    retry_count: dict[int, int] = {}   # request rid -> retries spent
    pending_retries = 0
    finalized: set = set()             # request rids finalized exactly once
    capacity_lost = 0                  # detected, not-yet-respawned losses
    brownout_level = 0
    if fault_mode:
        from repro_torch.distributed.fault_tolerance import (
            HeartbeatTracker, StragglerMitigator)
        hb = HeartbeatTracker(timeout=health.detect_lag)
        if health.straggler_factor > 0:
            mitigator = StragglerMitigator(factor=health.straggler_factor)
        horizon = (reqs[-1].arrival * 1.25 + 30.0) if reqs else 60.0
        for fe in faults.materialize(len(replicas), horizon):
            push(fe.t, "fault", fe)
        push(health.check_interval, "health")

    def maybe_start(rep, now: float) -> None:
        if rep.failed_at is not None:
            return                     # a crashed replica starts nothing
        done = rep.start_batch(now, scheduler, sched_cfg, profiler, monitor)
        if done is not None:
            push(done, "done", rep)

    def work_remains() -> bool:
        remains = n_arrived < len(reqs) or pending_spawns > 0 or any(
            rep.queue or rep.inflight_blocks for rep in replicas)
        if fault_mode:
            # undetected lost work keeps the health chain alive until the
            # detector reclaims it; pending retries are still work too
            remains = remains or pending_retries > 0 or bool(lost_work)
        return remains

    def drop(r: Request, now: float) -> None:
        shed.append(r)
        if tracer.enabled:
            tracer.instant("shed", now, track=0, row=ROW_QUEUE,
                           args={"rid": r.rid})
        if monitor is not None:
            monitor.observe_shed(r)

    def route_request(r: Request, now: float) -> None:
        """Dispatch (arrivals and retries share it): route, pay the
        misroute forward hop if the blind pick bounced, enqueue + start."""
        mis0 = router.stats.misroutes
        try:
            rep = router.dispatch(r, replicas, now)
        except NoCompatiblePoolError:
            rep = None                # typed cross-pool fault: shed
        if rep is None:
            drop(r, now)
        else:
            if tracer.enabled:
                tracer.instant("route", now, track=rep.rid,
                               args={"rid": r.rid,
                                     "policy": router.cfg.policy})
            if router.stats.misroutes > mis0:
                # model-blind pick hit the wrong pool: the bounce into
                # the compatible pool pays a forward hop
                push(now + router.cfg.forward_delay, "forward", (rep, r))
            else:
                rep.enqueue(r, now)
                maybe_start(rep, now)

    def update_brownout(now: float) -> None:
        nonlocal brownout_level
        m = min(len(health.brownout_tiers), capacity_lost) \
            if fault_mode else 0
        if m != brownout_level:
            if tracer.enabled:
                tracer.instant(
                    "brownout", now, track=0,
                    args={"level": m,
                          "tiers": list(health.brownout_tiers[:m])})
            brownout_level = m

    def requeue_lost(lost: list, now: float) -> None:
        """Retry policy for requests lost to a crash/partition: dedup
        against already-finalized finishes, spend the retry budget with
        exponential backoff, shed past it."""
        nonlocal pending_retries
        for r in lost:
            if r.rid in finalized:
                if monitor is not None:
                    monitor.observe_retry(deduped=True)
                continue
            attempt = retry_count.get(r.rid, 0)
            if attempt >= retry.budget:
                if monitor is not None:
                    monitor.observe_retry(exhausted=True)
                router._shed(r)
                drop(r, now)
                continue
            retry_count[r.rid] = attempt + 1
            delay = retry.backoff(attempt)
            pending_retries += 1
            if tracer.enabled:
                tracer.instant("retry", now, track=0, row=ROW_QUEUE,
                               args={"rid": r.rid, "attempt": attempt + 1,
                                     "delay": round(delay, 4),
                                     "resume_tokens": r.generated})
            if monitor is not None:
                monitor.observe_retry()
            push(now + delay, "retry", r)

    while heap:
        t, _, kind, obj = heapq.heappop(heap)
        if kind in ("arrive", "done", "forward", "retry"):
            # ticks/spawns trailing the last completion must not stretch
            # the makespan (it feeds replica-seconds and throughput)
            t_end = max(t_end, t)
        if kind == "arrive":
            n_arrived += 1
            arrivals_since_tick += 1
            m = getattr(obj, "model", "")
            if m:
                arrivals_by_model[m] = arrivals_by_model.get(m, 0) + 1
            if fault_mode and brownout_level > 0 and \
                    getattr(obj, "tier", "") in \
                    health.brownout_tiers[:brownout_level]:
                # graceful brownout: detected capacity loss sheds the
                # lowest-value tiers at admission, in configured order
                router._shed(obj)
                drop(obj, t)
                if monitor is not None:
                    monitor.observe_brownout()
            else:
                route_request(obj, t)
        elif kind == "forward":
            rep, r = obj
            if not rep.accepting:         # target drained mid-flight
                try:
                    rep = router.dispatch(r, replicas, t)
                except NoCompatiblePoolError:
                    rep = None
            if rep is None:
                drop(r, t)
            else:
                rep.enqueue(r, t)
                maybe_start(rep, t)
        elif kind == "done":
            if fault_mode and obj.failed_at is not None:
                pass          # stale completion event of a dead replica
            else:
                reqs_done = obj.finish_batch()
                for r in reqs_done:
                    if r.rid in finalized:
                        # a partitioned replica finished work the cluster
                        # already retried elsewhere: first finish wins
                        if monitor is not None:
                            monitor.observe_retry(deduped=True)
                        continue
                    finalized.add(r.rid)
                    obj.finalize_request(r, monitor)
                if mitigator is not None and reqs_done:
                    mitigator.record(
                        obj.rid, (obj._batch_t1 - obj._batch_t0)
                        / max(obj._batch_pred_s, 1e-9))
                if obj.queue:
                    maybe_start(obj, t)
                elif obj.draining:
                    fleet.retire(obj, t)
        elif kind == "spawn":
            pending_spawns -= 1
            if fault_mode and capacity_lost > 0:
                capacity_lost -= 1     # respawn replaces detected loss
                update_brownout(t)
            m = obj if obj is not None else specs[0].model
            if multi:
                pending_by_model[m] = pending_by_model.get(m, 0) - 1
            if work_remains() or n_arrived < len(reqs):
                if multi and not fleet.free_parts:
                    # swap partner has not retired yet (still draining its
                    # batch): retry shortly, never double-book a partition
                    pending_spawns += 1
                    pending_by_model[m] = pending_by_model.get(m, 0) + 1
                    push(t + 0.25, "spawn", m)
                else:
                    fleet.spawn(m, t)
        elif kind == "fault":
            ev = obj
            rep = next((x for x in replicas if x.rid == ev.rid), None)
            if rep is None or rep.retired_at is not None \
                    or rep.failed_at is not None:
                pass                   # fault on a lane already gone
            elif ev.kind == "crash":
                # silent death: inflight work past its finish stamp still
                # counts (it left the replica before the crash), the rest
                # is lost with the KV until the health layer notices
                done_pre, lost = rep.fail(t)
                for r in done_pre:
                    if r.rid not in finalized:
                        finalized.add(r.rid)
                        rep.finalize_request(r, monitor)
                lost_work.setdefault(rep.rid, []).extend(lost)
            elif ev.kind == "degrade":
                rep.degrade(ev.factor)
                if ev.duration > 0:
                    push(t + ev.duration, "heal", ("degrade", rep))
            elif ev.kind == "stall":
                rep.busy_until = max(rep.busy_until, t + ev.duration)
                push(t + ev.duration, "heal", ("stall", rep))
            elif ev.kind == "partition":
                # unreachable, not dead: the router stops picking it but
                # work already on board keeps running and may finish late
                rep.partitioned = True
                push(t + ev.duration, "heal", ("partition", rep))
        elif kind == "heal":
            what, rep = obj
            if rep.retired_at is not None or rep.failed_at is not None:
                pass
            elif what == "degrade":
                rep.heal_degrade()
            elif what == "stall":
                maybe_start(rep, t)
            elif what == "partition":
                if rep.down:
                    # the detector declared it lost; rejoining restores
                    # that capacity without waiting for a respawn
                    capacity_lost = max(0, capacity_lost - 1)
                rep.partitioned = False
                rep.down = False
                if hb is not None:
                    hb.beat(rep.rid, now=t)
                update_brownout(t)
                if rep.queue:
                    maybe_start(rep, t)
        elif kind == "health":
            # heartbeat scan: live replicas beat, silent ones age out
            # after detect_lag and are declared down
            for rep in replicas:
                if rep.retired_at is None:
                    hb.last_seen.setdefault(rep.rid, rep.spawned_at)
                    if rep.failed_at is None and not rep.partitioned \
                            and not rep.down:
                        hb.beat(rep.rid, now=t)
            down_now = set(hb.failed(now=t))
            for rep in replicas:
                if rep.rid not in down_now or rep.down:
                    continue
                if rep.retired_at is not None and rep.failed_at is None:
                    continue   # clean scale-down: silence is expected
                # a scale-down may have already retired a silently-failed
                # replica (it looked idle); its lost work still needs the
                # detector to reclaim it, but the capacity was given up
                # deliberately so no respawn debt is recorded
                rep.down = True
                kind_f = "partition" if rep.partitioned else "crash"
                if tracer.enabled:
                    lag = (t - rep.failed_at
                           if rep.failed_at is not None else None)
                    tracer.instant(
                        "replica_failed", t, track=rep.rid,
                        args={"rid": rep.rid, "kind": kind_f,
                              "detect_lag": lag})
                if monitor is not None:
                    monitor.observe_failure(rep.rid, kind_f)
                if rep.retired_at is None:
                    capacity_lost += 1
                lost = lost_work.pop(rep.rid, []) + rep.take_queued()
                if kind_f == "partition":
                    # clone inflight work for re-dispatch: the original
                    # may still land late, the finalized set dedups
                    for r in rep.inflight_reqs:
                        c = copy.copy(r)
                        c.generated = 0
                        c.first_token_time = None
                        c.finish_time = None
                        c.start_time = None
                        c.breakdown = None
                        lost.append(c)
                elif rep.retired_at is None:
                    fleet.retire(rep, t)
                requeue_lost(lost, t)
            update_brownout(t)
            if mitigator is not None:
                for srid in mitigator.mitigate():
                    srep = next((x for x in replicas if x.rid == srid),
                                None)
                    if srep is not None and srep.accepting:
                        srep.draining = True
                        if tracer.enabled:
                            tracer.instant(
                                "replica_failed", t, track=srep.rid,
                                args={"rid": srep.rid,
                                      "kind": "straggler"})
                        if monitor is not None:
                            monitor.observe_failure(srep.rid, "straggler")
            if work_remains():
                push(t + health.check_interval, "health")
        elif kind == "retry":
            pending_retries -= 1
            if obj.rid in finalized:
                # the partitioned original landed while this retry waited
                # out its backoff
                if monitor is not None:
                    monitor.observe_retry(deduped=True)
            else:
                route_request(obj, t)
        elif kind == "tick" and scale_mode == "single":
            want = autoscaler.tick(t, arrivals_since_tick, replicas,
                                   pending_spawns)
            arrivals_since_tick = 0
            arrivals_by_model = {}
            accepting = [rep for rep in replicas if rep.accepting]
            effective = len(accepting) + pending_spawns
            if want > effective:
                order = want - effective
                # cheapest capacity first: un-drain replicas still alive
                for rep in replicas:
                    if order <= 0:
                        break
                    if rep.draining and rep.retired_at is None:
                        rep.draining = False
                        order -= 1
                for _ in range(order):
                    pending_spawns += 1
                    push(t + autoscale.spawn_delay, "spawn")
                if tracer.enabled:
                    tracer.instant("scale_up", t, track=0,
                                   args={"want": want,
                                         "have": effective})
                if monitor is not None:
                    monitor.observe_scale(+1, want - effective)
            elif want < len(accepting):
                victims = sorted(accepting,
                                 key=lambda rep: rep.projected_backlog(t))
                for rep in victims[:len(accepting) - want]:
                    rep.draining = True
                    if rep.idle and rep.busy_until <= t:
                        fleet.retire(rep, t)
                if tracer.enabled:
                    tracer.instant("scale_down", t, track=0,
                                   args={"want": want,
                                         "have": len(accepting)})
                if monitor is not None:
                    monitor.observe_scale(-1, len(accepting) - want)
            if monitor is not None:
                alive = [rep for rep in replicas if rep.accepting]
                monitor.observe_replicas(
                    [rep.queue_depth for rep in alive],
                    [rep.utilization(t) for rep in alive])
            peak = max(peak, sum(rep.accepting for rep in replicas))
            if work_remains():
                push(t + tick_interval, "tick")
        elif kind == "tick":
            # fleet control step: per-pool targets from the joint or the
            # independent controllers, then drain/spawn per pool — spawns
            # paired with same-tick drains are model swaps (swap_delay)
            if scale_mode == "independent":
                targets = {m: asc.tick(t, arrivals_by_model.get(m, 0),
                                       fleet.pool(m),
                                       pending_by_model.get(m, 0))
                           for m, asc in autoscalers.items()}
            else:
                targets = fleet_asc.tick(t, arrivals_by_model, replicas,
                                         pending_by_model)
            arrivals_since_tick = 0
            arrivals_by_model = {}
            drains_now = 0
            spawn_orders: list[str] = []
            for m, want in targets.items():
                accepting_m = [rep for rep in fleet.pool(m)
                               if rep.accepting]
                effective = len(accepting_m) + pending_by_model.get(m, 0)
                if want > effective:
                    order = want - effective
                    for rep in fleet.pool(m):
                        if order <= 0:
                            break
                        if rep.draining and rep.retired_at is None:
                            rep.draining = False
                            order -= 1
                    spawn_orders.extend([m] * order)
                    if tracer.enabled:
                        tracer.instant("scale_up", t, track=0,
                                       args={"model": m, "want": want,
                                             "have": effective})
                    if monitor is not None:
                        monitor.observe_scale(+1, want - effective)
                elif want < len(accepting_m):
                    victims = sorted(
                        accepting_m,
                        key=lambda rep: rep.projected_backlog(t))
                    for rep in victims[:len(accepting_m) - want]:
                        rep.draining = True
                        drains_now += 1
                        if rep.idle and rep.busy_until <= t:
                            fleet.retire(rep, t)
                    if tracer.enabled:
                        tracer.instant("scale_down", t, track=0,
                                       args={"model": m, "want": want,
                                             "have": len(accepting_m)})
                    if monitor is not None:
                        monitor.observe_scale(-1, len(accepting_m) - want)
            for i, m in enumerate(spawn_orders):
                if scale_mode == "joint":
                    delay = autoscale.swap_delay if i < drains_now \
                        else autoscale.spawn_delay
                else:
                    delay = autoscale[m].spawn_delay
                pending_spawns += 1
                pending_by_model[m] = pending_by_model.get(m, 0) + 1
                push(t + delay, "spawn", m)
            if monitor is not None:
                alive = fleet.accepting()
                monitor.observe_replicas(
                    [rep.queue_depth for rep in alive],
                    [rep.utilization(t) for rep in alive])
            peak = max(peak, sum(rep.accepting for rep in replicas))
            if work_remains():
                push(t + tick_interval, "tick")
        peak = max(peak, sum(rep.accepting for rep in replicas))

    makespan = max([t_end] + [r.finish_time for r in reqs
                              if r.finish_time is not None])
    for rep in replicas:
        if rep.retired_at is None and rep.draining:
            rep.retire(makespan)
    if monitor is not None:
        # final snapshot so fixed-size runs (no ticks) report gauges too
        alive = [rep for rep in replicas if rep.accepting]
        monitor.observe_replicas([rep.queue_depth for rep in alive],
                                 [rep.utilization(makespan)
                                  for rep in alive])
    replica_seconds = sum(rep.alive_seconds(makespan) for rep in replicas)
    rep_stats = []
    for rep in replicas:
        s = rep.stats.summary()
        s["rid"] = rep.rid
        s["utilization"] = round(rep.utilization(makespan), 4)
        s["alive_seconds"] = round(rep.alive_seconds(makespan), 2)
        s["dmap_path"] = rep.dmap.path
        s["model"] = rep.model
        s["hw_scale"] = rep.hw.scale
        rep_stats.append(s)
    if autoscaler is not None:
        events = autoscaler.events
    elif autoscalers:
        events = sorted((e for asc in autoscalers.values()
                         for e in asc.events), key=lambda e: e.time)
    elif fleet_asc is not None:
        events = fleet_asc.events
    else:
        events = []
    return ClusterSimResult(
        requests=reqs, shed=shed, makespan=makespan,
        replica_seconds=replica_seconds, peak_replicas=peak,
        replica_stats=rep_stats, router_stats=router.stats.summary(),
        scale_events=events)


# --------------------------------------------------- baseline deploy systems

def morphling_deploy_overhead(model_cfg: ModelConfig, nodes, latency,
                              n_trials: int = 8) -> float:
    """Morphling stress-tests sampled configurations before committing
    (paper §3.1): each trial runs a short profiling workload on the cluster.
    Returns the serving-start delay it costs."""
    dmap = bgs(model_cfg.param_count() * 2.0, model_cfg.n_layers, nodes, latency)
    lm = LatencyModel(model_cfg, nodes, latency, dmap)
    per_trial = lm.prefill_time(8, 128) + 64 * lm.token_time(8, 192)
    return n_trials * per_trial
