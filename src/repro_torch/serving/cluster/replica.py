"""One serving replica of the cluster layer.

A ``Replica`` owns a deployed serving backend — a live ``PagedEngine`` or,
for cluster-scale runs, a ``LatencyModel``-backed simulated engine over the
DeviceMap HELR chose for its node partition — plus the state the cluster
layer steers by: its request queue, a projection of its block pool, and a
replica-local radix tree mirroring what its prefix cache holds.

The load signals it exposes are exactly the UELLM components' outputs lifted
one level up:

* ``projected_backlog`` — profiler-predicted output lengths priced through
  the replica's own LatencyModel (queue drain in seconds, batch-width
  amortized), the signal ``least_loaded``/``slo_aware`` routing ranks by;
* ``prefix_peek`` — longest radix-tree prompt match, the signal
  ``prefix_affinity`` routing maximizes (a hit both skips prefill FLOPs and
  discounts block demand);
* ``free_blocks`` — pool capacity net of queued worst-case demand, the
  backpressure admission control already applies inside one engine;
* ``capacity_rps`` — sustainable request rate at full batch width, the
  per-replica denominator the autoscaler divides forecast load by.

Prefix accounting happens at **dispatch** time (match-then-insert into the
routing tree): the router must decide before the engine prefills, so the
hit it sees is a conservative lower bound on what the engine's radix cache
will serve by prefill time (the cache can only have gained entries since).
"""
from __future__ import annotations

import dataclasses
import heapq
from dataclasses import dataclass
from typing import Callable, Optional, Sequence

from repro_torch.configs.base import ModelConfig
from repro_torch.core.deployer import helr
from repro_torch.core.types import DeviceNode, Request
from repro_torch.obs.trace import (NULL_TRACER, ROW_QUEUE, LatencyBreakdown,
                                   Tracer)
from repro_torch.serving.prefix_cache import RadixBlockTree
from repro_torch.serving.simulator import LatencyModel


@dataclass(frozen=True)
class HardwareProfile:
    """The hardware lane a replica's partition runs on (SageServe's
    fast/slow lanes, PAPERS.md): ``scale`` multiplies every node's
    effective FLOP/s before deployment, so one model config yields
    distinct LatencyModels per lane — heterogeneity without a separate
    topology per replica."""
    name: str = "standard"
    scale: float = 1.0

    def apply(self, nodes: Sequence[DeviceNode]) -> list[DeviceNode]:
        if self.scale == 1.0:
            return list(nodes)
        return [DeviceNode(n.node_id, n.memory, n.performance * self.scale,
                           n.name) for n in nodes]


@dataclass
class ReplicaStats:
    served: int = 0
    batches: int = 0
    busy_time: float = 0.0           # seconds the backend was executing
    true_tokens: int = 0             # generated tokens (throughput numerator)
    prefill_tokens: int = 0          # prompt tokens actually prefilled
    prefill_tokens_saved: int = 0    # prompt tokens served from the cache
    prefix_hit_requests: int = 0
    slo_met: int = 0
    slo_missed: int = 0

    def summary(self) -> dict:
        return {
            "served": self.served,
            "batches": self.batches,
            "busy_time_s": round(self.busy_time, 3),
            "true_tokens": self.true_tokens,
            "prefill_tokens": self.prefill_tokens,
            "prefill_tokens_saved": self.prefill_tokens_saved,
            "prefix_hit_requests": self.prefix_hit_requests,
            "slo_met": self.slo_met,
            "slo_missed": self.slo_missed,
        }


class Replica:
    """A routable serving unit: engine + queue + pool/prefix projections."""

    def __init__(self, rid: int, model_cfg: ModelConfig,
                 nodes: Sequence[DeviceNode], latency, *,
                 deploy: Callable = helr,
                 model_mem: Optional[float] = None,
                 max_batch: int = 8, block_size: int = 16,
                 n_blocks: int = 4096, prefix_cache: bool = True,
                 max_tree_nodes: int = 65536,
                 chunk_tokens: int = 0, preempt: bool = False,
                 spec_tokens: int = 0, spec_acceptance: float = 0.0,
                 spawned_at: float = 0.0, engine=None,
                 tracer: Optional[Tracer] = None, price_model=None,
                 tail_model=None, model: Optional[str] = None,
                 hw: Optional[HardwareProfile] = None):
        self.rid = rid
        self.model_cfg = model_cfg
        # fleet identity: which model pool this replica serves, and which
        # hardware lane its partition runs on (scales the LatencyModel)
        self.model = model if model is not None else model_cfg.name
        self.hw = hw if hw is not None else HardwareProfile()
        nodes = self.hw.apply(nodes)
        model_mem = model_mem or model_cfg.param_count() * 2.0
        self.dmap = deploy(model_mem, model_cfg.n_layers, nodes, latency)
        if not self.dmap.path:
            raise RuntimeError(
                f"replica {rid}: deployment infeasible on its partition")
        self.lm = LatencyModel(model_cfg, nodes, latency, self.dmap)
        # pricing/belief model: every load *projection* (drain, backlog,
        # projected_finish, capacity_rps — hence slo_aware shedding and
        # autoscaler capacity) prices through ``price`` while *execution*
        # stays on the analytic physics ``lm``.  Defaults to the physics;
        # a ``CalibratedLatencyModel`` (or a deliberately miscalibrated
        # belief, in tests) slots in without touching ground truth.
        self.price = price_model if price_model is not None else self.lm
        # tail/SLO pricing model: ``projected_finish`` (hence slo_aware
        # shed/admit) and ``capacity_rps`` price through ``tail`` — by
        # default it follows ``price`` (mean pricing), but a quantile
        # ``CalibratedLatencyModel`` slots in so p99-gated decisions price
        # a tail ratio while throughput projections stay on the mean
        self._tail = tail_model
        self.max_batch = max_batch
        self.block_size = block_size
        self.n_blocks = n_blocks
        self.tree: Optional[RadixBlockTree] = \
            RadixBlockTree(block_size) if prefix_cache else None
        self.max_tree_nodes = max_tree_nodes
        self.engine = engine                  # live PagedEngine (optional)
        self.chunk_tokens = chunk_tokens      # engine-side chunked prefill
        self.preempt = preempt                # engine-side SLO preemption
        # engine-side speculative decoding: load projections price decode
        # at the expected tokens/iteration of the (K, acceptance) operating
        # point, with each iteration costing a K+1-wide verify pass
        self.spec_tokens = spec_tokens
        self.spec_acceptance = spec_acceptance
        self.queue: list[Request] = []
        self.busy_until = 0.0
        self.inflight_blocks = 0
        self.inflight_slos: list[float] = []  # SLOs of the running batch
        self.draining = False                 # autoscaler: no new dispatches
        self.partition: Optional[int] = None  # node-partition slot (cluster)
        self.spawned_at = spawned_at
        self.retired_at: Optional[float] = None
        self.stats = ReplicaStats()
        self._net_prefill: dict[int, int] = {}   # rid -> uncached prompt len
        # lifecycle tracing: this replica's events land on track ``rid``
        # (one Perfetto process per replica); disabled tracer = no-op
        self.tracer = tracer if tracer is not None else NULL_TRACER
        self._qstart: dict[int, float] = {}      # rid -> enqueue time
        # --- fault tolerance (simulate_cluster fault mode) ---
        # finalize requests at the 'done' event instead of batch start, so
        # a crash can revert in-flight work without unwinding the monitor
        self.defer_finalize = False
        self.failed_at: Optional[float] = None   # ground truth: crash time
        self.down = False                 # health-layer verdict (detected)
        self.partitioned = False          # unreachable by the router
        self.inflight_reqs: list[Request] = []   # retained when deferring
        self._batch_t0 = 0.0              # running batch start / end, and
        self._batch_t1 = 0.0              # its belief-priced service time
        self._batch_pred_s = 0.0          # (straggler-ratio denominator)
        self._base_lm = None              # healthy physics during degrade

    @property
    def tail(self):
        """SLO-decision pricing model: ``tail_model`` when set, else
        whatever ``price`` currently is (mean pricing by default)."""
        return self._tail if self._tail is not None else self.price

    @tail.setter
    def tail(self, model) -> None:
        self._tail = model

    # ------------------------------------------------------------- liveness
    @property
    def accepting(self) -> bool:
        """Routable: a *detected*-down or partitioned replica is excluded,
        but a crashed-yet-undetected one still looks routable — silent
        death is the point of the detection lag."""
        return not self.draining and self.retired_at is None \
            and not self.down and not self.partitioned

    @property
    def healthy(self) -> bool:
        """Ground truth liveness: neither crashed nor declared down (the
        health layer detects ``not healthy`` after its lag)."""
        return self.failed_at is None and not self.down

    @property
    def idle(self) -> bool:
        return not self.queue and self.inflight_blocks == 0

    def alive_seconds(self, now: float) -> float:
        end = self.retired_at if self.retired_at is not None else now
        return max(0.0, end - self.spawned_at)

    def utilization(self, now: float) -> float:
        alive = self.alive_seconds(now)
        return self.stats.busy_time / alive if alive > 0 else 0.0

    # ---------------------------------------------------------- load signals
    @property
    def queue_depth(self) -> int:
        return len(self.queue)

    @staticmethod
    def _resume_prefix(r: Request) -> int:
        """Tokens a retried request carries as recompute prefix (the PR-4
        preempt-and-recompute mechanism lifted to the cluster level):
        replayed through prefill, never re-emitted, so a retried request
        stays token-identical to an unfailed run."""
        return min(r.generated, max(0, r.true_output_len - 1))

    @staticmethod
    def _eff_out(r: Request) -> int:
        """Output tokens still to decode (total minus recompute prefix)."""
        return r.true_output_len - Replica._resume_prefix(r)

    def prefix_peek(self, tokens: list) -> int:
        """Longest cached-prompt match in tokens — no LRU touch, no insert."""
        if self.tree is None:
            return 0
        return self.tree.match(tokens, touch=False).hit_tokens

    def _blocks_for(self, r: Request) -> int:
        """Worst-case pool demand, net of full-block prefix hits — the same
        discount ``PagedEngine.can_admit`` applies (shared blocks are
        already resident)."""
        out = r.predicted_output_len or r.sched_output_len
        total = -(-(r.input_len + out) // self.block_size)
        hit = r.input_len - self._net_prefill.get(r.rid, r.input_len)
        return max(1, total - hit // self.block_size)

    @property
    def projected_blocks(self) -> int:
        """Worst-case pool demand of queued + in-flight work."""
        return self.inflight_blocks + sum(self._blocks_for(r)
                                          for r in self.queue)

    @property
    def free_blocks(self) -> int:
        return max(0, self.n_blocks - self.projected_blocks)

    def _decode_seconds(self, w: int, out: float, kv: float,
                        lm=None) -> float:
        """Decode-phase seconds for ``out`` tokens at batch width ``w``:
        with speculation each iteration is a K+1-wide verify pass emitting
        ``spec_speedup(K, acceptance)`` expected tokens — the projection
        must price the *measured* operating point, or slo_aware routing
        sheds requests a speculating engine would finish in time (and
        conversely over-admits when acceptance collapses).  Prices on the
        belief model unless ``lm`` pins a specific one (execution passes
        the physics ``self.lm``)."""
        from repro_torch.core.scheduler import spec_speedup
        model = lm if lm is not None else self.price
        t_iter = model.token_time(w, kv, q_tokens=self.spec_tokens + 1)
        iters = out / spec_speedup(self.spec_tokens, self.spec_acceptance)
        return iters * t_iter

    def _chunk_time(self, chunk: list[Request], model=None) -> float:
        """Service time of one batch-width chunk: prefill on the longest
        *uncached* prompt + decode to the longest predicted output.  With
        engine-side chunked prefill (``chunk_tokens``) every extra prefill
        chunk re-reads the already-written prefix K/V through the block
        table, so the projection prices roughly one decode-iteration of
        cache traffic per additional chunk — interleaving trades a little
        throughput for bounded inter-token stalls, and load signals must
        not pretend it is free.  Prices on the belief ``price`` unless
        ``model`` pins one (SLO paths pass ``self.tail``)."""
        m = model if model is not None else self.price
        w = len(chunk)
        in_net = max(max(1, self._net_prefill.get(r.rid, r.input_len))
                     for r in chunk)
        out = max((r.predicted_output_len or r.sched_output_len)
                  for r in chunk)
        kv = max(r.input_len for r in chunk) + out / 2
        t_pre = m.prefill_time(w, in_net)
        if self.chunk_tokens > 0:
            n_chunks = -(-in_net // self.chunk_tokens)
            t_pre += (n_chunks - 1) * m.token_time(w, in_net / 2)
        return t_pre + self._decode_seconds(w, out, kv, lm=m)

    def projected_drain(self) -> float:
        """Seconds to clear the queue, batched at engine width."""
        t = 0.0
        for i in range(0, len(self.queue), self.max_batch):
            t += self._chunk_time(self.queue[i:i + self.max_batch])
        return t

    def projected_backlog(self, now: float) -> float:
        return max(0.0, self.busy_until - now) + self.projected_drain()

    def projected_finish(self, r: Request, now: float) -> float:
        """Earliest time this replica could complete ``r`` if enqueued now —
        the slo_aware routing estimate.  Scheduler-aware: SLO-ODBS serves
        SLO-ascending, so only queued requests with *tighter* SLOs drain
        ahead of ``r``; ``r`` itself finishes with its batch cohort (it
        pays the cohort's padded prefill, not a batch-of-one's).

        With engine-side preemption the in-flight barrier shrinks: the
        engine can evict residents with more slack than ``r`` and give it
        their capacity, so only the busy tail attributable to the
        tighter-or-equal share of the running batch still blocks ``r`` —
        without this the router sheds tight requests the engine could in
        fact serve by preempting.

        Prices on ``self.tail``: an SLO commitment made off a mean ratio
        under-prices the slow tail, so shed/admit reads the (optionally
        quantile-calibrated) tail model."""
        cohort = [q for q in self.queue if q.slo <= r.slo] + [r]
        t = max(0.0, self.busy_until - now)
        if self.preempt and t > 0 and self.inflight_slos:
            tighter = sum(1 for s in self.inflight_slos if s <= r.slo)
            t *= tighter / len(self.inflight_slos)
        for i in range(0, len(cohort), self.max_batch):
            t += self._chunk_time(cohort[i:i + self.max_batch],
                                  model=self.tail)
        return now + t

    def capacity_rps(self, mean_in: float = 64.0,
                     mean_out: float = 64.0) -> float:
        """Sustainable request rate at full batch width (autoscaler's
        per-replica capacity denominator; speculation raises it).  Prices
        on ``self.tail`` so a capacity that backs an SLO-gated scaling
        decision can be tail-calibrated; with no tail model configured
        this is the mean belief, exactly as before."""
        m = self.tail
        w = self.max_batch
        t = m.prefill_time(w, mean_in) \
            + self._decode_seconds(w, mean_out, mean_in + mean_out / 2,
                                   lm=m)
        return w / t if t > 0 else float("inf")

    # ------------------------------------------------------------- dispatch
    def _prune_tree(self) -> None:
        """LRU-evict routing-tree leaves once past ``max_tree_nodes`` (the
        engine's real cache also evicts under pressure; an unbounded
        router-side model would both leak and over-promise hits)."""
        target = self.max_tree_nodes * 7 // 8
        heap = [(n.tick, id(n), n) for n in self.tree.iter_nodes()
                if n.is_leaf]
        heapq.heapify(heap)
        while self.tree.n_nodes > target and heap:
            _, _, victim = heapq.heappop(heap)
            parent = victim.parent
            self.tree.remove(victim)
            if parent is not None and parent is not self.tree.root \
                    and parent.is_leaf:
                heapq.heappush(heap, (parent.tick, id(parent), parent))

    def enqueue(self, r: Request, now: float) -> None:
        """Accept a routed request: record its prefix discount against the
        routing tree, then register its prompt so subsequent same-template
        dispatches (to this replica) hit."""
        hit = 0
        if self.tree is not None:
            hit = self.tree.match(r.tokens).hit_tokens
            self.tree.insert(r.tokens)
            if self.tree.n_nodes > self.max_tree_nodes:
                self._prune_tree()
        # a retry's recompute prefix is prefill work on top of the prompt
        self._net_prefill[r.rid] = r.input_len + self._resume_prefix(r) - hit
        self.stats.prefill_tokens_saved += hit
        self.stats.prefix_hit_requests += hit > 0
        self._qstart[r.rid] = now
        self.queue.append(r)

    # ------------------------------------------------------------ execution
    def start_batch(self, now: float, scheduler: Callable, sched_cfg,
                    profiler=None, monitor=None) -> Optional[float]:
        """Pop one scheduled batch off the queue and run it on the latency
        model (same padded-batch semantics as ``serving.simulate``); returns
        the completion time for the event loop, or None if idle/busy."""
        if self.busy_until > now or not self.queue:
            return None
        fresh = [r for r in self.queue if r.predicted_output_len is None]
        if profiler is not None:
            if fresh:
                profiler.profile(fresh)
        else:
            for r in fresh:
                r.predicted_output_len = r.true_output_len       # oracle
        batches = scheduler(self.queue, sched_cfg)
        b = next((b_ for b_ in batches if b_.requests), None)
        if b is None:
            return None
        chosen = {id(r) for r in b.requests}
        self.queue = [r for b_ in batches for r in b_.requests
                      if id(r) not in chosen]
        if self.defer_finalize:
            # belief-priced service time of this batch, recorded before
            # ``_net_prefill`` is consumed: the straggler mitigator's
            # measured/predicted ratio denominator
            self._batch_pred_s = self._chunk_time(b.requests)
        in_len = b.padded_input
        n = len(b)
        pre_len = max(max(1, self._net_prefill.get(r.rid, r.input_len))
                      for r in b.requests)
        t_pre = self.lm.prefill_time(n, pre_len)
        t_cursor = now + t_pre
        remaining = sorted(b.requests, key=self._eff_out)
        step_start = 0
        dec_steps = 0
        kv_wsum = 0.0
        for r in remaining:
            steps = self._eff_out(r) - step_start
            if steps > 0:
                # speculation-aware like the projections, but *execution*
                # runs on the physics model self.lm — a miscalibrated
                # belief must change decisions, never ground truth
                kv_seg = in_len + step_start + steps / 2
                t_cursor += self._decode_seconds(n, steps, kv_seg,
                                                 lm=self.lm)
                dec_steps += steps
                kv_wsum += steps * kv_seg
                step_start = self._eff_out(r)
            r.start_time = now
            r.first_token_time = now + t_pre
            r.finish_time = t_cursor
            q0 = self._qstart.pop(r.rid, r.arrival)
            bd = LatencyBreakdown(
                queue_wait_s=max(0.0, now - q0), prefill_s=t_pre,
                ttft_s=max(0.0, r.first_token_time - r.arrival),
                decode_s=max(0.0, t_cursor - r.first_token_time),
                e2e_s=r.latency or 0.0)
            rp = self._resume_prefix(r)
            if rp:
                bd.recompute_s = t_pre * rp / (r.input_len + rp)
            r.breakdown = bd
            if self.tracer.enabled:
                self.tracer.span("queued", min(q0, now), now,
                                 track=self.rid, row=ROW_QUEUE,
                                 args={"rid": r.rid})
                self.tracer.instant("admitted", now, track=self.rid,
                                    args={"rid": r.rid})
                if not self.defer_finalize:
                    self.tracer.instant("finish", t_cursor, track=self.rid,
                                        args={"rid": r.rid,
                                              "slo_met": r.slo_met})
            if monitor is not None and not self.defer_finalize:
                monitor.observe(r)
        if self.tracer.enabled:
            from repro_torch.core.scheduler import spec_speedup
            self.tracer.span("batch_prefill", now, now + t_pre,
                             track=self.rid,
                             args={"batch": n, "tokens": pre_len,
                                   "model": self.model})
            # kv/iters/q_tokens let the profiler sink normalize this
            # whole-drain span to per-iteration decode cost at the
            # batch's steps-weighted mean operating point
            iters = dec_steps / spec_speedup(self.spec_tokens,
                                             self.spec_acceptance)
            self.tracer.span("batch_decode", now + t_pre, t_cursor,
                             track=self.rid,
                             args={"batch": n,
                                   "tokens": b.true_padded_output,
                                   "kv": kv_wsum / max(1, dec_steps),
                                   "iters": iters,
                                   "q_tokens": self.spec_tokens + 1,
                                   "model": self.model})
        st = self.stats
        st.batches += 1
        st.prefill_tokens += sum(
            max(1, self._net_prefill.pop(r.rid, r.input_len))
            for r in b.requests)
        if self.defer_finalize:
            # served/busy/SLO accounting waits for the 'done' event (or a
            # crash), so lost work can be reverted without monitor unwind
            self.inflight_reqs = list(b.requests)
            self._batch_t0, self._batch_t1 = now, t_cursor
        else:
            st.served += n
            st.busy_time += t_cursor - now
            st.true_tokens += sum(self._eff_out(r) for r in b.requests)
            for r in b.requests:
                if r.slo_met:
                    st.slo_met += 1
                else:
                    st.slo_missed += 1
        self.busy_until = t_cursor
        self.inflight_blocks = sum(self._blocks_for(r) for r in b.requests)
        self.inflight_slos = [r.slo for r in b.requests]
        return t_cursor

    def finish_batch(self) -> list[Request]:
        """The 'done' event: the in-flight batch's blocks return.  In
        defer-finalize (fault) mode the retained batch is handed back so
        the event loop finalizes each request exactly once — the dedup
        point against a partitioned replica's late finish."""
        self.inflight_blocks = 0
        self.inflight_slos = []
        reqs = self.inflight_reqs
        self.inflight_reqs = []
        if reqs and self.defer_finalize:
            self.stats.busy_time += max(0.0, self._batch_t1 - self._batch_t0)
        return reqs

    def finalize_request(self, r: Request, monitor=None) -> None:
        """Deferred per-request completion accounting (fault mode): the
        stats, finish instant, and monitor observation ``start_batch``
        skipped when ``defer_finalize`` was set."""
        st = self.stats
        st.served += 1
        st.true_tokens += self._eff_out(r)
        if r.slo_met:
            st.slo_met += 1
        else:
            st.slo_missed += 1
        if self.tracer.enabled:
            self.tracer.instant("finish", r.finish_time, track=self.rid,
                                args={"rid": r.rid, "slo_met": r.slo_met})
        if monitor is not None:
            monitor.observe(r)

    # ------------------------------------------------------------ fault path
    def fail(self, now: float) -> tuple[list[Request], list[Request]]:
        """Crash at ``now`` — silently: ``accepting`` stays True until the
        health layer notices.  Returns ``(done, lost)``: requests whose
        padded-batch completion already passed finished before the crash
        and should be finalized normally; the rest carry their estimated
        generated-so-far count in ``Request.generated`` (the retry's
        recompute prefix, interpolated over the decode interval) with
        stamps reset so the re-run replica stamps afresh.  Queued
        (unstarted) work stays in ``self.queue`` for detection-time
        reclaim — an undetected crash hides its backlog too."""
        self.failed_at = now
        done, lost = [], []
        for r in self.inflight_reqs:
            if r.finish_time is not None and r.finish_time <= now:
                done.append(r)
                continue
            rp = self._resume_prefix(r)
            eff = self._eff_out(r)
            ftt, fin = r.first_token_time, r.finish_time
            gen = 0
            if ftt is not None and fin is not None and fin > ftt \
                    and now > ftt:
                gen = int(eff * (now - ftt) / (fin - ftt))
            r.generated = rp + max(0, min(gen, eff - 1))
            r.start_time = r.first_token_time = r.finish_time = None
            r.breakdown = None
            lost.append(r)
        if self.inflight_reqs:
            self.stats.busy_time += max(
                0.0, min(now, self._batch_t1) - self._batch_t0)
        self.inflight_reqs = []
        self.inflight_blocks = 0
        self.inflight_slos = []
        self.busy_until = now
        return done, lost

    def take_queued(self) -> list[Request]:
        """Reclaim unstarted queued work (crash/partition detection)."""
        out = self.queue
        self.queue = []
        for r in out:
            self._qstart.pop(r.rid, None)
            self._net_prefill.pop(r.rid, None)
        return out

    def degrade(self, factor: float) -> None:
        """Straggler injection: physics slow down by ``factor`` while the
        pricing belief keeps the healthy model — exactly the gap the
        per-replica calibration drift and the straggler mitigator must
        attribute to this replica.  ``lm`` is *replaced*, never mutated
        in place: ``price`` usually is the same object, and a belief that
        slowed down with the physics would make the drift invisible."""
        if self._base_lm is None:
            self._base_lm = self.lm
        base = self._base_lm
        self.lm = dataclasses.replace(
            base, efficiency=base.efficiency / factor,
            hbm_bw=base.hbm_bw / factor)

    def heal_degrade(self) -> None:
        if self._base_lm is not None:
            self.lm = self._base_lm
            self._base_lm = None

    def retire(self, now: float) -> None:
        self.retired_at = now
