"""Paged continuous-batching inference engine.  Port of
``repro/serving/paged_engine.py``.

``InferenceEngine.run_continuous`` re-prefills the *entire* slot set on every
admission wave (padded wave prefill, all decode state discarded); this engine
is the production-shaped alternative the paper's batch shaping composes with:

* KV lives in fixed-size physical blocks read through the paged-attention
  kernel (``kernels.paged_attention``); each
  slot owns an ordered block list from a single ``BlockAllocator`` — O(1)
  alloc/free, no per-slot max-length reservation;
* newly admitted sequences are prefilled **individually** (batch of one,
  padded only to the block boundary) and their prompt K/V scattered into
  their blocks while resident slots keep decoding — prefill FLOPs are
  proportional to admitted prompts only;
* with ``chunk_tokens > 0`` prefill is **chunked** (Sarathi-style): an
  admitted prompt is processed ``chunk_tokens`` tokens per engine iteration
  through the continuation-prefill path (``prefix_kv`` gathered from the
  sequence's own blocks), interleaved with one decode step for the resident
  slots — so residents emit a token every iteration and the inter-token
  stall is bounded by one chunk, not one prompt;
* admission is gated on ``BlockAllocator.can_alloc`` over the *worst-case*
  block demand of the candidate — the profiler-predicted output length
  clamped to the decode budget, never the ground-truth ``true_output_len``
  the serving path cannot know — net of blocks already promised to
  residents.  Backpressure lands where the paper's SLO-ODBS
  ``memory_budget`` already operates (``PagedEngineConfig.from_memory_budget``
  sizes the pool from that same budget, so scheduler and allocator agree);
* with ``preempt=True`` block pressure evicts instead of blocking: the
  resident with the most SLO slack is preempted — its blocks freed, the
  request requeued with its generated-so-far tokens as a *recompute prefix*
  (vLLM-style preempt-and-recompute) — so a tight-deadline arrival gets
  capacity without waiting for a slack resident to drain.  Recompute replays
  exactly the tokens already emitted, so outputs stay token-identical.

Physical block 0 is reserved as the *null block*: free slots' (and
mid-prefill slots') block-table rows point at it, so the fixed-batch decode
step stays shape-stable without ever writing into live blocks.

The reference's jitted device ops become plain torch calls that update the
pools in place (the JAX version donates the pool buffers instead): the
prompt scatter is one ``index_put_`` per layer, the copy-on-write fork one
block copy per layer, the prefix gather an index + reshape, and the decode,
verify and prefill steps direct calls into ``models.api``.  The pools are a
list with one {"k": [N, bs, KV, hd], "v": [N, bs, KV, dv]} per layer.

Under a batch-only sharding plan (``plan=``, a mesh set; one process a
device) every rank runs this engine on the same requests.  The host side
(block tables, allocator, prefix tree, drafts) is global and the same on
every rank, and so are the pools: each rank holds all of them.  The decode
and verify steps run each rank's slot rows and write every row's new K/V
into every rank's pools; prefills, prefix continuations and chunks (one
row) run whole on every rank; the logits are gathered before the host's
argmax, so every rank takes the same decisions.  A model or sequence axis,
or an MoE model under batch axes, raises as the reference's engine does
(``_check_plan``).
"""
from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Optional

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core.monitor import Monitor
from repro_torch.core.types import Request
from repro_torch.models import api
from repro_torch.obs.trace import (NULL_TRACER, ROW_QUEUE, LatencyBreakdown,
                                   Tracer, slot_row)
from repro_torch.serving.engine import BatchResult, _sync
from repro_torch.serving.kv_cache import BlockAllocator, kv_block_bytes
from repro_torch.serving.prefix_cache import PrefixCache
from repro_torch.serving.sampling import greedy
from repro_torch.serving.speculative import get_drafter
from repro_torch.sharding.mesh import axis_size, divisible


@dataclass
class PagedEngineConfig:
    max_batch: int = 8
    block_size: int = 16
    n_blocks: int = 128            # physical pool size (incl. the null block)
    max_seq_len: int = 256         # cap on prompt + generated (block-table width)
    max_new_tokens: int = 128
    prefix_cache: bool = False     # radix-tree prefix sharing (prefix_cache.py)
    admit_lookahead: int = 0       # queue entries scanned past a blocked head
    # partial-tail sharing saves tail_len more prefill tokens per hit (a
    # matched partial tail block is forked copy-on-write)
    share_partial_tails: bool = True
    # iteration-level scheduling: per-iteration prefill token budget
    # (rounded up to a block multiple; 0 = whole-prompt prefill at admission)
    chunk_tokens: int = 0
    # SLO-slack preemption under block pressure (preempt-and-recompute)
    preempt: bool = False
    # speculative decoding: draft tokens verified per iteration (0 = off)
    # and the default proposer (serving.speculative.get_drafter name);
    # greedy acceptance keeps outputs token-identical to sequential decode
    spec_tokens: int = 0
    drafter: str = "ngram"

    @classmethod
    def from_memory_budget(cls, cfg: ModelConfig, memory_budget: float,
                           *, dtype_bytes: int = 4, **kw) -> "PagedEngineConfig":
        """Size the physical pool from the scheduler's KV ``memory_budget``
        (SchedulerConfig.memory_budget) so admission control and SLO-ODBS
        batch shaping enforce the same byte ceiling.  The budget buys
        *usable* blocks: the reserved null block is allocator overhead on
        top, so the KV capacity the scheduler packs against equals the
        capacity admission control actually hands out (a budget below one
        block still yields one usable block)."""
        self = cls(**kw)
        bb = kv_block_bytes(cfg, self.block_size, dtype_bytes)
        self.n_blocks = max(1, int(memory_budget // bb)) + 1
        return self

    @property
    def usable_blocks(self) -> int:
        """Blocks available to sequences (total minus the null block)."""
        return self.n_blocks - 1

    @property
    def max_blocks(self) -> int:
        return -(-self.max_seq_len // self.block_size)


@dataclass
class PagedBatchResult(BatchResult):
    prefill_tokens: int = 0        # tokens actually prefilled (block-padded)
    admission_waves: int = 0
    peak_blocks: int = 0           # high-water mark of live blocks
    kv_utilization: float = 0.0    # mean valid-token / allocated-slot ratio
    #   (can exceed 1.0 with the prefix cache: shared blocks hold valid
    #   tokens for several sequences at once)
    waste_vs_padded: float = 0.0   # mean 1 - allocated / max-len reservation
    peak_residents: int = 0        # high-water mark of concurrent sequences
    hol_skips: int = 0             # admissions that jumped a blocked queue head
    # --- prefix-cache accounting (zeros with prefix_cache=False) ---
    prefix_lookups: int = 0
    prefix_hits: int = 0
    prefix_hit_tokens: int = 0     # prompt tokens served from cached blocks
    prefix_evictions: int = 0      # cached blocks reclaimed under pressure
    cow_forks: int = 0             # partial tail blocks forked before writing
    # --- iteration-level scheduling (chunked prefill + preemption) ---
    prefill_chunks: int = 0        # prefill calls issued (1/prompt unchunked)
    prefill_stall_s: float = 0.0   # prefill time spent while >=1 slot decoded
    preemptions: int = 0           # residents evicted for a tighter arrival
    preempted_tokens: int = 0      # generated tokens whose K/V was recomputed
    inter_token_s: list = field(default_factory=list)
    #   wall-clock gaps between consecutive decode emissions per slot (a
    #   speculative iteration emitting n tokens spreads its gap over the n)
    # --- speculative decoding (spec_tokens > 0) ---
    drafted_tokens: int = 0        # draft positions scored by verify passes
    accepted_tokens: int = 0       # drafts matching the target's greedy pick
    spec_rolled_blocks: int = 0    # rejected-tail blocks rolled back
    # --- abort safety (fault tolerance) ---
    aborted: int = 0               # requests aborted mid-flight
    errors: dict = field(default_factory=dict)
    #   rid -> error status ("aborted" / "engine-error"); aborted requests
    #   keep their generated-so-far tokens in ``outputs`` — the recompute
    #   prefix a retry elsewhere resumes from (``run_continuous(resume=)``)

    @property
    def p99_inter_token_s(self) -> float:
        if not self.inter_token_s:
            return float("nan")
        return float(np.percentile(self.inter_token_s, 99))

    @property
    def acceptance_rate(self) -> float:
        """Fraction of drafted tokens the target's greedy walk accepted."""
        return self.accepted_tokens / self.drafted_tokens \
            if self.drafted_tokens else 0.0

    @property
    def generated_tokens(self) -> int:
        return sum(len(v) for v in self.outputs.values())

    @property
    def iterations_per_token(self) -> float:
        """Engine decode iterations per generated token — the decode-latency
        axis speculation compresses (1.0 without it; prefill-emitted first
        tokens make sub-1.0 possible even unspeculated)."""
        n = self.generated_tokens
        return self.steps / n if n else float("nan")


@dataclass
class PrefillProgress:
    """Host-side cursor of one slot's (possibly chunked) prefill."""
    prompt: list                  # tokens to prefill (prompt [+ recompute])
    done: int                     # tokens whose K/V already sits in the pool
    recompute_from: Optional[int] = None
    #   prompt index where replayed (previously generated) tokens start —
    #   chunk time past it is recompute, not first-pass prefill
    resume_tok: Optional[int] = None
    #   preempt-and-recompute: the next input token is already known (the
    #   last token emitted before eviction) — completion restores it instead
    #   of sampling, and no output token is appended


@dataclass
class PagedDecodeState:
    """Host + device state of the paged decode loop: the per-layer pools on
    the device, and the per-slot block tables / lengths / last tokens on the
    host (pushed to the device each step)."""
    pools: list                                  # api.init_paged_pools
    block_tables: np.ndarray                     # [B, max_blocks] int32
    kv_len: np.ndarray                           # [B] int32
    cur_tok: np.ndarray                          # [B] int32 (next input token)
    alloc: BlockAllocator
    null_block: int
    active: list                                 # [B] Optional[Request]
    prefix: Optional[PrefixCache] = None         # radix prefix-sharing tree
    prefilling: dict = field(default_factory=dict)   # slot -> PrefillProgress

    @classmethod
    def create(cls, cfg: ModelConfig, pcfg: PagedEngineConfig,
               dtype=torch.float32, device="cuda") -> "PagedDecodeState":
        pools = api.init_paged_pools(cfg, pcfg.n_blocks, pcfg.block_size,
                                     dtype, device)
        alloc = BlockAllocator(pcfg.n_blocks)
        null = alloc.alloc(-1, 1)[0]             # reserved garbage block
        b, nb = pcfg.max_batch, pcfg.max_blocks
        prefix = PrefixCache(alloc, pcfg.block_size) if pcfg.prefix_cache \
            else None
        return cls(pools=pools,
                   block_tables=np.full((b, nb), null, np.int32),
                   kv_len=np.zeros(b, np.int32),
                   cur_tok=np.zeros(b, np.int32),
                   alloc=alloc, null_block=null,
                   active=[None] * b, prefix=prefix)

    # ------------------------------------------------------------ block ops
    def ensure_blocks(self, slot: int, new_len: int, block_size: int) -> None:
        """Grow slot's block list to cover new_len tokens (O(1) per block)."""
        table = self.alloc.tables.setdefault(slot, [])
        need = -(-new_len // block_size) - len(table)
        if need > 0:
            start = len(table)
            self.alloc.alloc(slot, need)
            self.block_tables[slot, start:start + need] = table[start:]

    def free_slot(self, slot: int) -> None:
        self.alloc.free_seq(slot)
        self.block_tables[slot, :] = self.null_block
        self.kv_len[slot] = 0
        self.cur_tok[slot] = 0
        self.active[slot] = None
        self.prefilling.pop(slot, None)

    @property
    def live_blocks(self) -> int:
        """Blocks held by sequences (excludes the reserved null block)."""
        return self.alloc.used_blocks - 1

    def decoding_slots(self) -> list:
        """Slots past prefill (their next step is a decode token)."""
        return [s for s, r in enumerate(self.active)
                if r is not None and s not in self.prefilling]

    def masked_decode_view(self) -> tuple:
        """(block_tables, kv_len, cur_tok) with mid-prefill slots masked to
        the null block (like free slots) — the decode/verify step must
        neither read their half-written KV nor clobber it, and both steps
        must mask identically or token identity breaks."""
        bt, kv, ct = self.block_tables, self.kv_len, self.cur_tok
        if self.prefilling:
            bt, kv, ct = bt.copy(), kv.copy(), ct.copy()
            for s in self.prefilling:
                bt[s, :] = self.null_block
                kv[s] = 0
                ct[s] = 0
        return bt, kv, ct

    def truncate_blocks(self, slot: int, n_tokens: int,
                        block_size: int) -> int:
        """Shrink a slot's block list to exactly cover ``n_tokens``
        (speculative-rejection rollback); freed table columns point back at
        the null block.  Returns blocks released."""
        keep = -(-n_tokens // block_size)
        dropped = self.alloc.truncate(slot, keep)
        if dropped:
            self.block_tables[slot, keep:] = self.null_block
        return dropped


class PagedEngine:
    """Continuous batching over paged KV blocks.  Greedy decoding, token-
    identical to ``InferenceEngine.run_batch`` for the same requests (the
    decode math only differs in cache addressing; chunked prefill and
    preempt-and-recompute replay the same math, so they preserve it too).
    Serves on the device its parameters live on."""

    def __init__(self, cfg: ModelConfig, params, pcfg: PagedEngineConfig,
                 plan=None,
                 monitor: Optional[Monitor] = None,
                 drafter=None,
                 tracer: Optional[Tracer] = None,
                 track: int = 0,
                 cost_profiler=None,
                 dtype=torch.float32):
        ok, why = api.paged_compatible(cfg)
        if not ok:
            raise ValueError(f"{cfg.name} cannot serve paged: {why}")
        self.cfg = cfg
        self.params = params
        self.pcfg = pcfg
        self.plan = plan
        self.monitor = monitor
        self.device = params.embed.w.device
        # online cost profiler (obs.profile.CostProfiler): receives the
        # measured speculative-acceptance samples directly (span-side cost
        # learning attaches to the tracer, not here)
        self.cost_profiler = cost_profiler
        # lifecycle tracing: a disabled tracer is a no-op at every call, so
        # the engine holds one unconditionally; ``track`` is the replica id
        # this engine's events land on (chrome pid)
        self.tracer = tracer if tracer is not None else NULL_TRACER
        self.track = track
        self.dtype = dtype
        self.drafter = None
        if drafter is not None and pcfg.spec_tokens <= 0:
            raise ValueError(
                "drafter passed but spec_tokens == 0: set "
                "PagedEngineConfig.spec_tokens > 0 to enable speculation")
        if pcfg.spec_tokens > 0:
            self.drafter = drafter if drafter is not None \
                else get_drafter(pcfg.drafter)
        # per-iteration prefill budget, block-aligned so full chunks scatter
        # without padding holes mid-prompt (a hole would be read back as
        # garbage by the next chunk's prefix gather)
        bs = pcfg.block_size
        self._chunk = 0 if pcfg.chunk_tokens <= 0 \
            else -(-pcfg.chunk_tokens // bs) * bs

    def _check_plan(self, first: Request, resumed: Optional[list]) -> None:
        """Raise, before any device work, where the reference's engine
        rejects its plan, with the reference's exception type.  Only a
        batch-only plan serves a dense model.  The reference's first
        prefill (``first``'s first chunk, one row) fails in ``shard_map``
        (ValueError) when its batch axes (more than one shard) split the
        row: in an MoE block, or in the sequence-parallel attention a
        model axis takes when the KV heads do not divide it.  Otherwise a
        model or sequence axis fails at the first decode, verify or
        prefix continuation (NotImplementedError)."""
        plan, cfg = self.plan, self.cfg
        if plan is None:
            return
        n_batch = axis_size(plan.batch_axes)
        if cfg.moe is not None and n_batch > 1:
            raise ValueError(
                f"{cfg.name}: the MoE block splits a prefill's one row over "
                f"the batch axes {plan.batch_axes} ({n_batch} shards)")
        if plan.model_axis is None and not plan.seq_axes:
            return
        n_model = axis_size(plan.model_axis)
        ln = len(first.tokens) + max(len(resumed or ()) - 1, 0)
        first_len = self._padded_len(min(ln, self._chunk or ln))
        if n_batch > 1 and n_model > 1 and first_len % n_model == 0 \
                and not divisible(cfg.n_kv_heads, plan.model_axis):
            raise ValueError(
                f"{cfg.name}: the sequence-parallel prefill over the model "
                f"axis {plan.model_axis!r} ({cfg.n_kv_heads} KV heads over "
                f"{n_model}) splits a prefill's one row over the batch axes "
                f"{plan.batch_axes} ({n_batch} shards)")
        raise NotImplementedError(
            "paged decode: model/seq-sharded plans are not supported yet "
            f"(model axis {plan.model_axis!r}, sequence axes "
            f"{plan.seq_axes}); the paged engine takes batch axes only")

    def _ints(self, a) -> torch.Tensor:
        """Host int array -> int32 tensor on the engine's device."""
        return torch.as_tensor(np.asarray(a, np.int32), device=self.device)

    def _prefill(self, toks: np.ndarray, sn: int, prefix=None):
        """Prefill of one block-padded row (``sn`` valid tokens), continuing
        from ``prefix`` when given.  Returns (logits [1, Vp], cache)."""
        return api.prefill(
            self.cfg, self.params,
            {"tokens": torch.as_tensor(toks, dtype=torch.long,
                                       device=self.device)},
            cache_len=toks.shape[1], kv_len=self._ints([sn]),
            prefix_kv=prefix, plan=self.plan)

    @staticmethod
    def _scatter(pools: list, cache: list, blk: torch.Tensor,
                 off: torch.Tensor) -> None:
        """Write a b=1 prefill cache (one {"k", "v"} [1, cl, KV, hd] per
        layer) into the pools at (blk[t], off[t]), in place."""
        for pool, c in zip(pools, cache):
            pool["k"][blk, off] = c["k"][0]
            pool["v"][blk, off] = c["v"][0]

    @staticmethod
    def _cow_copy(pools: list, src: int, dst: int) -> None:
        """Copy-on-write fork: clone one physical block in every layer."""
        for pool in pools:
            pool["k"][dst].copy_(pool["k"][src])
            pool["v"][dst].copy_(pool["v"][src])

    # --------------------------------------------------------------- admission
    def _worst_blocks(self, r: Request, budget: int, gen: int = 0) -> int:
        """Worst-case block demand the serving path can actually *know*: the
        profiler-predicted ``sched_output_len`` clamped to the decode budget
        (never ``true_output_len`` — admission must not read ground truth),
        floored at ``gen + 1`` so a preempted request's recompute prefix plus
        its next token is always covered."""
        plan_len = min(budget, max(min(r.sched_output_len, budget), gen + 1))
        horizon = len(r.tokens) + plan_len
        return -(-horizon // self.pcfg.block_size)

    @staticmethod
    def _gen_count(outs: Optional[dict], r: Request) -> int:
        return len(outs.get(r.rid, ())) if outs is not None else 0

    def _reserved_remaining(self, st: PagedDecodeState, budget: int,
                            outs: Optional[dict] = None) -> int:
        """Blocks still promised to resident slots beyond what they hold."""
        total = 0
        for slot, r in enumerate(st.active):
            if r is None:
                continue
            held = len(st.alloc.tables.get(slot, []))
            worst = self._worst_blocks(r, budget, self._gen_count(outs, r))
            total += max(0, worst - held)
        return total

    def _prefix_discount(self, st: PagedDecodeState, r: Request
                         ) -> tuple[int, int]:
        """(full-block hits, matched blocks currently cached) for a candidate
        — a peek: no refcounts move, no LRU touch.  Only *full* blocks
        discount demand (a matched partial tail is forked copy-on-write into
        a fresh block, so its slot is still charged)."""
        if st.prefix is None:
            return 0, 0
        m = st.prefix.lookup(r.tokens, peek=True,
                             partial=self.pcfg.share_partial_tails)
        cached = sum(b in st.alloc.cached for b in m.blocks())
        return len(m.full), cached

    def can_admit(self, st: PagedDecodeState, r: Request, budget: int,
                  outs: Optional[dict] = None) -> bool:
        """Worst-case block demand, net of prefix hits: shared full blocks
        are already resident, so cache hits directly buy admission capacity.
        Matched blocks sitting in the evictable cache are excluded from the
        supply — sharing them revives them, they cannot also be evicted."""
        full, cached = self._prefix_discount(st, r)
        worst = self._worst_blocks(r, budget, self._gen_count(outs, r))
        need = max(0, worst - full) \
            + self._reserved_remaining(st, budget, outs)
        return st.alloc.available - cached >= need

    # -------------------------------------------------------------- preemption
    def _slack(self, r: Request, now: float) -> float:
        """Seconds until r's deadline on the trace-replay clock."""
        return r.arrival + r.slo - now

    def _pick_victim(self, st: PagedDecodeState, outs: dict, *,
                     min_slack: float, now: float) -> Optional[int]:
        """Decoding resident with the most SLO slack, if it beats
        ``min_slack`` (the candidate's own slack: preempting someone
        *tighter* than the arrival would trade a violation for a
        violation).  Mid-prefill slots are never victims — their chunks
        would be pure wasted work."""
        best, best_slack = None, min_slack
        for slot in st.decoding_slots():
            s = self._slack(st.active[slot], now)
            if s > best_slack:
                best, best_slack = slot, s
        return best

    def _preempt_gain(self, st: PagedDecodeState, slot: int, budget: int,
                      outs: dict) -> tuple[int, int]:
        """(supply gained, reservations released) if ``slot`` were evicted —
        the dry-run arithmetic behind the admission feasibility precheck.
        Blocks the victim shares with other sequences stay referenced (no
        gain); its exclusive blocks return to the free list, or to the
        evictable cache when the prefix tree retains them (supply only
        while a reclaimer is registered, mirroring
        ``BlockAllocator.available``)."""
        a = st.alloc
        gain = 0
        for b in a.tables.get(slot, []):
            if a.refcnt.get(b, 0) == 1 and (
                    b not in a.retained or a.reclaimer is not None):
                gain += 1
        r = st.active[slot]
        held = len(a.tables.get(slot, []))
        worst = self._worst_blocks(r, budget, self._gen_count(outs, r))
        return gain, max(0, worst - held)

    def _preempt(self, st: PagedDecodeState, slot: int, outs: dict,
                 res: PagedBatchResult, queue: list) -> None:
        """Evict a resident: free its blocks and requeue it right behind the
        queue head with its generated tokens as a recompute prefix (the
        tokens stay in ``outs``; re-admission replays their K/V and resumes
        decoding from the last emitted token)."""
        r = st.active[slot]
        res.preemptions += 1
        res.preempted_tokens += len(outs[r.rid])
        now = time.perf_counter() - self._serve_t0
        bd = self._bd.get(r.rid)
        if bd is not None:
            bd.preemptions += 1
        self._qstart[r.rid] = now        # requeue: a fresh queued interval
        if self.tracer.enabled:
            self.tracer.instant("preempt", now, track=self.track,
                                row=slot_row(slot),
                                args={"rid": r.rid,
                                      "tokens": len(outs[r.rid])})
        if self.drafter is not None:
            self.drafter.release(slot)
        st.free_slot(slot)
        queue.insert(min(1, len(queue)), r)

    def _admit(self, st: PagedDecodeState, queue: list, outs: dict,
               res: PagedBatchResult, budget: int) -> int:
        """Fill free slots from the queue (FIFO).  A too-big queue head only
        blocks admission for ``admit_lookahead == 0``; otherwise up to that
        many later requests are scanned and the first that fits is admitted
        — bounded, so the head cannot starve.  With ``preempt`` a blocked
        head may instead evict resident(s) with more SLO slack than its own.
        Unchunked, each admitted prompt is prefilled to completion here;
        chunked, prefill begins and the main loop interleaves the chunks."""
        admitted = 0
        t0 = time.perf_counter()
        while queue:
            free = [s for s in range(self.pcfg.max_batch)
                    if st.active[s] is None]
            if not free:
                break
            pick = None
            for qi in range(min(len(queue), self.pcfg.admit_lookahead + 1)):
                if self.can_admit(st, queue[qi], budget, outs):
                    pick = qi
                    break
            if pick is None and self.pcfg.preempt:
                head = queue[0]
                now = time.perf_counter() - self._serve_t0
                slack_h = self._slack(head, now)
                eligible = sorted(
                    (s for s in st.decoding_slots()
                     if self._slack(st.active[s], now) > slack_h),
                    key=lambda s: self._slack(st.active[s], now),
                    reverse=True)
                # feasibility precheck: evict only the slack-descending
                # victim prefix that actually buys the head admission —
                # never throw away residents' generated work for zero gain
                full, cached = self._prefix_discount(st, head)
                worst = self._worst_blocks(head, budget,
                                           self._gen_count(outs, head))
                avail = st.alloc.available
                reserved = self._reserved_remaining(st, budget, outs)
                n_evict = 0
                for k, s in enumerate(eligible, start=1):
                    a_gain, r_gain = self._preempt_gain(st, s, budget, outs)
                    avail += a_gain
                    reserved -= r_gain
                    if avail - cached >= max(0, worst - full) + reserved:
                        n_evict = k
                        break
                for s in eligible[:n_evict]:
                    self._preempt(st, s, outs, res, queue)
                if n_evict and self.can_admit(st, head, budget, outs):
                    pick = 0
            if pick is None:
                if self.tracer.enabled:
                    self.tracer.instant(
                        "admission_reject",
                        time.perf_counter() - self._serve_t0,
                        track=self.track,
                        args={"rid": queue[0].rid, "queued": len(queue)})
                break
            if pick:
                res.hol_skips += 1
            r = queue.pop(pick)
            slot = min(s for s in range(self.pcfg.max_batch)
                       if st.active[s] is None)
            st.active[slot] = r
            now = time.perf_counter() - self._serve_t0
            if r.start_time is None:
                r.start_time = max(r.arrival, now)
            bd = self._bd.setdefault(r.rid, LatencyBreakdown())
            qt0 = self._qstart.pop(r.rid, r.arrival)
            bd.queue_wait_s += max(0.0, now - qt0)
            if self.tracer.enabled:
                self.tracer.span("queued", min(qt0, now), now,
                                 track=self.track, row=ROW_QUEUE,
                                 args={"rid": r.rid})
                self.tracer.instant("admitted", now, track=self.track,
                                    row=slot_row(slot),
                                    args={"rid": r.rid, "hol_skip": pick})
            self._begin_prefill(st, slot, r, outs, res)
            if not self._chunk:
                while slot in st.prefilling:
                    self._run_chunk(st, slot, outs, res)
            admitted += 1
            res.peak_residents = max(
                res.peak_residents, sum(a is not None for a in st.active))
        if admitted:
            res.admission_waves += 1
            res.prefill_s += time.perf_counter() - t0
        return admitted

    def _padded_len(self, n: int) -> int:
        bs = self.pcfg.block_size
        return -(-n // bs) * bs

    def _gather_prefix(self, pools: list, blocks: list, p_len: int) -> list:
        """Materialize the cached prefix K/V ({"k": [1, P, KV, hd], ...} per
        layer) from the physical pools for the continuation prefill."""
        idx = torch.as_tensor(blocks, dtype=torch.long, device=self.device)

        def g(pool):
            return pool[idx].reshape(1, -1, *pool.shape[2:])[:, :p_len]
        return [{"k": g(p["k"]), "v": g(p["v"])} for p in pools]

    # ---------------------------------------------------------------- prefill
    def _begin_prefill(self, st: PagedDecodeState, slot: int, r: Request,
                      outs: dict, res: PagedBatchResult) -> None:
        """Open the slot: prefix-cache share/COW, allocate the prompt's
        blocks, and record the chunk cursor.  A preempted request's prompt
        is its original prompt plus all-but-the-last generated token (the
        last one is the resume input, its K/V not yet written)."""
        gen = outs.get(r.rid)
        if gen:
            prompt = list(r.tokens) + gen[:-1]
            resume: Optional[int] = gen[-1]
        else:
            prompt = list(r.tokens)
            resume = None
        ln = len(prompt)
        bs = self.pcfg.block_size
        st.alloc.start_seq(slot)
        p_len = 0
        if st.prefix is not None:
            m = st.prefix.lookup(prompt,
                                 partial=self.pcfg.share_partial_tails)
            if m.hit_tokens:
                st.prefix.share(slot, m)
                p_len = m.hit_tokens
                if m.tail is not None:
                    # the suffix scatter writes into the tail block at
                    # offset tail_len — fork it first if anyone else
                    # (tree or sibling sequence) can still read it
                    new = st.alloc.cow(slot, m.tail.block)
                    if new != m.tail.block:
                        self._cow_copy(st.pools, m.tail.block, new)
                        res.cow_forks += 1
                        if self.tracer.enabled:
                            self.tracer.instant(
                                "cow_fork",
                                time.perf_counter() - self._serve_t0,
                                track=self.track, row=slot_row(slot),
                                args={"rid": r.rid, "src": m.tail.block,
                                      "dst": new})
        st.ensure_blocks(slot, ln, bs)
        table = st.alloc.tables[slot]
        st.block_tables[slot, :len(table)] = table
        st.prefilling[slot] = PrefillProgress(
            prompt=prompt, done=p_len,
            recompute_from=len(r.tokens) if gen else None,
            resume_tok=resume)

    def _run_chunk(self, st: PagedDecodeState, slot: int, outs: dict,
                   res: PagedBatchResult) -> bool:
        """Prefill the slot's next chunk (whole remaining suffix when
        unchunked).  Returns True when the prompt completes — kv_len is set,
        the prompt chain published, and the first output token emitted
        (or the preempted resume token restored)."""
        pg: PrefillProgress = st.prefilling[slot]
        r = st.active[slot]
        prompt, ln = pg.prompt, len(pg.prompt)
        bs = self.pcfg.block_size
        table = st.alloc.tables[slot]
        remaining = ln - pg.done
        sn = remaining if not self._chunk else min(remaining, self._chunk)
        start = pg.done
        tc0 = time.perf_counter()
        cl = self._padded_len(sn)
        toks = np.zeros((1, cl), np.int32)
        toks[0, :sn] = prompt[pg.done:pg.done + sn]
        pref = None
        if pg.done:
            n_blk = -(-pg.done // bs)
            pref = self._gather_prefix(st.pools, table[:n_blk], pg.done)
        logits, cache = self._prefill(toks, sn, pref)
        pos = pg.done + np.arange(cl)
        blk = np.asarray([table[p // bs] if p < ln
                          else st.null_block for p in pos], np.int64)
        self._scatter(st.pools, cache,
                      torch.as_tensor(blk, device=self.device),
                      torch.as_tensor(pos % bs, device=self.device))
        pg.done += sn
        res.prefill_tokens += cl
        res.prefill_chunks += 1
        if pg.done < ln:
            self._chunk_telemetry(r, pg, slot, start, sn, tc0)
            return False
        del st.prefilling[slot]
        st.kv_len[slot] = ln
        if st.prefix is not None:
            # publish the prompt's full blocks so same-prefix requests
            # admitted while this one decodes already hit them
            st.prefix.insert(prompt, table, (ln // bs) * bs)
        if pg.resume_tok is not None:
            st.cur_tok[slot] = pg.resume_tok
        else:
            first = int(greedy(logits, self.cfg.vocab_size)[0])
            st.cur_tok[slot] = first
            outs[r.rid] = [first]
            r.first_token_time = max(
                r.arrival, time.perf_counter() - self._serve_t0)
            bd = self._bd.get(r.rid)
            if bd is not None:
                bd.ttft_s = max(0.0, r.first_token_time - r.arrival)
        # reset the slot's inter-token stamp: None marks a fresh sequence,
        # so neither a previous occupant's stale stamp nor the wave-start
        # first-token gap (TTFT, with its one-time sync costs) pollutes the
        # decode-gap series — gaps count between consecutive decode steps
        self._last_emit[slot] = None
        self._chunk_telemetry(r, pg, slot, start, sn, tc0)
        return True

    def _chunk_telemetry(self, r: Request, pg: PrefillProgress, slot: int,
                         start: int, sn: int, tc0: float) -> None:
        """Per-chunk latency attribution + trace span: chunk wall time lands
        in the request's breakdown (split into first-pass prefill vs replayed
        recompute by token overlap) and on the slot's timeline row."""
        tc1 = time.perf_counter()
        dt = tc1 - tc0
        bd = self._bd.get(r.rid)
        if bd is not None:
            bd.prefill_s += dt
            rf, ln = pg.recompute_from, len(pg.prompt)
            if rf is not None and sn:
                rec = max(0, min(start + sn, ln) - max(start, rf))
                bd.recompute_s += dt * rec / sn
        if self.tracer.enabled:
            self.tracer.span(
                "prefill_chunk", tc0 - self._serve_t0, tc1 - self._serve_t0,
                track=self.track, row=slot_row(slot),
                args={"rid": r.rid, "tokens": sn, "done": pg.done,
                      "total": len(pg.prompt),
                      "recompute": pg.recompute_from is not None})

    # ------------------------------------------------------------ speculative
    def _spec_step(self, st: PagedDecodeState, decoding: list, outs: dict,
                   res: PagedBatchResult, drafts: np.ndarray,
                   win: np.ndarray) -> None:
        """One speculative iteration: score the current input token plus the
        drafted window in a single multi-token verify pass, accept the
        longest draft prefix matching the target's own greedy choices, and
        roll back the rejected tail's blocks.

        Every window position's K/V is scattered by the verify step; only
        positions backing *emitted* tokens stay referenced — rejected
        positions sit beyond the advanced ``kv_len``, are rolled back at
        block granularity here, and any surviving stale slots are
        overwritten by the next iteration's writes before ``kv_len`` ever
        reaches them, so no rollback of pool *contents* is needed."""
        bs = self.pcfg.block_size
        b = self.pcfg.max_batch
        t_w = self.pcfg.spec_tokens + 1
        ts0 = time.perf_counter()
        bt, kv, ct = st.masked_decode_view()
        win_eff = np.zeros(b, np.int32)
        for slot in decoding:
            win_eff[slot] = win[slot]
        toks = np.zeros((b, t_w), np.int32)
        toks[:, 0] = ct
        toks[:, 1:] = drafts
        # host-side scatter targets: window position t of slot s lands at
        # logical position kv+t -> (table[(kv+t)//bs], (kv+t)%bs); invalid
        # positions (masked slot, past the slot's window) go to the null
        # block so the batched write never touches live blocks
        pos = kv[:, None] + np.arange(t_w)[None, :]
        valid = np.arange(t_w)[None, :] < win_eff[:, None]
        blk_idx = np.minimum(pos // bs, bt.shape[1] - 1)
        blk = np.take_along_axis(bt, blk_idx, axis=1)
        blk = np.where(valid, blk, st.null_block).astype(np.int32)
        off = np.where(valid, pos % bs, 0).astype(np.int32)
        logits, st.pools = api.paged_spec_step(
            self.cfg, self.params,
            torch.as_tensor(toks, dtype=torch.long, device=self.device),
            st.pools, self._ints(bt), self._ints(kv), self._ints(blk),
            self._ints(off), plan=self.plan)
        g = greedy(logits.reshape(b * t_w, -1),
                   self.cfg.vocab_size).cpu().numpy().reshape(b, t_w)
        now = time.perf_counter()
        for slot in decoding:
            r = st.active[slot]
            k_eff = int(win[slot]) - 1
            j = 0
            while j < k_eff and int(drafts[slot, j]) == int(g[slot, j]):
                j += 1
            n_emit = j + 1           # accepted drafts + the bonus token
            emitted = [int(x) for x in g[slot, :n_emit]]
            outs[r.rid].extend(emitted)
            st.cur_tok[slot] = emitted[-1]
            st.kv_len[slot] += n_emit
            res.drafted_tokens += k_eff
            res.accepted_tokens += j
            if self.cost_profiler is not None and k_eff > 0:
                # measured acceptance: the live signal that retires the
                # static planning prior in launch/serve.py
                self.cost_profiler.observe_acceptance(j, k_eff)
            res.spec_rolled_blocks += st.truncate_blocks(
                slot, int(st.kv_len[slot]), bs)
            prev = self._last_emit.get(slot)
            if prev is not None:
                gap = (now - prev) / n_emit
                res.inter_token_s.extend([gap] * n_emit)
            self._last_emit[slot] = now
            if self.tracer.enabled:
                # a window of 1 (no drafts proposed) is a plain decode
                # iteration routed through the verify kernel — name it so
                self.tracer.span(
                    "verify" if k_eff > 0 else "decode",
                    ts0 - self._serve_t0, now - self._serve_t0,
                    track=self.track, row=slot_row(slot),
                    args={"rid": r.rid, "drafted": k_eff, "accepted": j,
                          "emitted": n_emit, "batch": len(decoding),
                          "kv": float(np.mean(kv[decoding])),
                          "q_tokens": t_w})

    # ------------------------------------------------------------- abort path
    def _abort(self, st: PagedDecodeState, slot: int, r: Request,
               outs: dict, res: PagedBatchResult) -> None:
        """Mid-flight abort (injected crash / client cancel): free the
        slot's blocks and prefix references, keep the generated-so-far
        tokens in ``outputs`` (they are the recompute prefix a retry on
        another engine resumes from), and mark the request errored — it
        never reaches ``_finish``, so no finish time is stamped and the
        monitor never counts it served."""
        if self.drafter is not None:
            self.drafter.release(slot)
        st.free_slot(slot)
        outs.setdefault(r.rid, [])
        res.errors[r.rid] = "aborted"
        res.aborted += 1
        self._bd.pop(r.rid, None)
        self._qstart.pop(r.rid, None)

    def _sweep_aborts(self, st: PagedDecodeState, queue: list, outs: dict,
                      res: PagedBatchResult, abort_at: dict) -> None:
        """Trigger pending aborts: an active request aborts once it has
        emitted ``abort_at[rid]`` tokens (0 = at admission, mid-prefill
        included); a queued one with threshold <= 0 aborts unadmitted."""
        for slot, r in enumerate(st.active):
            if r is not None and r.rid in abort_at and \
                    len(outs.get(r.rid, ())) >= abort_at[r.rid]:
                self._abort(st, slot, r, outs, res)
        for r in [q for q in queue if abort_at.get(q.rid, 1) <= 0]:
            queue.remove(r)
            outs.setdefault(r.rid, [])
            res.errors[r.rid] = "aborted"
            res.aborted += 1

    # ------------------------------------------------------------------ serve
    def run_continuous(self, requests: list, *,
                       max_new: Optional[int] = None,
                       abort_at: Optional[dict] = None,
                       resume: Optional[dict] = None) -> PagedBatchResult:
        """Serve all requests with continuous batching: finished slots free
        their blocks and are refilled (subject to block backpressure) while
        the rest keep decoding.  Greedy; request i stops after
        min(true_output_len, budget) generated tokens.

        ``abort_at`` maps rid -> generated-token count at which the request
        is aborted mid-flight (fault injection / client cancel): its blocks
        and prefix refs are freed, its partial output stays in ``outputs``,
        and ``errors[rid] == "aborted"`` marks it failed.  ``resume`` maps
        rid -> previously generated tokens (e.g. an aborted run's partial
        output): admission replays them as a recompute prefix through the
        preempt-and-recompute path, so a request crashed on one engine and
        resumed on another stays token-identical to an unfailed run."""
        res = PagedBatchResult()
        budget = max_new or self.pcfg.max_new_tokens
        for r in requests:
            # capacity guards use the decode *budget*, not the ground-truth
            # output length: a request must be able to run alone to its
            # budgeted horizon whatever its true length turns out to be
            horizon = len(r.tokens) + budget
            if horizon > self.pcfg.max_seq_len:
                raise ValueError(
                    f"request {r.rid}: prompt {len(r.tokens)} + decode "
                    f"budget exceeds max_seq_len {self.pcfg.max_seq_len}")
            wb = -(-horizon // self.pcfg.block_size)
            if wb > self.pcfg.usable_blocks:
                raise ValueError(
                    f"request {r.rid}: needs {wb} blocks, pool has "
                    f"{self.pcfg.usable_blocks} usable")
        if requests:
            self._check_plan(requests[0], (resume or {}).get(requests[0].rid))
        st = PagedDecodeState.create(self.cfg, self.pcfg, self.dtype,
                                     self.device)
        queue = list(requests)
        outs: dict[int, list[int]] = {}
        if resume:
            # seed partial outputs so _begin_prefill replays them as a
            # recompute prefix (prompt + gen[:-1], resume on gen[-1])
            rids = {r.rid for r in requests}
            outs.update({rid: list(toks) for rid, toks in resume.items()
                         if rid in rids and toks})
        util_sum = waste_sum = 0.0
        util_n = 0
        peak_live = -1
        peak_pool_stats: Optional[dict] = None
        self._last_emit = {}                  # slot -> last emission stamp
        self._bd = {}                         # rid -> LatencyBreakdown
        self._qstart = {r.rid: r.arrival for r in requests}
        self._stalls: list = []               # per-chunk decode-stall samples
        rr = 0                                # chunk round-robin cursor
        # _admit accrues res.prefill_s itself (mid-run waves included);
        # decode_s is the remainder of the serving wall clock
        t_total = time.perf_counter()
        self._serve_t0 = t_total
        if queue:
            self._admit(st, queue, outs, res, budget)
        steps = 0
        while True:
            if abort_at:
                # injected aborts fire before finishes: an abort threshold
                # already reached must not race the stop count into _finish
                self._sweep_aborts(st, queue, outs, res, abort_at)
                if queue and any(a is None for a in st.active):
                    self._admit(st, queue, outs, res, budget)
            # a) finish/admit fixpoint: retiring slots frees blocks which can
            #    admit new prompts, whose stop count may already be met by
            #    their prefill token (stop==1) — loop until stable so the
            #    decode step below never runs a completed sequence
            progress = True
            while progress:
                progress = False
                for slot, r in enumerate(st.active):
                    if r is not None and slot not in st.prefilling \
                            and len(outs[r.rid]) >= min(
                                r.true_output_len, budget):
                        self._finish(st, slot, r, outs)
                        progress = True
                if progress and queue:
                    self._admit(st, queue, outs, res, budget)
            # iteration-level admission: with chunking or preemption the
            # queue is reconsidered every iteration, not only on finishes —
            # chunked admissions just open a cursor (cheap), and preemption
            # must see tight arrivals while slack residents still decode
            if queue and (self._chunk or self.pcfg.preempt) \
                    and any(a is None for a in st.active):
                self._admit(st, queue, outs, res, budget)
            if not any(a is not None for a in st.active):
                break
            # b) one prefill chunk (chunked mode; unchunked prompts complete
            #    inside _admit).  Multiple mid-prefill slots take turns, so
            #    per-iteration prefill work stays <= one chunk
            if st.prefilling:
                pre_slots = sorted(st.prefilling)
                slot = pre_slots[rr % len(pre_slots)]
                rr += 1
                had_decoders = bool(st.decoding_slots())
                t0 = time.perf_counter()
                self._run_chunk(st, slot, outs, res)
                dt = time.perf_counter() - t0
                res.prefill_s += dt
                if had_decoders:
                    res.prefill_stall_s += dt
                    self._stalls.append(dt)
            decoding = st.decoding_slots()
            # just-admitted (or just-completed-prefill) sequences may already
            # be at their stop count — let the fixpoint retire them before
            # they join a decode step
            decoding = [s for s in decoding
                        if len(outs[st.active[s].rid]) < min(
                            st.active[s].true_output_len, budget)]
            if not decoding:
                continue
            # c) speculative draft window: propose *before* block growth so
            #    the grower knows the full write horizon.  Per-slot draft
            #    width is capped by the tokens the request may still emit
            #    and by its block-table width, so a near-finished or
            #    near-max_seq sequence never drafts past its own end
            k_spec = self.pcfg.spec_tokens
            win = np.ones(self.pcfg.max_batch, np.int32)
            drafts: Optional[np.ndarray] = None
            if k_spec > 0:
                drafts = np.zeros((self.pcfg.max_batch, k_spec), np.int32)
                win = np.zeros(self.pcfg.max_batch, np.int32)
                for slot in decoding:
                    r = st.active[slot]
                    m = min(r.true_output_len, budget) - len(outs[r.rid])
                    cap = min(k_spec, m - 1,
                              self.pcfg.max_seq_len
                              - int(st.kv_len[slot]) - 1)
                    props = [] if cap <= 0 else self.drafter.propose(
                        slot, list(r.tokens) + outs[r.rid], cap)
                    props = [int(t) for t in props[:max(cap, 0)]]
                    drafts[slot, :len(props)] = props
                    win[slot] = 1 + len(props)
            #    grow block lists to cover the token(s) about to be written;
            #    exhaustion first sheds the draft window (speculation must
            #    never force an eviction), then under misprediction preempts
            #    the slack-most resident (possibly the grower itself)
            for slot in list(decoding):
                if st.active[slot] is None:
                    continue
                while True:
                    try:
                        st.ensure_blocks(slot,
                                         int(st.kv_len[slot])
                                         + int(win[slot]),
                                         self.pcfg.block_size)
                        break
                    except MemoryError:
                        if win[slot] > 1:
                            win[slot] = 1
                            drafts[slot, :] = 0
                            continue
                        if not self.pcfg.preempt:
                            raise MemoryError(
                                "KV pool exhausted mid-decode (output "
                                "longer than predicted); enable preempt "
                                "to evict-and-recompute instead") from None
                        now = time.perf_counter() - self._serve_t0
                        victim = self._pick_victim(
                            st, outs, min_slack=float("-inf"), now=now)
                        if victim is None or (
                                victim == slot and
                                sum(a is not None for a in st.active) == 1):
                            raise
                        self._preempt(st, victim, outs, res, queue)
                        if victim == slot:
                            break
            decoding = [s for s in decoding if st.active[s] is not None]
            if not decoding:
                continue
            # d) KV gauges at the allocation high-water mark (post-growth)
            live = st.live_blocks
            res.peak_blocks = max(res.peak_blocks, live)
            if live >= peak_live:
                peak_live = live
                peak_pool_stats = st.alloc.stats()
            valid = int(st.kv_len[[i for i, a in enumerate(st.active)
                                   if a is not None]].sum())
            alloc_slots = live * self.pcfg.block_size
            n_active = sum(a is not None for a in st.active)
            if alloc_slots:
                util_sum += valid / alloc_slots
                waste_sum += 1.0 - alloc_slots / (n_active *
                                                  self.pcfg.max_seq_len)
                util_n += 1
            # e) one fixed-shape decode step over all slots; mid-prefill
            #    slots are masked to the null block (like free slots) so
            #    their half-written KV is neither read nor clobbered.  With
            #    speculation the step is a verify pass scoring the input
            #    token plus the drafts in one multi-token kernel call
            if k_spec > 0:
                self._spec_step(st, decoding, outs, res, drafts, win)
                steps += 1
                continue
            td0 = time.perf_counter()
            bt, kv, ct = st.masked_decode_view()
            logits, st.pools = api.paged_decode_step(
                self.cfg, self.params,
                torch.as_tensor(ct[:, None], dtype=torch.long,
                                device=self.device),
                st.pools, self._ints(bt), self._ints(kv), plan=self.plan)
            nxt = greedy(logits, self.cfg.vocab_size).cpu().numpy()
            steps += 1
            now = time.perf_counter()
            for slot in decoding:
                r = st.active[slot]
                outs[r.rid].append(int(nxt[slot]))
                st.cur_tok[slot] = int(nxt[slot])
                st.kv_len[slot] += 1
                prev = self._last_emit.get(slot)
                if prev is not None:
                    res.inter_token_s.append(now - prev)
                self._last_emit[slot] = now
                if self.tracer.enabled:
                    self.tracer.span(
                        "decode", td0 - self._serve_t0,
                        now - self._serve_t0, track=self.track,
                        row=slot_row(slot),
                        args={"rid": r.rid, "token": int(nxt[slot]),
                              "batch": len(decoding),
                              "kv": float(np.mean(kv[decoding])),
                              "q_tokens": 1})
        _sync(self.device)
        # leak audit: every slot was finished or aborted, so the allocator
        # must be down to exactly the reserved null block — proven zero
        # leakage even across abort/preempt/speculative-rollback paths
        leaks = st.alloc.check(expect_used=1)
        if leaks:
            raise RuntimeError(
                "KV block leak after serve: " + "; ".join(leaks))
        res.decode_s = time.perf_counter() - t_total - res.prefill_s
        res.steps = steps
        res.outputs = outs
        if util_n:
            res.kv_utilization = util_sum / util_n
            res.waste_vs_padded = waste_sum / util_n
        if st.prefix is not None:
            ps = st.prefix.stats
            res.prefix_lookups = ps.lookups
            res.prefix_hits = ps.hits
            res.prefix_hit_tokens = ps.hit_tokens
            res.prefix_evictions = ps.evicted_blocks
        if self.monitor is not None:
            if util_n:
                self.monitor.observe_kv(res.kv_utilization,
                                        res.waste_vs_padded)
            # gauges snapshot the pool at its occupancy high-water mark —
            # post-drain stats would always show an empty pool
            self.monitor.observe_pool(
                peak_pool_stats or st.alloc.stats(),
                fragmentation=max(0.0, 1.0 - res.kv_utilization)
                if util_n else 0.0)
            if st.prefix is not None:
                self.monitor.observe_prefix(st.prefix.stats,
                                            cow_forks=res.cow_forks)
            self.monitor.observe_interleave(
                stall_s=res.prefill_stall_s, chunks=res.prefill_chunks,
                preemptions=res.preemptions,
                preempted_tokens=res.preempted_tokens,
                stalls=self._stalls, itl=res.inter_token_s)
        return res

    def _finish(self, st: PagedDecodeState, slot: int, r: Request,
                outs: dict) -> None:
        if st.prefix is not None:
            # publish the full chain — prompt plus the generated tokens
            # whose K/V was written (all but the last emitted token) — so a
            # multi-turn follow-up whose prompt embeds this answer hits it;
            # the non-aligned remainder becomes a COW-shareable partial leaf
            n_kv = int(st.kv_len[slot])
            chain = list(r.tokens) + outs[r.rid][:n_kv - len(r.tokens)]
            st.prefix.insert(chain, st.alloc.tables[slot], n_kv)
        if self.drafter is not None:
            self.drafter.release(slot)
        st.free_slot(slot)
        if r.finish_time is None:
            # trace-replay clock: serve start is t=0 of the workload's
            # arrival timeline, so wall-clock completion and synthetic
            # arrival share one axis (clamped: a request cannot finish
            # before it arrives).  Feeds the monitor's unified SLO counters;
            # meaningful when the engine replays a trace near real time —
            # a much faster replay degenerates to latency 0 (SLO met)
            r.finish_time = max(r.arrival,
                                time.perf_counter() - self._serve_t0)
        bd = self._bd.pop(r.rid, None)
        if bd is not None:
            bd.e2e_s = r.latency or 0.0
            if r.first_token_time is not None:
                bd.decode_s = max(0.0, r.finish_time - r.first_token_time)
            r.breakdown = bd
        if self.tracer.enabled:
            self.tracer.instant(
                "finish", max(r.arrival,
                              time.perf_counter() - self._serve_t0),
                track=self.track, row=slot_row(slot),
                args={"rid": r.rid, "tokens": len(outs[r.rid]),
                      "slo_met": r.slo_met})
        if self.monitor is not None:
            self.monitor.observe(r)
