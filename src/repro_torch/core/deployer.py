"""LLM deployer (paper §4.3), UELLM's third component.

Own copy of ``repro/core/deployer.py``.  Two faces:

1. ``helr`` — the paper's Algorithm 2, cleaned up: an exact bitmask dynamic
   program over the accelerator topology graph G=(D,E).  State = (device
   subset, last device on the pipeline path); transition cost = link latency
   + p·layers·m/performance, with layers assigned greedily along the path
   (the fill total is order-independent, so the DP is exact for this policy).
   ``a1`` weights the latency term, ``a2`` the resource-count term:
     * HE  (a1=0): fewest devices that satisfy memory — utilization-optimal.
     * LR  (a1≫a2): latency-optimal regardless of device count.
     * HELR: balanced.
   Baseline ``bgs`` = the greedy scheduler the paper compares against.

2. ``helr_mesh`` — the search over the fixed production mesh: nodes become
   mesh slices, link latencies become link classes, and the output is a
   ShardingPlan + ParallelismDesc.  The candidate set is the plans
   expressible on that mesh; scoring uses the analytic cost model; memory
   feasibility uses the device memory.  The mesh is still the reference's
   TPU mesh, 256 chips a pod as (data=16, model=16); every plan is priced at
   the ``hw`` it was searched with (the port's ``H100`` by default): its
   FLOP/s, its HBM, and the link class each collective's group crosses.  On
   H100s a group of 16 spans two 8-GPU NVLink boards, so every collective of
   these plans goes over InfiniBand.  ``MeshPlan`` keeps that ``hw``: the
   reference's ``step_time`` prices at its default hardware whatever ``hw``
   the search was given.

Scalability: exact DP up to ``EXACT_DP_MAX`` devices; beyond that the
topology is clustered into islands (pods / NUMA domains) and the DP runs
hierarchically — islands first, then devices within the chosen islands.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Sequence

from repro_torch.configs.base import H100, HWSpec, ModelConfig, ShapeConfig
from repro_torch.core.types import DeviceMap, DeviceNode
from repro_torch.perf.cost_model import CostTerms, ParallelismDesc, step_cost
from repro_torch.sharding.plan import ShardingPlan

EXACT_DP_MAX = 14


@dataclass(frozen=True)
class HELRConfig:
    a1: float = 1.0            # latency weight
    a2: float = 1.0            # resource-count weight
    # performance-time scale (paper Eq. 5).  Eq. 5 is written per token;
    # serving amortizes link latency over the batch width, so p defaults to a
    # typical batch (8) — otherwise the DP over-weights link hops vs compute.
    p: float = 8.0
    kv_reserve: float = 0.2    # fraction of device memory reserved for KV (T)


def _caps(nodes: Sequence[DeviceNode], model_mem: float, n_layers: int,
          cfg: HELRConfig) -> list[int]:
    m = model_mem / max(n_layers, 1)
    return [max(0, int((d.memory * (1 - cfg.kv_reserve)) // m)) for d in nodes]


def helr(model_mem: float, n_layers: int, nodes: Sequence[DeviceNode],
         latency: Sequence[Sequence[float]], cfg: HELRConfig = HELRConfig()
         ) -> DeviceMap:
    """Exact (≤ EXACT_DP_MAX devices) or hierarchical device-map search."""
    if len(nodes) > EXACT_DP_MAX:
        return _helr_hierarchical(model_mem, n_layers, nodes, latency, cfg)
    return _helr_exact(model_mem, n_layers, nodes, latency, cfg)


def _helr_exact(model_mem, n_layers, nodes, latency, cfg) -> DeviceMap:
    n = len(nodes)
    caps = _caps(nodes, model_mem, n_layers, cfg)
    m = model_mem / max(n_layers, 1)
    if sum(caps) < n_layers:
        return DeviceMap()                      # infeasible
    # filled(mask) is order-independent: min(L, sum caps in mask)
    filled = [0] * (1 << n)
    for mask in range(1 << n):
        filled[mask] = min(n_layers,
                           sum(caps[i] for i in range(n) if mask >> i & 1))

    def assigned(mask_before: int, j: int) -> int:
        return min(caps[j], n_layers - filled[mask_before])

    def compute_t(j: int, layers: int) -> float:
        return cfg.p * layers * m / nodes[j].performance

    INF = float("inf")
    dp = [[INF] * n for _ in range(1 << n)]
    for i in range(n):
        dp[1 << i][i] = compute_t(i, assigned(0, i))
    best = DeviceMap()
    parent: dict[tuple[int, int], tuple[int, int]] = {}
    unit = cfg.p * m / max(sum(d.performance for d in nodes) / n, 1e-9)

    for mask in range(1, 1 << n):
        for i in range(n):
            if not (mask >> i & 1) or dp[mask][i] == INF:
                continue
            if filled[mask] >= n_layers:
                # epsilon latency term breaks count ties (matters for HE)
                score = cfg.a1 * dp[mask][i] + cfg.a2 * bin(mask).count("1") * unit \
                    + 1e-6 * dp[mask][i]
                if score < best.est_latency:
                    best = _trace(mask, i, parent, nodes, caps, n_layers, dp)
                    best.est_latency = score
                continue
            for j in range(n):
                if mask >> j & 1:
                    continue
                nm = mask | (1 << j)
                cost = dp[mask][i] + latency[i][j] + compute_t(j, assigned(mask, j))
                if cost < dp[nm][j]:
                    dp[nm][j] = cost
                    parent[(nm, j)] = (mask, i)
    return best


def _trace(mask, last, parent, nodes, caps, n_layers, dp) -> DeviceMap:
    path = []
    cur = (mask, last)
    while cur in parent:
        path.append(cur[1])
        cur = parent[cur]
    path.append(cur[1])
    path.reverse()
    layers, rem = {}, n_layers
    for d in path:
        take = min(caps[d], rem)
        layers[d] = take
        rem -= take
    dm = DeviceMap(path=path, layers=layers)
    dm.est_util = n_layers / max(sum(caps[d] for d in path), 1)
    return dm


def _helr_hierarchical(model_mem, n_layers, nodes, latency, cfg) -> DeviceMap:
    """Cluster devices into islands (by name prefix else contiguous blocks),
    DP over islands with aggregated capacity/perf, then DP within islands."""
    n = len(nodes)
    k = min(EXACT_DP_MAX, max(2, math.ceil(n / EXACT_DP_MAX)))
    size = math.ceil(n / k)
    islands = [list(range(i, min(i + size, n))) for i in range(0, n, size)]
    m = model_mem / max(n_layers, 1)
    agg_nodes = []
    for gi, isl in enumerate(islands):
        # aggregate capacity as the SUM OF FLOORED per-node layer caps so the
        # top-level plan never promises an island more than its members hold
        cap_layers = sum(max(0, int((nodes[i].memory * (1 - cfg.kv_reserve)) // m))
                         for i in isl)
        agg_nodes.append(DeviceNode(
            node_id=gi,
            memory=cap_layers * m / max(1 - cfg.kv_reserve, 1e-9),
            performance=sum(nodes[i].performance for i in isl),
            name=f"island{gi}"))
    agg_lat = [[max(latency[a][b] for a in islands[i] for b in islands[j])
                if i != j else 0.0
                for j in range(len(islands))] for i in range(len(islands))]
    top = _helr_exact(model_mem, n_layers, agg_nodes, agg_lat, cfg)
    # expand islands: run exact DP inside each selected island on its share
    path, layers = [], {}
    for gi in top.path:
        share = top.layers.get(gi, 0)
        if share <= 0:
            continue
        isl = islands[gi]
        sub_nodes = [nodes[i] for i in isl]
        sub_lat = [[latency[a][b] for b in isl] for a in isl]
        sub_mem = model_mem * share / max(n_layers, 1)
        sub = _helr_exact(sub_mem, share, sub_nodes, sub_lat, cfg)
        for local_id in sub.path:
            gid = isl[local_id]
            path.append(gid)
            layers[gid] = sub.layers.get(local_id, 0)
    # top-up pass: flooring inside islands can strand a few layers — place
    # them on path devices with spare capacity
    short = n_layers - sum(layers.values())
    if short > 0:
        for gid in path:
            cap = max(0, int((nodes[gid].memory * (1 - cfg.kv_reserve)) // m))
            spare = cap - layers.get(gid, 0)
            take = min(spare, short)
            layers[gid] = layers.get(gid, 0) + take
            short -= take
            if short <= 0:
                break
    dm = DeviceMap(path=path, layers=layers, est_latency=top.est_latency)
    return dm


def default_even_deploy(model_mem: float, n_layers: int,
                        nodes: Sequence[DeviceNode], latency,
                        cfg: HELRConfig = HELRConfig()) -> DeviceMap:
    """The framework-default device map the paper's baselines inherit
    (accelerate-style): spread layers EVENLY across every visible device,
    power-throttled stragglers included."""
    n = len(nodes)
    per = n_layers // n
    layers = {i: per + (1 if i < n_layers % n else 0) for i in range(n)}
    return DeviceMap(path=list(range(n)), layers=layers)


def bgs(model_mem: float, n_layers: int, nodes: Sequence[DeviceNode],
        latency, cfg: HELRConfig = HELRConfig()) -> DeviceMap:
    """Baseline Greedy Scheduling: fastest devices first until memory fits;
    layers proportional to memory (paper §5.3 baseline)."""
    order = sorted(range(len(nodes)), key=lambda i: -nodes[i].performance)
    caps = _caps(nodes, model_mem, n_layers, cfg)
    path, layers, rem = [], {}, n_layers
    for i in order:
        if rem <= 0:
            break
        take = min(caps[i], rem)
        if take <= 0:
            continue
        path.append(i)
        layers[i] = take
        rem -= take
    if rem > 0:
        return DeviceMap()
    return DeviceMap(path=path, layers=layers)


def he(model_mem, n_layers, nodes, latency) -> DeviceMap:
    return helr(model_mem, n_layers, nodes, latency, HELRConfig(a1=0.0, a2=1.0))


def lr(model_mem, n_layers, nodes, latency) -> DeviceMap:
    return helr(model_mem, n_layers, nodes, latency, HELRConfig(a1=10.0, a2=1.0))


DEPLOYERS = {"helr": helr, "he": he, "lr": lr, "bgs": bgs,
             "default": default_even_deploy}


# ===================================================================== mesh

@dataclass
class MeshPlan:
    """A deployable plan on the fixed production mesh, priced at ``hw``."""
    name: str
    plan: ShardingPlan
    desc: ParallelismDesc
    cost: CostTerms
    fits: bool
    hbm_used: float
    hw: HWSpec

    @property
    def step_time(self) -> float:
        t = self.cost.times(self.hw)
        return sum(t.values())


def candidate_plans(cfg: ModelConfig, shape: ShapeConfig, *, multi_pod: bool,
                    hw: HWSpec = H100) -> list[MeshPlan]:
    """Enumerate the parallelism plans expressible on the production mesh
    ((pod,)data=16, model=16), score each with the analytic cost model at
    ``hw``, and mark memory feasibility.  An MoE arch whose experts split
    16 ways also gets the reference's expert-parallel plans: experts over
    the data axis, tensor parallelism over the model axis."""
    ep16 = cfg.moe is not None and cfg.moe.n_experts % 16 == 0
    pods = 2 if multi_pod else 1
    chips = 256 * pods
    data_axes = ("pod", "data") if multi_pod else ("data",)
    out = []
    train = shape.kind == "train"
    decode = shape.kind == "decode"

    def add(name, plan, desc):
        c = step_cost(cfg, shape, desc)
        used = c.hbm_resident if train else (c.hbm_resident - c.opt_bytes_chip)
        out.append(MeshPlan(name, plan, desc, c, used <= hw.hbm_bytes, used, hw))

    micro_opts = (1, 4, 8) if train else (1,)
    opt = "adafactor" if cfg.param_count() > 20e9 else "adamw"

    if decode and shape.global_batch % 16 != 0:
        # long-context decode (batch 1): batch replicated, the KV/state
        # sequence sharded across the whole mesh, weights TP over model
        if ep16:
            # MoE: experts over data, sequence over model only
            add("longctx_ep16",
                ShardingPlan(batch_axes=(), model_axis="model",
                             mla_absorbed=False, ep_axis="data",
                             seq_axes=("model",)),
                ParallelismDesc(n_chips=chips, tp=16, dp=1, ep=16,
                                seq_shard_decode=16))
        add("longctx_seqshard",
            ShardingPlan(batch_axes=(), model_axis="model", mla_absorbed=False,
                         seq_axes=data_axes + ("model",)),
            ParallelismDesc(n_chips=chips, tp=16, dp=1,
                            seq_shard_decode=chips))
        return out

    # TP over model + DP over (pod,)data
    for fsdp in ((False, True) if train else (False,)):
        for mb in micro_opts:
            add(f"tp16_dp{16*pods}" + ("_fsdp" if fsdp else "")
                + (f"_mb{mb}" if mb > 1 else ""),
                ShardingPlan(batch_axes=data_axes, model_axis="model",
                             fsdp_axes=data_axes if fsdp else (),
                             seq_axes=("model",) if decode else (),
                             seq_parallel=not decode, mla_absorbed=False,
                             remat=train, microbatches=mb),
                ParallelismDesc(n_chips=chips, tp=16, dp=16 * pods, fsdp=fsdp,
                                seq_shard_decode=16 if decode else 1,
                                remat=train, microbatches=mb, optimizer=opt))
    # EP over data + TP over model (MoE archs with E % 16 == 0)
    if ep16:
        for fsdp in ((False, True) if train else (False,)):
            for mb in micro_opts:
                add("ep16_tp16" + ("_fsdp" if fsdp else "")
                    + (f"_mb{mb}" if mb > 1 else ""),
                    ShardingPlan(batch_axes=data_axes, model_axis="model",
                                 ep_axis="data",
                                 fsdp_axes=data_axes if fsdp else (),
                                 seq_axes=("model",) if decode else (),
                                 seq_parallel=not decode, mla_absorbed=False,
                                 remat=train, microbatches=mb),
                    ParallelismDesc(n_chips=chips, tp=16, dp=16 * pods, ep=16,
                                    fsdp=fsdp,
                                    seq_shard_decode=16 if decode else 1,
                                    remat=train, microbatches=mb,
                                    optimizer=opt))
    # pure DP: batch over (pod, data, model) — only when batch divides
    if shape.global_batch % chips == 0:
        add(f"dp{chips}",
            ShardingPlan(batch_axes=data_axes + ("model",), remat=train),
            ParallelismDesc(n_chips=chips, tp=1, dp=chips, fsdp=train,
                            remat=train))
    return out


def helr_mesh(cfg: ModelConfig, shape: ShapeConfig, *, multi_pod: bool = False,
              hw: HWSpec = H100) -> MeshPlan:
    """Pick the feasible min-time plan (HELR objective on the mesh)."""
    cands = candidate_plans(cfg, shape, multi_pod=multi_pod, hw=hw)
    feas = [c for c in cands if c.fits]
    pool = feas or cands
    return min(pool, key=lambda c: c.step_time)
