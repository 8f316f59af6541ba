"""Serving launcher of the port: UELLM's pipeline on a real model.

  PYTHONPATH=src python -m repro_torch.launch.serve --no-reduced --device cuda

Port of the single-engine paths of ``repro/launch/serve.py``: the resource
profiler predicts each request's output length, SLO-ODBS (or the
``--scheduler`` baseline) composes batches, the padded engine runs each
batch (``--continuous``: the continuous engine runs the queue), and the
monitor feeds every finished request back into the predictor online.

``--paged`` serves through the paged continuous-batching engine instead
(block-table KV pool sized from ``--kv-budget`` bytes, per-prompt prefill,
allocator-gated admission, every decode step through the paged-attention
kernel).  ``--prefix-cache`` adds the radix prefix cache (``--workload
shared-prefix`` exercises it), ``--lookahead N`` lets admission skip a
blocked queue head, ``--chunk-tokens N`` chunks prompt prefill (``-1``
derives N from the scheduler threshold), ``--preempt`` evicts the slack-most
resident for recompute under block pressure, and ``--speculate`` verifies
``--spec-tokens`` drafts of ``--drafter`` per iteration in one window pass.

``--arch`` picks smollm-135m (the default), the dense chatglm2-6b (the
paper's own model), qwen2-1.5b, qwen2-moe-a2.7b (a Mixture-of-Experts MLP
with capacity-dropping dispatch on every layer), llama4-maverick-400b-a17b
(dense and MoE layers in turn, 128 experts top-1) or qwen2-vl-7b (M-RoPE),
which serve on every path above;
gemma2-27b, whose local layers keep a ring of their 4,096-token window,
minicpm3-4b, whose Multi-head Latent Attention caches the compressed
latent, rwkv6-3b, whose prefill runs through the WKV6 kernel, or
jamba-1.5-large-398b, the hybrid (Mamba layers, one attention layer in 8,
16 experts top-2 every other layer).  These four serve padded and
``--continuous``; ``--paged`` refuses them (ring caches, latents and
recurrent state are not paged KV blocks), as the reference does.  ``--arch whisper-medium`` (the encoder-decoder) resolves
and then fails where the reference's CLI fails: its engine passes no
frame embeddings, so the model API's prefill raises ``KeyError:
'frames'``; whisper runs through the model API (``api.prefill`` with
``batch["frames"]``, ``api.decode_step``) instead.  The
``serving`` line names the plan the LLM deployer (HELR-mesh) picks for the
full-width arch at ``decode_32k`` on the production mesh, which is still
the reference's TPU mesh (256 chips as data=16 × model=16), priced at the
H100's FLOP/s, HBM and link classes (NVLink within an 8-GPU board,
InfiniBand beyond, so every collective of a 16-wide group goes over
InfiniBand).

Same flags and defaults as the reference; ``--reduced`` is on by default and
``--no-reduced`` serves the full-width model.  On a card too small for a
model's f32 weights the port keeps the width and cuts the depth to whole
group periods (``fit_depth``) and says what it kept: gemma2-27b's 46
layers take 108.9 GB, so on one 80 GB H100 it serves its first 24 layers
(59.1 GB); qwen2-moe-a2.7b (57.25 GB) and qwen2-vl-7b (30.46 GB) serve
whole, and so does whisper-medium (3.0 GB, the encoder counted).  Not one
two-layer period of llama4-maverick-400b-a17b fits in f32 (74.2 GB), so
``--no-reduced`` raises ``ValueError`` there; in bf16, its deployment dtype,
the period takes 37.1 GB, and a caller that draws bf16 weights cuts with
``fit_depth(cfg, budget, bytes_per_param=2)``.  jamba-1.5-large-398b's
group period is 8 layers (90.2 GB in bf16), so ``fit_depth`` raises for it
in either dtype; a caller that wants it on one card takes fewer layers
than a period itself (its first five, 48.0 GB in bf16, hold every kind of
layer).

``--replicas N`` lifts serving to the cluster layer (``serving/cluster``):
requests are routed by ``--router`` across N replicas.  With ``--paged``
each replica owns a real ``PagedEngine`` (pool and prefix cache per
replica; ``serve_cluster``) and the routed shares are served live, one
replica after the other, every prefill chunk through the flash-attention
kernel and every decode step through the paged-attention kernel.
Otherwise the replicas are ``LatencyModel``-backed simulated engines on
per-replica HELR deployments of the full-width ``--arch``, driven by the
discrete-event simulator (``serve_cluster_sim``): no weights are drawn and
only the length predictor runs on the device.  ``--autoscale`` adds the
forecast-driven elastic replica set (``--workload bursty`` exercises it),
``--models`` a heterogeneous fleet of per-model pools (``--fleet``: one
joint allocator or independent per-pool autoscalers), and the fault flags
(``--fault-crash``, ``--fault-mtbf``, ...) crashes, health checks, retries
and brownout.  ``--speculate`` on a cluster path plans at the cost
profiler's measured acceptance, which comes with the observability slice,
so it exits with "not ported yet" there, as do the trace, metrics and
profile flags.
"""
from __future__ import annotations

import argparse
import hashlib
import json
import time
from dataclasses import replace

import torch

from repro_torch.configs import SHAPES, get_config
from repro_torch.configs.base import ModelConfig, group_period
from repro_torch.core import (LengthPredictor, Monitor, PredictorConfig,
                              ResourceProfiler, SchedulerConfig,
                              derive_chunk_tokens, get_scheduler, helr_mesh)
from repro_torch.core.types import Request
from repro_torch.data.workload import (MixedWorkloadConfig,
                                       SharedPrefixConfig, WorkloadConfig,
                                       gen_mixed_requests, gen_requests,
                                       gen_shared_prefix_requests, train_pairs)
from repro_torch.device import resolve_device
from repro_torch.models import api
from repro_torch.models.transformer import Transformer
from repro_torch.serving import (AutoscalerConfig, EngineConfig, FaultEvent,
                                 FaultPlan, FleetAutoscalerConfig,
                                 HealthConfig, InferenceEngine, ModelPoolSpec,
                                 PagedEngine, PagedEngineConfig, Replica,
                                 RetryConfig, Router, RouterConfig,
                                 get_drafter, paper_cluster, simulate_cluster)
from repro_torch.serving.cluster.router import POLICIES

# flags of the reference CLI whose paths later slices port
_LATER_FLAGS = {
    "observability slice": ("--trace", "--metrics-json", "--profile-out",
                            "--profile-in", "--pricing-quantile",
                            "--profile-half-life"),
}


def outputs_digest(done: dict) -> str:
    """Order-independent digest of the generated tokens, computed exactly
    as the reference's ``_outputs_digest``."""
    blob = json.dumps(sorted((int(k), list(map(int, v)))
                             for k, v in done.items()))
    return hashlib.sha1(blob.encode()).hexdigest()[:12]


# The share of a card's memory the weights may take; caches and
# activations get the rest (gemma2-27b's long batch of 4,608 + 4,300 tokens
# took 8 GiB beyond its weights on the H100)
WEIGHT_SHARE = 0.7


def fit_depth(cfg: ModelConfig, nbytes: float,
              bytes_per_param: int = 4) -> ModelConfig:
    """``cfg`` cut to the deepest whole number of its group periods
    (``group_period``: the layers that repeat its layer plan) whose
    weights, at ``bytes_per_param`` bytes a parameter (4: f32, as the
    serve CLI draws them; 2: bf16), take at most ``nbytes``, at the same
    width (an encoder-decoder's encoder stays whole, and its bytes count);
    ``cfg`` itself where every layer fits.  Raises ``ValueError`` when not
    even one period fits."""
    step = group_period(cfg)
    n = cfg.n_layers
    while n > 0 and bytes_per_param * replace(cfg, n_layers=n).param_count() \
            > nbytes:
        n -= step
    if n == 0:
        one = bytes_per_param * replace(cfg, n_layers=step).param_count()
        raise ValueError(
            f"{cfg.name}: one group period ({step} layers, with the "
            f"embeddings) takes {one:.4g} bytes of weights at "
            f"{bytes_per_param} bytes a parameter, over the budget of "
            f"{nbytes:.4g} bytes")
    return cfg if n == cfg.n_layers else replace(cfg, n_layers=n)


def card_weight_bytes(device) -> float:
    """The bytes of weights the card ``device`` is given."""
    return WEIGHT_SHARE * torch.cuda.get_device_properties(device).total_memory


def make_requests(cfg: ModelConfig, n: int, max_new: int,
                  workload: str = "alpaca") -> list[Request]:
    """The reference serve path's request stream: a seeded workload with
    output lengths in [1, max_new] — the Alpaca-like mix with prompts cut
    to 16 tokens of the model's vocab, or the shared-prefix mix (16-token
    templates, prompts cut to 32 tokens)."""
    if workload == "shared-prefix":
        reqs = gen_shared_prefix_requests(SharedPrefixConfig(
            n_requests=n, n_templates=max(2, n // 6), prefix_len=16,
            suffix_mean=2.0, vocab=cfg.vocab_size, seed=0))
        cut = 32
    else:
        pattern = workload if workload in ("bursty", "diurnal") else "poisson"
        reqs = gen_requests(WorkloadConfig(n_requests=n, seed=0,
                                           vocab=cfg.vocab_size,
                                           arrival_pattern=pattern))
        cut = 16
    for r in reqs:
        r.tokens = [t % cfg.vocab_size for t in r.tokens[:cut]]
        r.input_len = len(r.tokens)
        r.true_output_len = r.true_output_len % max_new + 1
    return reqs


def fit_predictor(vocab: int, device) -> LengthPredictor:
    """The serve path's length predictor: seed 0, 8 epochs on 256 pairs at
    ``vocab`` (a model's, or the predictor's default for the simulated
    cluster, whose requests are not cut to a model's vocab)."""
    pred = LengthPredictor(PredictorConfig(vocab=vocab), seed=0, device=device)
    toks, lens = train_pairs(WorkloadConfig(vocab=vocab), 256, seed=1)
    pred.fit(toks, lens, epochs=8)
    return pred


def paged_config(cfg: ModelConfig, reqs: list[Request], max_new: int,
                 kv_budget: float, **kw) -> PagedEngineConfig:
    """The reference serve path's paged pool: 8-token blocks, 4 slots, the
    pool sized from ``kv_budget`` bytes, block tables wide enough for the
    longest prompt plus the decode budget."""
    max_prompt = max(len(r.tokens) for r in reqs)
    max_seq = max(64, -(-(max_prompt + max_new) // 8) * 8)
    return PagedEngineConfig.from_memory_budget(
        cfg, kv_budget, max_batch=4, block_size=8, max_seq_len=max_seq,
        max_new_tokens=max_new, **kw)


def serve(cfg: ModelConfig, params: Transformer, reqs: list[Request],
          predictor: LengthPredictor, *, scheduler: str = "slo-odbs",
          continuous: bool = False, max_new: int = 16,
          paged: PagedEngineConfig | None = None, drafter=None) -> dict:
    """Profile -> schedule -> execute -> monitor, on the device the
    parameters live on; ``paged`` serves the queue through the paged engine
    (``drafter`` its speculation proposer, None: the config's default), its
    pools in the parameters' dtype.
    Returns the outputs, their digest, the engine results, the elapsed
    seconds and the monitor."""
    engine = InferenceEngine(cfg, params,
                             EngineConfig(max_batch=4, cache_len=64,
                                          max_new_tokens=max_new))
    prof = ResourceProfiler(predictor, cfg)
    mon = Monitor(prof)
    prof.profile(reqs)
    results = []
    t0 = time.perf_counter()
    if paged is not None:
        res = PagedEngine(cfg, params, paged, monitor=mon, drafter=drafter,
                          dtype=params.embed.w.dtype).run_continuous(
            sorted(reqs, key=lambda r: r.arrival))
        results.append(res)
        done = res.outputs
    elif continuous:
        res = engine.run_continuous(sorted(reqs, key=lambda r: r.arrival))
        results.append(res)
        done = res.outputs
    else:
        done = {}
        for b in get_scheduler(scheduler)(reqs, SchedulerConfig(max_batch=4)):
            res = engine.run_batch(b, true_lens={r.rid: r.true_output_len
                                                 for r in b.requests})
            results.append(res)
            done.update(res.outputs)
            for r in b.requests:
                mon.observe(r)
    seconds = time.perf_counter() - t0
    return {"outputs": done, "digest": outputs_digest(done),
            "results": results, "seconds": seconds,
            "tokens": sum(len(v) for v in done.values()), "monitor": mon}


def serve_cluster(cfg: ModelConfig, params: Transformer, reqs: list[Request],
                  predictor: LengthPredictor, *, replicas: int = 2,
                  router: str = "round_robin", max_new: int = 16,
                  kv_budget: float = 2e6, prefix_cache: bool = False,
                  lookahead: int = 0, chunk_tokens: int = 0,
                  preempt: bool = False) -> dict:
    """Route ``reqs`` across ``replicas`` live replicas, each a
    ``PagedEngine`` on ``params`` with its own pool of ``kv_budget`` bytes
    and prefix cache, then serve each replica's share in turn, as the
    reference's ``_serve_cluster_live`` does (its pools in the parameters'
    dtype).  Prints a line for each replica that got requests and the
    router's stats.  Returns what ``serve`` returns (``results``: the
    engine result of each replica served), and ``replicas`` and
    ``router``."""
    prof = ResourceProfiler(predictor, cfg)
    mon = Monitor(prof)
    prof.profile(reqs)
    t0 = time.perf_counter()
    route = Router(RouterConfig(policy=router))
    reps = []
    for i in range(replicas):
        nodes, lat = paper_cluster()
        pcfg = paged_config(cfg, reqs, max_new, kv_budget,
                            prefix_cache=prefix_cache,
                            admit_lookahead=lookahead,
                            chunk_tokens=chunk_tokens, preempt=preempt)
        reps.append(Replica(
            i, cfg, nodes, lat, max_batch=4, block_size=8,
            n_blocks=pcfg.usable_blocks, prefix_cache=prefix_cache,
            chunk_tokens=chunk_tokens, preempt=preempt,
            engine=PagedEngine(cfg, params, pcfg, monitor=mon, track=i,
                               dtype=params.embed.w.dtype)))
    for r in sorted(reqs, key=lambda q: q.arrival):
        rep = route.dispatch(r, reps, r.arrival)
        if rep is None:
            mon.observe_shed(r)
            continue
        rep.enqueue(r, r.arrival)
    done, results = {}, []
    for rep in reps:
        if not rep.queue:
            continue
        res = rep.engine.run_continuous(
            sorted(rep.queue, key=lambda q: q.arrival))
        results.append(res)
        done.update(res.outputs)
        print(f"replica {rep.rid}: {len(rep.queue)} requests, "
              f"prefill_tokens={res.prefill_tokens}, "
              f"prefix_hits={res.prefix_hits}/{res.prefix_lookups}, "
              f"peak_blocks={res.peak_blocks}")
    print(f"router: {route.stats.summary()}")
    seconds = time.perf_counter() - t0
    return {"outputs": done, "digest": outputs_digest(done),
            "results": results, "seconds": seconds,
            "tokens": sum(len(v) for v in done.values()), "monitor": mon,
            "replicas": reps, "router": route.stats.summary()}


def parse_model_mix(spec: str) -> list:
    """``"arch[:weight],arch[:weight]"`` -> ``[(arch, weight), ...]``."""
    out = []
    for part in spec.split(","):
        part = part.strip()
        if not part:
            continue
        name, _, w = part.partition(":")
        out.append((name.strip(), float(w) if w else 1.0))
    if not out:
        raise SystemExit("--models: empty model list")
    return out


def serve_cluster_sim(args, prof: ResourceProfiler, mon: Monitor):
    """The cluster-scale path: ``LatencyModel``-backed replicas on
    per-replica HELR deployments of the full-width ``--arch``, driven by the
    discrete-event simulator on the reference's trace (at least 128
    requests at 16 a second), its autoscaler, fleet and fault settings.
    Prints the ``cluster:`` summary and a line for each replica; returns
    the ``ClusterSimResult``."""
    full_cfg = get_config(args.arch)
    n = max(args.requests, 128)
    pattern = args.workload if args.workload in ("bursty", "diurnal") \
        else "poisson"
    pools = None
    if args.models:
        # heterogeneous fleet: model-tagged, tier-skewed mixed trace and
        # one replica pool per model over the shared partition budget
        mix = parse_model_mix(args.models)
        reqs = gen_mixed_requests(MixedWorkloadConfig(
            models=tuple(mix), n_requests=n, arrival_rate=16.0,
            arrival_pattern=pattern, seed=0))
        per = max(1, args.replicas // len(mix))
        pools = [ModelPoolSpec(m, replicas=per, weight=w) for m, w in mix]
    elif args.workload == "shared-prefix":
        reqs = gen_shared_prefix_requests(SharedPrefixConfig(
            n_requests=n, n_templates=max(4, n // 12), prefix_len=96,
            turns=4, arrival_rate=16.0, slo_lo=8.0, slo_hi=60.0, seed=0))
    else:
        reqs = gen_requests(WorkloadConfig(
            n_requests=n, arrival_rate=16.0, arrival_pattern=pattern,
            slo_lo=8.0, slo_hi=60.0, seed=0))
    auto = None
    if args.autoscale:
        if pools is not None and args.fleet == "joint":
            auto = FleetAutoscalerConfig(
                interval=1.0, budget=max(6, 2 * args.replicas),
                min_per_pool=1, spawn_delay=1.0)
        elif pools is not None:
            # replicated per pool by the simulator: independent autoscalers
            auto = AutoscalerConfig(
                interval=1.0, min_replicas=max(1, per),
                max_replicas=max(3, args.replicas), spawn_delay=1.0)
        else:
            auto = AutoscalerConfig(interval=1.0, min_replicas=args.replicas,
                                    max_replicas=max(6, 2 * args.replicas),
                                    spawn_delay=1.0)
    faults = retry = health = None
    if args.fault_crash or args.fault_mtbf > 0:
        events = []
        for spec in (args.fault_crash or "").split(","):
            if not spec:
                continue
            ts, _, rid = spec.partition(":")
            events.append(FaultEvent(t=float(ts), kind="crash",
                                     rid=int(rid or 0)))
        faults = FaultPlan(events=events, mtbf=args.fault_mtbf,
                           mttr=args.fault_mttr, seed=args.fault_seed)
        retry = RetryConfig(budget=args.retry_budget,
                            backoff_base=args.retry_backoff)
        tiers = tuple(t for t in (args.brownout_tiers or "").split(",") if t)
        health = HealthConfig(check_interval=args.health_interval,
                              detect_lag=args.detect_lag,
                              brownout_tiers=tiers)
    res = simulate_cluster(
        reqs, full_cfg, get_scheduler(args.scheduler), SchedulerConfig(),
        n_replicas=args.replicas, pools=pools, router=args.router,
        autoscale=auto, prefix_cache=args.prefix_cache,
        chunk_tokens=args.chunk_tokens, preempt=args.preempt,
        profiler=prof, monitor=mon, faults=faults, retry=retry,
        health=health)
    print("cluster:", res.summary())
    for s in res.replica_stats:
        tag = f" model={s['model']}" if pools is not None else ""
        print(f"  replica {s['rid']}:{tag} served={s['served']} "
              f"util={s['utilization']} queue_prefill={s['prefill_tokens']} "
              f"saved={s['prefill_tokens_saved']}")
    return res


def print_paged(res, pcfg: PagedEngineConfig, drafter_name: str) -> None:
    """The reference's summary lines of a paged run."""
    print(f"paged: {res.admission_waves} admission waves, "
          f"prefill_tokens={res.prefill_tokens}, "
          f"peak_blocks={res.peak_blocks}, "
          f"kv_util={res.kv_utilization:.3f}, "
          f"waste_vs_padded={res.waste_vs_padded:.3f}")
    if pcfg.spec_tokens:
        print(f"speculate: {pcfg.spec_tokens} drafts/iter "
              f"({drafter_name}), acceptance={res.acceptance_rate:.3f}, "
              f"{res.steps} iterations for {res.generated_tokens} "
              f"tokens ({res.iterations_per_token:.3f} it/tok), "
              f"rolled_back={res.spec_rolled_blocks} blocks")
    if pcfg.chunk_tokens or pcfg.preempt:
        print(f"interleave: {res.prefill_chunks} chunks, "
              f"stall={res.prefill_stall_s*1e3:.1f}ms, "
              f"p99_itl={res.p99_inter_token_s*1e3:.2f}ms, "
              f"preemptions={res.preemptions} "
              f"({res.preempted_tokens} tokens recomputed)")
    if pcfg.prefix_cache:
        print(f"prefix: {res.prefix_hits}/{res.prefix_lookups} hits, "
              f"hit_tokens={res.prefix_hit_tokens}, "
              f"cow_forks={res.cow_forks}, "
              f"evictions={res.prefix_evictions}, "
              f"peak_residents={res.peak_residents}")


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="smollm-135m",
                    help="smollm-135m, chatglm2-6b, qwen2-1.5b, gemma2-27b, "
                         "minicpm3-4b, qwen2-moe-a2.7b, "
                         "llama4-maverick-400b-a17b, qwen2-vl-7b, "
                         "rwkv6-3b, jamba-1.5-large-398b or whisper-medium "
                         "(whose serve path fails as the reference's: no "
                         "frames)")
    ap.add_argument("--reduced", action=argparse.BooleanOptionalAction,
                    default=True,
                    help="serve the reduced config (--no-reduced: full width)")
    ap.add_argument("--requests", type=int, default=12)
    ap.add_argument("--scheduler", default="slo-odbs",
                    choices=["slo-odbs", "slo-dbs", "odbs", "fifo", "s3"])
    ap.add_argument("--continuous", action="store_true",
                    help="beyond-paper continuous batching mode")
    ap.add_argument("--paged", action="store_true",
                    help="paged continuous batching (block-table KV cache)")
    ap.add_argument("--prefix-cache", action="store_true",
                    help="radix-tree prefix sharing over the paged pool "
                         "(implies --paged)")
    ap.add_argument("--lookahead", type=int, default=0,
                    help="queue entries scanned past a blocked head "
                         "(paged admission)")
    ap.add_argument("--chunk-tokens", type=int, default=0,
                    help="per-iteration prefill chunk budget for the paged "
                         "engine (0: whole-prompt prefill at admission; "
                         "-1: derive from the scheduler's composite "
                         "threshold)")
    ap.add_argument("--preempt", action="store_true",
                    help="under block pressure evict the resident with the "
                         "most SLO slack and requeue it for recompute "
                         "instead of blocking a tighter arrival")
    ap.add_argument("--speculate", action="store_true",
                    help="speculative decoding on the paged engine: drafts "
                         "verified in one multi-token kernel pass; greedy "
                         "acceptance keeps outputs token-identical (implies "
                         "--paged)")
    ap.add_argument("--spec-tokens", type=int, default=4,
                    help="draft tokens verified per engine iteration")
    ap.add_argument("--drafter", default="ngram", choices=["ngram", "model"],
                    help="draft proposer: n-gram prompt lookup, or a small "
                         "draft LM (seeded random weights: plumbing demo, "
                         "low acceptance)")
    ap.add_argument("--kv-budget", type=float, default=2e6,
                    help="paged KV pool budget in bytes")
    ap.add_argument("--workload", default="alpaca",
                    choices=["alpaca", "shared-prefix", "bursty", "diurnal"])
    ap.add_argument("--max-new", type=int, default=16)
    ap.add_argument("--replicas", type=int, default=1,
                    help="cluster serving: replicas behind the router")
    ap.add_argument("--models", default=None, metavar="SPEC",
                    help="heterogeneous fleet on the simulated cluster: "
                         "comma list of arch[:weight] (e.g. "
                         "'chatglm2-6b:0.6,qwen2-1.5b:0.4')")
    ap.add_argument("--fleet", default="joint",
                    choices=["joint", "independent"],
                    help="with --models --autoscale: one joint allocator "
                         "over the shared replica budget or independent "
                         "per-pool autoscalers")
    ap.add_argument("--router", default="round_robin", choices=POLICIES,
                    help="dispatch policy of the cluster layer")
    ap.add_argument("--autoscale", action="store_true",
                    help="forecast-driven elastic replica set (simulated "
                         "cluster; --replicas becomes the minimum)")
    ap.add_argument("--fault-crash", default=None, metavar="T:RID[,T:RID]",
                    help="scripted replica crashes in the cluster sim, e.g. "
                         "'2.5:1' crashes replica 1 at t=2.5s (fault mode: "
                         "health checks, retries)")
    ap.add_argument("--fault-mtbf", type=float, default=0.0,
                    help="seeded random faults: mean seconds between "
                         "failures per replica lane (0 = scripted only)")
    ap.add_argument("--fault-mttr", type=float, default=0.0,
                    help="mean recovery time of recoverable random faults")
    ap.add_argument("--fault-seed", type=int, default=0,
                    help="seed of the random fault model")
    ap.add_argument("--retry-budget", type=int, default=2,
                    help="re-dispatches granted to a request lost with a "
                         "failed replica before it counts as shed")
    ap.add_argument("--retry-backoff", type=float, default=0.25,
                    help="base seconds of the exponential retry backoff")
    ap.add_argument("--detect-lag", type=float, default=1.0,
                    help="seconds a silent replica stays routable before "
                         "the health layer declares it down")
    ap.add_argument("--health-interval", type=float, default=0.5,
                    help="heartbeat/health-scan cadence in fault mode")
    ap.add_argument("--brownout-tiers", default=None, metavar="T1[,T2]",
                    help="SLO tiers shed in this order under detected "
                         "capacity loss, e.g. 'batch,interactive'")
    ap.add_argument("--device", default="cuda",
                    help="torch device to serve on (cuda, or cpu)")
    for slice_name, flags in _LATER_FLAGS.items():
        for flag in flags:
            ap.add_argument(flag, nargs="?", const=True,
                            default=argparse.SUPPRESS,
                            help=f"not ported yet ({slice_name})")
    return ap


def main(argv=None) -> dict:
    ap = build_parser()
    args = ap.parse_args(argv)
    for slice_name, flags in _LATER_FLAGS.items():
        for flag in flags:
            if hasattr(args, flag[2:].replace("-", "_")):
                ap.error(f"{flag} is not ported yet ({slice_name})")
    cluster = args.replicas > 1 or args.autoscale or bool(args.models)
    if cluster and args.speculate:
        ap.error("--speculate on a cluster path is not ported yet "
                 "(observability slice: it plans at the cost profiler's "
                 "measured acceptance)")
    if args.autoscale and args.paged:
        raise SystemExit("--autoscale needs the simulated cluster path: "
                         "drop --paged (elasticity has no live-engine mode)")
    if args.models and args.paged:
        raise SystemExit("--models needs the simulated cluster path: "
                         "drop --paged (the heterogeneous fleet has no "
                         "live-engine mode)")
    if (args.prefix_cache or args.speculate) and not cluster:
        args.paged = True          # the cluster sim honours the flags itself
    spec_tokens = args.spec_tokens if args.speculate else 0
    if args.chunk_tokens < 0:
        args.chunk_tokens = derive_chunk_tokens(SchedulerConfig(),
                                                block_size=8)
        print(f"chunk budget from scheduler threshold: "
              f"{args.chunk_tokens} tokens/iteration")
    device = resolve_device(args.device)
    where = (f"{device} ({torch.cuda.get_device_name(device)})"
             if device.type == "cuda" else str(device))

    if cluster and not args.paged:
        # the cluster-scale path prices the full-width arch and draws no
        # weights; only the length predictor runs on the device
        plan = helr_mesh(get_config(args.arch), SHAPES["decode_32k"]).name
        print(f"serving {args.arch} on the simulated cluster, its length "
              f"predictor on {where} (plan for production mesh: {plan})")
        prof = ResourceProfiler(fit_predictor(PredictorConfig().vocab, device),
                                get_config(args.arch))
        mon = Monitor(prof)
        res = serve_cluster_sim(args, prof, mon)
        print("monitor:", mon.metrics())
        return {"cluster": res, "monitor": mon}

    cfg = get_config(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    if device.type == "cuda":
        budget = card_weight_bytes(device)
        cut = fit_depth(cfg, budget)
        within = (f"within {WEIGHT_SHARE} of the card's "
                  f"{budget / WEIGHT_SHARE / 1e9:.1f} GB")
        if cut.n_layers < cfg.n_layers:
            print(f"depth cut {cfg.n_layers} -> {cut.n_layers} layers at full "
                  f"width: {4 * cut.param_count() / 1e9:.1f} GB of f32 "
                  f"weights, {within} (all {cfg.n_layers}: "
                  f"{4 * cfg.param_count() / 1e9:.1f} GB)")
        else:
            print(f"depth whole: all {cfg.n_layers} layers, "
                  f"{4 * cfg.param_count() / 1e9:.2f} GB of f32 weights, "
                  f"{within}")
        cfg = cut
    plan = helr_mesh(get_config(args.arch), SHAPES["decode_32k"]).name
    print(f"serving {cfg.name} ({cfg.n_layers} layers, d_model {cfg.d_model}) "
          f"on {where} (plan for production mesh: {plan})")
    params = api.init_params(cfg, seed=0, dtype=torch.float32, device=device)
    reqs = make_requests(cfg, args.requests, args.max_new, args.workload)
    pcfg = drafter = None
    if args.paged and not cluster:
        pcfg = paged_config(cfg, reqs, args.max_new, args.kv_budget,
                            prefix_cache=args.prefix_cache,
                            admit_lookahead=args.lookahead,
                            chunk_tokens=args.chunk_tokens,
                            preempt=args.preempt, spec_tokens=spec_tokens,
                            drafter=args.drafter)
        print(f"paged pool: {pcfg.usable_blocks} usable blocks (+null) x "
              f"{pcfg.block_size} slots ({args.kv_budget:.0f} B budget, "
              f"prefix_cache={'on' if pcfg.prefix_cache else 'off'}, "
              f"chunk_tokens={pcfg.chunk_tokens}, "
              f"preempt={'on' if pcfg.preempt else 'off'}, "
              f"speculate={pcfg.spec_tokens or 'off'})")
        if spec_tokens and args.drafter == "model":
            drafter = get_drafter("model", draft_cfg=cfg,
                                  draft_params=api.init_params(
                                      cfg, seed=7, device=device))
    pred = fit_predictor(cfg.vocab_size, device)
    if cluster:
        out = serve_cluster(cfg, params, reqs, pred,
                            replicas=args.replicas, router=args.router,
                            max_new=args.max_new, kv_budget=args.kv_budget,
                            prefix_cache=args.prefix_cache,
                            lookahead=args.lookahead,
                            chunk_tokens=args.chunk_tokens,
                            preempt=args.preempt)
    else:
        out = serve(cfg, params, reqs, pred,
                    scheduler=args.scheduler, continuous=args.continuous,
                    max_new=args.max_new, paged=pcfg, drafter=drafter)
    if pcfg is not None:
        print_paged(out["results"][0], pcfg, args.drafter)
    dt, total = out["seconds"], out["tokens"]
    print(f"served {len(out['outputs'])} requests, {total} tokens in "
          f"{dt:.2f}s ({total / dt:.1f} tok/s on {where})")
    print(f"outputs_digest={out['digest']}")
    print("monitor:", out["monitor"].metrics())
    return out


if __name__ == "__main__":
    main()
