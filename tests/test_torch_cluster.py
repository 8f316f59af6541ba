"""The port's cluster layer against the JAX package's: replica load
signals, the four router policies and the model-aware pools, the
autoscaler and its forecaster, the fleet's joint allocator, and
``simulate_cluster`` under each router, with elasticity and with pools
joint and independent.  Each scenario of ``tests/test_cluster.py`` runs in
both packages on the same inputs: its directional claim must hold, and
what it observes (projections, picks, router stats, summaries, per-replica
stats, request stamps, monitor metrics) must be equal."""
import copy
from types import SimpleNamespace

import pytest

import repro.configs as jax_configs
import repro.core as jax_core
import repro.data.workload as jax_workload
import repro.serving.cluster as jax_cluster
import repro.serving.cluster.router as jax_router
import repro.serving.simulator as jax_sim
import repro_torch.configs as configs
import repro_torch.core as core
import repro_torch.data.workload as workload
import repro_torch.serving.cluster as cluster
import repro_torch.serving.cluster.router as router
import repro_torch.serving.simulator as sim


def _pkg(cfgs, c, wl, cl, rt, s):
    ns = SimpleNamespace(**{k: getattr(cl, k) for k in cl.__all__}) \
        if hasattr(cl, "__all__") else SimpleNamespace(**vars(cl))
    ns.CFG = cfgs.get_config("chatglm2-6b")
    ns.get_config = cfgs.get_config
    ns.core, ns.wl, ns.sim, ns.POLICIES = c, wl, s, rt.POLICIES
    return ns


PKGS = {"jax": _pkg(jax_configs, jax_core, jax_workload, jax_cluster,
                    jax_router, jax_sim),
        "port": _pkg(configs, core, workload, cluster, router, sim)}


def _replica(m, rid=0, **kw):
    nodes, lat = m.sim.paper_cluster()
    return m.Replica(rid, m.CFG, nodes, lat, **kw)


def _req(m, rid, *, in_len=64, out_len=32, slo=30.0, arrival=0.0,
         tokens=None, model="", tier=""):
    toks = tokens if tokens is not None else list(range(100, 100 + in_len))
    r = m.core.Request(rid=rid, tokens=toks, input_len=len(toks), slo=slo,
                       arrival=arrival, true_output_len=out_len)
    r.predicted_output_len = out_len
    r.model, r.tier = model, tier
    return r


def _monitor(m):
    """A monitor whose metrics do not depend on a predictor's weights:
    the simulations here predict by oracle, and misses update nothing."""
    device = {} if m is PKGS["jax"] else {"device": "cpu"}
    pred = m.core.LengthPredictor(m.core.PredictorConfig(), seed=0, **device)
    return m.core.Monitor(m.core.ResourceProfiler(pred, m.CFG),
                          update_on_miss=False)


# ------------------------------------------------------------- scenarios
# Each takes a package namespace, asserts the reference test's claim, and
# returns what it observed.

def enqueue_updates_signals(m):
    rep = _replica(m)
    free0, back0 = rep.free_blocks, rep.projected_backlog(0.0)
    rep.enqueue(_req(m, 0), 0.0)
    rep.enqueue(_req(m, 1), 0.0)
    assert rep.queue_depth == 2 and back0 == 0.0
    assert rep.projected_backlog(0.0) > 0.0 and rep.free_blocks < free0
    return free0, rep.free_blocks, rep.projected_backlog(0.0)


def prefix_peek_after_dispatch(m):
    rep = _replica(m, block_size=16)
    toks = list(range(200, 264))
    rep.enqueue(_req(m, 0, tokens=toks), 0.0)
    hit, miss = rep.prefix_peek(toks), rep.prefix_peek(list(range(500, 540)))
    assert hit >= 16 and miss == 0
    return hit, miss


def start_batch_serves_and_accounts(m):
    rep = _replica(m)
    for i in range(4):
        rep.enqueue(_req(m, i, in_len=40 + 8 * i, out_len=16 + 9 * i), 0.0)
    done = rep.start_batch(0.0, m.core.get_scheduler("slo-odbs"),
                           m.core.SchedulerConfig())
    assert done is not None and done > 0.0 and rep.busy_until == done
    blocks = rep.inflight_blocks
    assert blocks > 0 and rep.stats.served > 0
    rep.finish_batch()
    assert rep.inflight_blocks == 0
    return done, blocks, rep.stats.summary()


def projected_finish_monotone_in_backlog(m):
    rep = _replica(m)
    probe = _req(m, 99, slo=5.0)
    empty = rep.projected_finish(probe, 0.0)
    for i in range(12):
        rep.enqueue(_req(m, i, slo=1.0), 0.0)
    full = rep.projected_finish(probe, 0.0)
    assert full > empty
    return empty, full


def capacity_positive(m):
    caps = [_replica(m, **kw).capacity_rps(64.0, 64.0)
            for kw in ({}, {"spec_tokens": 4, "spec_acceptance": 0.7})]
    assert 0.0 < caps[0] < caps[1]
    return caps


def chunk_interleave_priced_into_drain(m):
    plain, chunked = _replica(m), _replica(m, chunk_tokens=32)
    for rep in (plain, chunked):
        for i in range(4):
            rep.enqueue(_req(m, i, in_len=256), 0.0)
    out = [rep.projected_drain() for rep in (plain, chunked)] + \
        [rep.projected_finish(_req(m, 9, in_len=256), 0.0)
         for rep in (plain, chunked)]
    assert out[1] > out[0] and out[3] > out[2]
    return out


def preempt_shrinks_busy_barrier(m):
    base, pre = _replica(m), _replica(m, preempt=True)
    for rep in (base, pre):
        rep.busy_until = 100.0
        rep.inflight_slos = [50.0, 60.0, 70.0, 80.0]
    tight, slack = _req(m, 0, slo=55.0), _req(m, 1, slo=500.0)
    out = [rep.projected_finish(r, 0.0) for r in (tight, slack)
           for rep in (base, pre)]
    assert out[1] < out[0] and out[3] == out[2]
    return out


def round_robin_cycles(m):
    reps = [_replica(m, i) for i in range(3)]
    rt = m.Router(m.RouterConfig(policy="round_robin"))
    picks = [rt.dispatch(_req(m, i), reps, 0.0).rid for i in range(6)]
    assert picks == [0, 1, 2, 0, 1, 2]
    return picks


def least_loaded_prefers_idle(m):
    reps = [_replica(m, 0), _replica(m, 1)]
    for i in range(10):
        reps[0].enqueue(_req(m, i), 0.0)
    rt = m.Router(m.RouterConfig(policy="least_loaded", d_choices=2))
    picks = [rt.dispatch(_req(m, 100 + i), reps, 0.0).rid for i in range(4)]
    assert picks == [1] * 4
    # with d < n the seeded sampling decides: the same draws in both
    reps = [_replica(m, i) for i in range(4)]
    rt = m.Router(m.RouterConfig(policy="least_loaded", seed=3))
    for i in range(12):
        rep = rt.dispatch(_req(m, i, out_len=8 + 5 * i), reps, 0.0)
        rep.enqueue(_req(m, i, out_len=8 + 5 * i), 0.0)
        picks.append(rep.rid)
    return picks


def prefix_affinity_sticky(m):
    reps = [_replica(m, i) for i in range(3)]
    rt = m.Router(m.RouterConfig(policy="prefix_affinity", affinity_block=16))
    template = list(range(300, 348))
    first = rt.dispatch(_req(m, 0, tokens=template + [1, 2]), reps, 0.0)
    first.enqueue(_req(m, 0, tokens=template + [1, 2]), 0.0)
    assert rt.stats.hash_fallbacks == 1
    nxt = rt.dispatch(_req(m, 1, tokens=template + [7, 8]), reps, 0.0)
    assert nxt.rid == first.rid and rt.stats.affinity_hits == 1
    # rendezvous hashing of cold templates, bit for bit
    homes = [rt.dispatch(_req(m, 10 + t, tokens=list(range(37 * t, 37 * t + 40))),
                         reps, 0.0).rid for t in range(16)]
    assert len(set(homes)) > 1
    return first.rid, homes, rt.stats.summary()


def prefix_affinity_survives_scale_up(m):
    reps = [_replica(m, i) for i in range(2)]
    rt = m.Router(m.RouterConfig(policy="prefix_affinity"))
    template = list(range(400, 448))
    home = rt.dispatch(_req(m, 0, tokens=template + [1]), reps, 0.0)
    home.enqueue(_req(m, 0, tokens=template + [1]), 0.0)
    reps.append(_replica(m, 2))
    again = rt.dispatch(_req(m, 1, tokens=template + [2]), reps, 0.0)
    assert again.rid == home.rid
    return home.rid


def slo_aware_sheds_hopeless(m):
    reps = [_replica(m, 0), _replica(m, 1)]
    for rep in reps:
        for i in range(20):
            rep.enqueue(_req(m, 1000 + i, slo=0.1), 0.0)
    rt = m.Router(m.RouterConfig(policy="slo_aware"))
    assert rt.dispatch(_req(m, 0, slo=0.01), reps, 0.0) is None
    assert rt.stats.shed == 1
    assert rt.dispatch(_req(m, 1, slo=1e4), reps, 0.0) is not None
    return rt.stats.summary()


def slo_aware_picks_earliest_finish(m):
    reps = [_replica(m, 0), _replica(m, 1)]
    for i in range(10):
        reps[0].enqueue(_req(m, i, slo=1.0), 0.0)
    rt = m.Router(m.RouterConfig(policy="slo_aware"))
    pick = rt.dispatch(_req(m, 100, slo=500.0), reps, 0.0).rid
    assert pick == 1
    return pick


def pool_backpressure_steers_dispatch(m):
    reps = [_replica(m, 0, n_blocks=4), _replica(m, 1)]
    reps[0].enqueue(_req(m, 0), 0.0)
    assert reps[0].free_blocks == 0
    rt = m.Router(m.RouterConfig(policy="round_robin"))
    picks = [rt.dispatch(_req(m, 10 + i), reps, 0.0).rid for i in range(4)]
    assert picks == [1] * 4
    return picks


def draining_replica_excluded(m):
    reps = [_replica(m, 0), _replica(m, 1)]
    reps[0].draining = True
    rt = m.Router(m.RouterConfig(policy="round_robin"))
    picks = [rt.dispatch(_req(m, i), reps, 0.0).rid for i in range(3)]
    assert picks == [1] * 3
    with pytest.raises(ValueError):
        m.RouterConfig(policy="wat")
    return picks


def autoscaler_scales_up_on_surge(m):
    auto = m.Autoscaler(m.AutoscalerConfig(interval=1.0, min_replicas=1,
                                           max_replicas=8), capacity_rps=4.0)
    reps = [_replica(m, 0)]
    wants = [auto.tick(float(t), arrivals=40, replicas=reps) for t in range(4)]
    assert wants[-1] > 1 and any(e.direction > 0 for e in auto.events)
    return wants, [repr(e) for e in auto.events]


def autoscaler_scale_down_needs_patience(m):
    cfg = m.AutoscalerConfig(interval=1.0, min_replicas=1, max_replicas=8,
                             down_patience=3)
    auto = m.Autoscaler(cfg, capacity_rps=4.0)
    reps = [_replica(m, i) for i in range(4)]
    auto.forecaster.observe(16.0)
    results = [auto.tick(float(t), arrivals=0, replicas=reps)
               for t in range(6)]
    first_down = next(i for i, n in enumerate(results) if n < len(reps))
    assert first_down >= cfg.down_patience - 1
    assert any(e.direction < 0 for e in auto.events)
    cfg2 = m.AutoscalerConfig(min_replicas=2, max_replicas=3)
    clamp = m.Autoscaler(cfg2, capacity_rps=1.0)
    assert (clamp.desired_replicas(0.0), clamp.desired_replicas(1e9)) == (2, 3)
    with pytest.raises(ValueError):
        m.Autoscaler(cfg2, capacity_rps=0.0)
    return results, [repr(e) for e in auto.events]


def forecaster_tracks_trend(m):
    f = m.ArrivalForecaster()
    for rate in (10.0, 12.0, 14.0, 16.0, 18.0):
        f.observe(rate)
    assert f.forecast(2.0) > f.forecast(0.0) > 10.0
    return f.level, f.trend, f.forecast(2.0)


def empty_compatible_pool_sheds(m):
    out = []
    for policy in m.POLICIES:
        reps = [_replica(m, 0, model="a")]
        rt = m.Router(m.RouterConfig(policy=policy))
        assert rt.dispatch(_req(m, 0, model="b"), reps, 0.0) is None
        assert rt.stats.pool_faults == 1 and rt.stats.shed == 1
        out.append(rt.stats.summary())
    assert issubclass(m.NoCompatiblePoolError, RuntimeError)
    return out


def round_robin_cursor_isolated_per_pool(m):
    reps = [_replica(m, 0, model="a"), _replica(m, 1, model="a"),
            _replica(m, 2, model="b")]
    rt = m.Router(m.RouterConfig(policy="round_robin"))
    picks = []
    for i in range(4):
        picks.append(rt.dispatch(_req(m, 2 * i, model="a"), reps, 0.0).rid)
        assert rt.dispatch(_req(m, 2 * i + 1, model="b"), reps, 0.0).rid == 2
    assert picks == [0, 1, 0, 1]
    return picks


def single_replica_pool_sticky(m):
    reps = [_replica(m, 0, model="a")]
    rt = m.Router(m.RouterConfig(policy="prefix_affinity"))
    toks = list(range(500, 596))
    picks = [rt.dispatch(_req(m, 0, tokens=list(toks), model="a"), reps,
                         0.0).rid]
    reps = reps + [_replica(m, i, model="b") for i in (1, 2, 3)]
    picks.append(rt.dispatch(_req(m, 1, tokens=list(toks), model="a"), reps,
                             0.0).rid)
    reps = [reps[0], reps[1]]
    picks.append(rt.dispatch(_req(m, 2, tokens=list(toks), model="a"), reps,
                             0.0).rid)
    assert picks == [0, 0, 0]
    return picks, rt.stats.summary()


def slo_aware_sheds_per_tier(m):
    rep = _replica(m, 0, model="a")
    for i in range(40):
        rep.enqueue(_req(m, i, out_len=64), 0.0)
    rt = m.Router(m.RouterConfig(policy="slo_aware", shed_slack=0.0))
    tight = _req(m, 100, slo=0.01, model="a", tier="interactive")
    loose = _req(m, 101, slo=500.0, model="a", tier="batch")
    assert rt.dispatch(tight, [rep], 0.0) is None
    assert rt.dispatch(loose, [rep], 0.0) is rep
    assert rt.stats.shed_by_tier == {"interactive": 1}
    return rt.stats.summary()


def blind_round_robin_bounces_misroutes(m):
    reps = [_replica(m, 0, model="a"), _replica(m, 1, model="b")]
    rt = m.Router(m.RouterConfig(policy="round_robin", model_aware=False))
    picks = [rt.dispatch(_req(m, i, model="a"), reps, 0.0).rid
             for i in range(4)]
    assert picks == [0] * 4 and rt.stats.misroutes > 0
    return rt.stats.summary()


def fleet_marginal_allocation(m):
    cfg = m.FleetAutoscalerConfig
    with pytest.raises(ValueError):
        m.FleetAutoscaler(cfg(), {"a": 0.0})
    fa = m.FleetAutoscaler(cfg(budget=4, min_per_pool=1, target_util=0.75),
                           {"a": 1.0, "b": 1.0})
    conc = fa.desired_allocation({"a": 3.0, "b": 0.5})
    fw = m.FleetAutoscaler(cfg(budget=3, min_per_pool=1, target_util=0.75),
                           {"a": 1.0, "b": 1.0}, weights={"b": 5.0})
    tilt = fw.desired_allocation({"a": 2.0, "b": 2.0})
    assert conc == {"a": 3, "b": 1} and tilt == {"a": 1, "b": 2}
    return conc, tilt


def fleet_dormant_pool_loses_floor(m):
    cfg = m.FleetAutoscalerConfig(interval=1.0, budget=2, min_per_pool=1,
                                  idle_patience=2, down_patience=1,
                                  horizon=1.0)
    fa = m.FleetAutoscaler(cfg, {"a": 1.0, "b": 1.0})
    reps = [_replica(m, 0, model="a"), _replica(m, 1, model="b")]
    t1 = fa.tick(0.0, {"a": 5, "b": 0}, reps)
    t2 = fa.tick(1.0, {"a": 5, "b": 0}, reps)
    assert t1["b"] >= 1 and t2 == {"a": 2, "b": 0}
    return t1, t2, [repr(e) for e in fa.events]


def fleet_budget_conflict_forces_swap(m):
    cfg = m.FleetAutoscalerConfig(interval=1.0, budget=2, min_per_pool=1,
                                  idle_patience=0, down_patience=10,
                                  horizon=1.0)
    fa = m.FleetAutoscaler(cfg, {"a": 1.0, "b": 1.0})
    reps = [_replica(m, 0, model="a"), _replica(m, 1, model="b")]
    targets = fa.tick(0.0, {"a": 6, "b": 0}, reps)
    swaps = [e for e in fa.events if e.swap]
    assert targets == {"a": 2, "b": 0} and swaps and swaps[0].model == "b"
    return targets, [repr(e) for e in fa.events]


def monitor_slo_by_key_segments(m):
    mon = _monitor(m)
    mon.observe_shed(_req(m, 0, model="m1", tier="interactive"))
    mon.observe_scale(+1, 2)
    mon.observe_replicas([1, 3], [0.5, 0.25])
    mon.observe_replicas([0, 0], [0.0, 0.0])
    mon.observe_failure(1, "crash")
    mon.observe_retry()
    mon.observe_retry(exhausted=True)
    mon.observe_retry(deduped=True)
    mon.observe_brownout()
    metrics = mon.metrics()
    assert metrics["slo_by_key"]["model:m1"]["violations"] == 1
    assert metrics["slo_by_key"]["tier:interactive"]["observed"] == 1
    assert metrics["cluster_queue_peak"] == 3
    return str(metrics)


SCENARIOS = {f.__name__: f for f in (
    enqueue_updates_signals, prefix_peek_after_dispatch,
    start_batch_serves_and_accounts, projected_finish_monotone_in_backlog,
    capacity_positive, chunk_interleave_priced_into_drain,
    preempt_shrinks_busy_barrier, round_robin_cycles,
    least_loaded_prefers_idle, prefix_affinity_sticky,
    prefix_affinity_survives_scale_up, slo_aware_sheds_hopeless,
    slo_aware_picks_earliest_finish, pool_backpressure_steers_dispatch,
    draining_replica_excluded, autoscaler_scales_up_on_surge,
    autoscaler_scale_down_needs_patience, forecaster_tracks_trend,
    empty_compatible_pool_sheds, round_robin_cursor_isolated_per_pool,
    single_replica_pool_sticky, slo_aware_sheds_per_tier,
    blind_round_robin_bounces_misroutes, fleet_marginal_allocation,
    fleet_dormant_pool_loses_floor, fleet_budget_conflict_forces_swap,
    monitor_slo_by_key_segments)}


@pytest.mark.parametrize("name", sorted(SCENARIOS))
def test_cluster_scenario_matches_jax(name):
    assert SCENARIOS[name](PKGS["port"]) == SCENARIOS[name](PKGS["jax"])


# ------------------------------------------------------ simulate_cluster

def _sim_run(m, case):
    kind, arg = case
    sched = m.core.get_scheduler("slo-odbs")
    scfg = m.core.SchedulerConfig()
    kw = {}
    if kind == "shared_prefix":
        reqs = m.wl.gen_shared_prefix_requests(m.wl.SharedPrefixConfig(
            n_requests=56, n_templates=8, prefix_len=64, turns=4,
            arrival_rate=16.0, slo_lo=5.0, slo_hi=50.0, seed=4))
        kw = {"n_replicas": 3, "router": arg}
    elif kind in ("fleet", "fleet_blind"):
        reqs = m.wl.gen_mixed_requests(m.wl.MixedWorkloadConfig(
            models=(("chatglm2-6b", 0.5), ("qwen2-1.5b", 0.5)),
            tiers=(("interactive", 4.0, 12.0), ("batch", 20.0, 60.0)),
            n_requests=64, arrival_rate=10.0, seed=2))
        kw = {"pools": [m.ModelPoolSpec("chatglm2-6b", replicas=1),
                        m.ModelPoolSpec("qwen2-1.5b", replicas=1)],
              "router": "least_loaded"}
        if kind == "fleet_blind":
            kw["router"] = m.RouterConfig(policy="round_robin",
                                          model_aware=False)
        elif arg == "joint":
            kw["autoscale"] = m.FleetAutoscalerConfig(
                interval=1.0, budget=3, min_per_pool=1, spawn_delay=0.5)
        else:
            kw["autoscale"] = m.AutoscalerConfig(
                interval=1.0, min_replicas=1, max_replicas=3,
                spawn_delay=0.5)
    else:
        pattern = "bursty" if kind == "autoscale" else "poisson"
        reqs = m.wl.gen_requests(m.wl.WorkloadConfig(
            n_requests=64, arrival_rate=16.0 if kind == "fixed" else 10.0,
            slo_lo=5.0, slo_hi=50.0, seed=2 if kind == "fixed" else 9,
            arrival_pattern=pattern))
        kw = {"n_replicas": 2 if kind == "fixed" else 1, "router": arg}
        if kind == "autoscale":
            kw["autoscale"] = m.AutoscalerConfig(
                interval=1.0, min_replicas=1, max_replicas=5,
                spawn_delay=0.5, down_patience=2)
    mon = _monitor(m)
    res = m.sim.simulate_cluster(reqs, m.CFG, sched, scfg, monitor=mon, **kw)
    return res, mon


SIM_CASES = ([("fixed", p) for p in router.POLICIES]
             + [("autoscale", p) for p in router.POLICIES]
             + [("shared_prefix", "round_robin"),
                ("shared_prefix", "prefix_affinity"),
                ("fleet", "joint"), ("fleet", "independent"),
                ("fleet_blind", "round_robin")])


@pytest.mark.parametrize("case", SIM_CASES, ids=lambda c: f"{c[0]}-{c[1]}")
def test_simulate_cluster_matches_jax(case):
    """``simulate_cluster`` on 56-64 requests: each router on a fixed pair
    of replicas and under the autoscaler (bursty arrivals), round robin
    against prefix affinity on multi-turn shared prefixes, and a
    two-model fleet under the joint allocator, independent per-pool
    autoscalers and a model-blind router.  Summary, per-replica stats,
    scale events, request stamps and monitor metrics equal the
    reference's; conservation and the reference's directional claims hold."""
    out = {}
    for name, m in PKGS.items():
        res, mon = _sim_run(m, case)
        out[name] = (str(res.summary()), str(res.replica_stats),
                     [repr(e) for e in res.scale_events],
                     [(r.rid, r.model, r.start_time, r.first_token_time,
                       r.finish_time) for r in res.requests],
                     str(mon.metrics()))
        port = res
    assert out["port"] == out["jax"]
    res = port
    kind, arg = case
    assert len(res.finished) + len(res.shed) == len(res.requests)
    assert sum(s["served"] for s in res.replica_stats) == len(res.finished)
    for s in res.replica_stats:
        assert s["dmap_path"], "every replica deployed through HELR"
    if kind == "fixed":
        assert res.peak_replicas == 2
    if kind == "autoscale":
        assert res.peak_replicas > 1 and res.scale_events
        assert res.replica_seconds < res.peak_replicas * res.makespan
    if kind == "shared_prefix" and arg == "prefix_affinity":
        rr, _ = _sim_run(PKGS["port"], ("shared_prefix", "round_robin"))
        assert res.prefill_tokens < rr.prefill_tokens
        assert res.prefix_hit_rate > rr.prefix_hit_rate
    if kind == "fleet":
        s = res.summary()
        assert set(s["by_model"]) == {"chatglm2-6b", "qwen2-1.5b"}
        if arg == "joint":
            assert res.peak_replicas <= 3 and res.scale_events
    if kind == "fleet_blind":
        assert res.summary()["router"].get("misroutes", 0) > 0


def test_more_replicas_not_slower():
    """Three replicas finish a 64-request load no later and meet no fewer
    deadlines than one (the reference's claim), in the port."""
    m = PKGS["port"]
    reqs = m.wl.gen_requests(m.wl.WorkloadConfig(
        n_requests=64, arrival_rate=30.0, slo_lo=5.0, slo_hi=50.0, seed=2))
    runs = [m.sim.simulate_cluster(
        [copy.deepcopy(r) for r in reqs], m.CFG,
        m.core.get_scheduler("slo-odbs"), m.core.SchedulerConfig(),
        n_replicas=n, router="round_robin") for n in (1, 3)]
    assert runs[1].makespan <= runs[0].makespan
    assert runs[1].slo_attainment >= runs[0].slo_attainment
