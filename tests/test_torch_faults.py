"""The port's fault injection and fault-tolerant cluster against the JAX
package's: fault plans materialized under a seed, and ``simulate_cluster``
in fault mode (crash, partition, stall and degrade; retry with backoff and
its budget, health checks, brownout by tier, the straggler mitigator, the
autoscaler's respawns), each run in both packages on the same requests:
the reference test's claim (``tests/test_faults.py``) must hold and the
summary, shed list, request stamps and monitor metrics must be equal."""
import copy
from types import SimpleNamespace

import pytest

import repro.configs as jax_configs
import repro.core as jax_core
import repro.data.workload as jax_workload
import repro.serving as jax_serving
import repro_torch.configs as configs
import repro_torch.core as core
import repro_torch.data.workload as workload
import repro_torch.serving as serving

PKGS = {name: SimpleNamespace(core=c, wl=wl, sv=sv,
                              CFG=cf.get_config("chatglm2-6b"))
        for name, cf, c, wl, sv in (
            ("jax", jax_configs, jax_core, jax_workload, jax_serving),
            ("port", configs, core, workload, serving))}


def _monitor(m):
    device = {} if m is PKGS["jax"] else {"device": "cpu"}
    pred = m.core.LengthPredictor(m.core.PredictorConfig(), seed=0, **device)
    return m.core.Monitor(m.core.ResourceProfiler(pred, m.CFG),
                          update_on_miss=False)


def _workload(m, n=60, **kw):
    base = dict(n_requests=n, arrival_rate=16.0, slo_lo=5.0, slo_hi=50.0,
                seed=2)
    base.update(kw)
    return m.wl.gen_requests(m.wl.WorkloadConfig(**base))


def test_fault_plans_match_jax():
    """Validation, seeded materialization (random stalls then crashes,
    crashes ending a lane, scripted events merged in time order), and the
    retry backoff, equal to the reference's."""
    got = {}
    for name, m in PKGS.items():
        sv = m.sv
        for bad in ({"kind": "melt"}, {"kind": "stall"},
                    {"kind": "degrade", "factor": 0.5}):
            with pytest.raises(ValueError):
                sv.FaultEvent(t=1.0, rid=0, **bad)
        plans = [sv.FaultPlan(mtbf=3.0, mttr=1.0, seed=7,
                              kinds=("stall", "crash")),
                 sv.FaultPlan(mtbf=3.0, mttr=1.0, seed=8),
                 sv.FaultPlan(mtbf=1.0, seed=0, kinds=("crash",)),
                 sv.FaultPlan(events=[sv.FaultEvent(2.0, "partition", 1, 3.0),
                                      sv.FaultEvent(0.5, "degrade", 0, 0.0,
                                                    4.0)],
                              mtbf=5.0, mttr=0.5, seed=11,
                              kinds=("degrade", "partition", "crash"))]
        horizons = (30.0, 30.0, 100.0, 40.0)
        evs = [[(e.t, e.kind, e.rid, e.duration, e.factor)
                for e in p.materialize(4 if i != 2 else 2, h)]
               for i, (p, h) in enumerate(zip(plans, horizons))]
        assert evs[0] and evs[0] == [
            (e.t, e.kind, e.rid, e.duration, e.factor)
            for e in plans[0].materialize(4, 30.0)]
        assert [(e[0], e[2]) for e in evs[0]] != [(e[0], e[2]) for e in evs[1]]
        assert len(evs[2]) == 2            # one crash a lane, then silence
        r = sv.RetryConfig(budget=3, backoff_base=0.25, backoff_mult=2.0)
        assert [r.backoff(i) for i in range(3)] == [0.25, 0.5, 1.0]
        got[name] = evs
    assert got["port"] == got["jax"]


def _case(m, name):
    """One scenario of the reference's ``TestClusterFaults``: (requests,
    simulate_cluster keywords)."""
    sv = m.sv
    health = sv.HealthConfig(check_interval=0.2, detect_lag=0.5)
    crash = [sv.FaultEvent(t=0.6, kind="crash", rid=1)]
    kw = {"n_replicas": 3, "router": "least_loaded", "health": health}
    reqs = _workload(m)
    if name == "crash_retried":
        kw.update(faults=crash, retry=sv.RetryConfig(budget=2))
    elif name == "retry_budget_exhausted":
        kw.update(faults=crash, retry=sv.RetryConfig(budget=0))
    elif name == "partition_deduped":
        kw.update(faults=[sv.FaultEvent(t=0.6, kind="partition", rid=1,
                                        duration=4.0)],
                  retry=sv.RetryConfig(budget=2))
    elif name == "stall_recovers":
        kw.update(faults=[sv.FaultEvent(t=0.6, kind="stall", rid=1,
                                        duration=2.0)])
    elif name == "seeded_faults":
        kw.update(faults=sv.FaultPlan(mtbf=4.0, mttr=1.0, seed=3,
                                      kinds=("stall", "crash")),
                  retry=sv.RetryConfig(budget=2))
    elif name == "brownout":
        reqs = _workload(m, n=64)
        for i, r in enumerate(reqs):
            r.tier = "batch" if i % 2 else "interactive"
        kw.update(faults=[sv.FaultEvent(t=0.3, kind="crash", rid=1)],
                  retry=sv.RetryConfig(budget=2),
                  health=sv.HealthConfig(check_interval=0.2, detect_lag=0.4,
                                         brownout_tiers=("batch",)))
    elif name == "straggler":
        reqs = _workload(m, n=64, arrival_rate=12.0)
        kw.update(faults=[sv.FaultEvent(t=0.3, kind="degrade", rid=2,
                                        factor=8.0)],
                  health=sv.HealthConfig(check_interval=0.2, detect_lag=0.5,
                                         straggler_factor=2.0))
    elif name == "autoscaler_respawns":
        reqs = _workload(m, n=64, arrival_rate=12.0)
        kw.update(n_replicas=2,
                  faults=[sv.FaultEvent(t=1.0, kind="crash", rid=0)],
                  retry=sv.RetryConfig(budget=2),
                  autoscale=sv.AutoscalerConfig(interval=0.5, min_replicas=2,
                                                max_replicas=4,
                                                spawn_delay=0.5))
    elif name == "scale_down_of_crashed_replica":
        reqs = m.wl.gen_requests(m.wl.WorkloadConfig(
            n_requests=64, arrival_rate=14.0, slo_lo=6.0, slo_hi=50.0,
            seed=11))
        kw.update(router="slo_aware",
                  autoscale=sv.AutoscalerConfig(interval=0.5, min_replicas=3,
                                                max_replicas=5,
                                                spawn_delay=0.5),
                  faults=[sv.FaultEvent(t=2.0, kind="crash", rid=1)],
                  retry=sv.RetryConfig(budget=2),
                  health=sv.HealthConfig(check_interval=0.25, detect_lag=0.5))
    elif name == "zero_healthy_fleet":
        reqs = _workload(m, n=30)
        kw.update(n_replicas=2,
                  faults=[sv.FaultEvent(t=0.2, kind="crash", rid=0),
                          sv.FaultEvent(t=0.2, kind="crash", rid=1)],
                  retry=sv.RetryConfig(budget=1),
                  health=sv.HealthConfig(check_interval=0.2, detect_lag=0.4))
    return reqs, kw


def _run(m, name, retry_budget=None):
    reqs, kw = _case(m, name)
    if retry_budget is not None:
        kw["retry"] = m.sv.RetryConfig(budget=retry_budget)
    mon = _monitor(m)
    res = m.sv.simulate_cluster(reqs, m.CFG, m.core.get_scheduler("slo-odbs"),
                                m.core.SchedulerConfig(), monitor=mon, **kw)
    return res, mon


CASES = ["crash_retried", "retry_budget_exhausted", "partition_deduped",
         "stall_recovers", "seeded_faults", "brownout", "straggler",
         "autoscaler_respawns", "scale_down_of_crashed_replica",
         "zero_healthy_fleet"]


@pytest.mark.parametrize("name", CASES)
def test_fault_mode_matches_jax(name):
    out = {}
    for pkg, m in PKGS.items():
        res, mon = _run(m, name)
        out[pkg] = (str(res.summary()), str(res.replica_stats),
                    [r.rid for r in res.shed],
                    [(r.rid, r.generated, r.start_time, r.first_token_time,
                      r.finish_time) for r in res.requests],
                    str(mon.metrics()))
    assert out["port"] == out["jax"]
    st = mon.stats
    assert len(res.finished) + len(res.shed) == len(res.requests)
    assert st.slo_observed == len(res.requests)
    if name == "crash_retried":
        assert st.failures_by_kind == {"crash": 1} and st.request_retries > 0
        assert "faults" in mon.metrics()
        no, _ = _run(m, name, retry_budget=0)
        assert len(res.finished) > len(no.finished)
    elif name == "retry_budget_exhausted":
        assert res.shed and st.retries_exhausted == len(res.shed)
        assert st.shed_requests == len(res.shed)
    elif name == "partition_deduped":
        assert st.failures_by_kind.get("partition") == 1
        if st.request_retries:
            assert st.retries_deduped > 0
    elif name == "stall_recovers":
        assert st.replica_failures == 0
        assert len(res.finished) == len(res.requests)
    elif name == "seeded_faults":
        again, _ = _run(m, name)
        assert [(r.rid, r.finish_time) for r in again.requests] == \
            [(r.rid, r.finish_time) for r in res.requests]
    elif name == "brownout":
        assert st.brownout_sheds > 0
        assert "interactive" not in {r.tier for r in res.shed}
    elif name == "straggler":
        assert st.failures_by_kind.get("straggler") == 1
    elif name == "autoscaler_respawns":
        assert res.peak_replicas >= 2
    elif name == "scale_down_of_crashed_replica":
        assert st.failures_by_kind == {"crash": 1}
        assert st.request_retries > 0
    elif name == "zero_healthy_fleet":
        assert st.replica_failures == 2


def test_retried_request_resumes_its_prefix():
    """A crash mid-decode gives each lost request its generated-so-far
    count as the retry's recompute prefix, as the reference's ``fail``
    does, and the retry re-stamps it; the deep copies keep the inputs
    untouched."""
    m = PKGS["port"]
    reqs, kw = _case(m, "crash_retried")
    before = copy.deepcopy(reqs)
    res = m.sv.simulate_cluster([copy.deepcopy(r) for r in reqs], m.CFG,
                                m.core.get_scheduler("slo-odbs"),
                                m.core.SchedulerConfig(), **kw)
    resumed = [r for r in res.requests if r.generated > 0]
    assert resumed and all(r.finish_time is not None for r in resumed)
    assert all(r.generated < r.true_output_len for r in resumed)
    assert [(r.rid, r.generated) for r in reqs] == \
        [(r.rid, r.generated) for r in before]
