"""The port's discrete-event simulator against the JAX package's: the
paper's cluster and latency model, the padded-batch ``simulate`` under each
scheduler, the iteration-level ``simulate_continuous``, ``replicated_cluster``,
and the paper's directional checks (``tests/test_serving.py``) on the
port's runs.  Both packages get the same predicted lengths (the JAX
predictor's weights, converted), so summaries, request stamps and monitor
metrics are compared for equality, not closeness."""
import copy
import warnings

import jax
import numpy as np
import pytest

from repro.configs import get_config as jax_get_config
from repro.core import deployer as jax_deployer
from repro.core import monitor as jax_monitor
from repro.core import profiler as jax_profiler
from repro.core import scheduler as jax_scheduler
from repro.core.types import DeviceNode as JaxDeviceNode
from repro.data import workload as jax_workload
from repro.obs import trace as jax_trace
from repro.serving import cluster as jax_cluster
from repro.serving import simulator as jax_sim
from repro.serving.cluster import HardwareProfile as JaxHardwareProfile
from repro_torch.configs import get_config
from repro_torch.core import deployer, monitor, profiler, scheduler
from repro_torch.core.types import DeviceNode
from repro_torch.data import workload
from repro_torch.obs import trace
from repro_torch.params import predictor_from_numpy
from repro_torch.serving import cluster, simulator
from repro_torch.serving.cluster import HardwareProfile

ARCH = "chatglm2-6b"
SCHEDULERS = ["slo-odbs", "slo-dbs", "odbs", "fifo", "s3"]


@pytest.fixture(scope="module")
def setup():
    """``tests/test_serving.py``'s simulator set-up in both packages: the
    paper's model, a predictor fitted in JAX (the port gets its weights), a
    4-GPU topology whose fastest pair spans a NODE link, and 96 requests."""
    jpred = jax_profiler.LengthPredictor(jax_profiler.PredictorConfig(), seed=0)
    toks, lens = jax_workload.train_pairs(jax_workload.WorkloadConfig(), 512,
                                          seed=1)
    jpred.fit(toks, lens, epochs=12)
    perf = [35e12, 25e12, 30e12, 15e12]
    pix, nd = 5e-5, 2e-4
    lat = [[0, pix, nd, nd], [pix, 0, nd, nd],
           [nd, nd, 0, pix], [nd, nd, pix, 0]]
    sides = {}
    for name, cfg, node, wl in (
            ("jax", jax_get_config(ARCH), JaxDeviceNode, jax_workload),
            ("port", get_config(ARCH), DeviceNode, workload)):
        sides[name] = {
            "cfg": cfg, "lat": lat,
            "nodes": [node(i, memory=10e9, performance=perf[i])
                      for i in range(4)],
            "reqs": wl.gen_requests(wl.WorkloadConfig(
                n_requests=96, arrival_rate=24.0, seed=7))}
    sides["jax"]["pred"] = jpred
    sides["port"]["pred"] = predictor_from_numpy(
        jax.tree.map(np.array, jpred.params), profiler.PredictorConfig(),
        device="cpu")
    sides["jax"]["mods"] = (jax_sim, jax_scheduler, jax_monitor, jax_profiler,
                            jax_deployer)
    sides["port"]["mods"] = (simulator, scheduler, monitor, profiler, deployer)
    sides["jax"]["obs"] = (jax_trace, jax_cluster)
    sides["port"]["obs"] = (trace, cluster)
    return sides


def _stamps(reqs):
    return [(r.rid, r.predicted_output_len, r.start_time,
             r.first_token_time, r.finish_time) for r in reqs]


def _simulate(side, sched, deploy="helr", overhead=0.0, **kw):
    sim, sch, mon_mod, prof_mod, dep = side["mods"]
    prof = prof_mod.ResourceProfiler(copy.deepcopy(side["pred"]), side["cfg"])
    mon = mon_mod.Monitor(prof)
    res = sim.simulate([copy.deepcopy(r) for r in side["reqs"]], side["cfg"],
                       sch.get_scheduler(sched), sch.SchedulerConfig(),
                       profiler=prof, monitor=mon, deploy=getattr(dep, deploy),
                       deploy_overhead=overhead, nodes=side["nodes"],
                       latency=side["lat"], **kw)
    return res, mon


@pytest.mark.parametrize("deploy", ["helr", "bgs"])
def test_paper_cluster_and_latency_model_match_jax(deploy):
    """``paper_cluster`` and ``LatencyModel.token_time`` / ``prefill_time``
    on HELR's and BGS's device maps for chatglm2-6b, equal to the
    reference's to the last bit."""
    got = []
    for sim, dep, cfg in ((simulator, deployer, get_config(ARCH)),
                          (jax_sim, jax_deployer, jax_get_config(ARCH))):
        nodes, lat = sim.paper_cluster()
        dmap = getattr(dep, deploy)(cfg.param_count() * 2.0, cfg.n_layers,
                                    nodes, lat)
        lm = sim.LatencyModel(cfg, nodes, lat, dmap)
        got.append((
            [(n.node_id, n.memory, n.performance, n.name) for n in nodes], lat,
            dmap.path, dmap.layers, lm.peak_flops,
            [lm.token_time(b, kv, q) for b in (1, 4, 8, 64)
             for kv in (1, 100.5, 2048) for q in (1, 5)],
            [lm.prefill_time(b, n) for b in (1, 4, 8) for n in (1, 16, 1024)]))
    assert got[0] == got[1]
    assert got[0][2], "the deployment must be feasible"


@pytest.mark.parametrize("sched,prefix_cache",
                         [(s, False) for s in SCHEDULERS] + [("slo-odbs", True)])
def test_simulate_matches_jax(setup, sched, prefix_cache):
    """``simulate`` under each scheduler (and with the prefix cache's
    accounting): the same summary, request stamps and monitor metrics, the
    profiler's online updates included."""
    out = {}
    for name in ("jax", "port"):
        res, mon = _simulate(setup[name], sched, prefix_cache=prefix_cache)
        out[name] = (str(res.summary()), _stamps(res.requests), res.makespan,
                     res.useful_flops, str(mon.metrics()))
    assert out["port"] == out["jax"]


CONTINUOUS = {
    "monolithic": {},
    "chunked": {"chunk_tokens": 64},
    "preempt": {"preempt": True, "chunk_tokens": 32, "n_blocks": 64,
                "max_new": 256},
    "speculate": {"spec_tokens": 4, "spec_acceptance": 0.6},
}


@pytest.mark.parametrize("case", sorted(CONTINUOUS))
def test_simulate_continuous_matches_jax(setup, case):
    """``simulate_continuous``: whole-prompt and chunked prefill,
    preemption under a small pool, speculation; the same summary, stamps,
    inter-token gaps and monitor metrics."""
    out = {}
    for name in ("jax", "port"):
        side = setup[name]
        sim, _, mon_mod, prof_mod, dep = side["mods"]
        prof = prof_mod.ResourceProfiler(copy.deepcopy(side["pred"]),
                                         side["cfg"])
        mon = mon_mod.Monitor(prof)
        res = sim.simulate_continuous(
            [copy.deepcopy(r) for r in side["reqs"]], side["cfg"],
            profiler=prof, monitor=mon, nodes=side["nodes"],
            latency=side["lat"], **CONTINUOUS[case])
        summary = res.summary()
        out[name] = (str(summary), _stamps(res.requests), res.steps,
                     res.emitted_tokens, res.inter_token_s, str(mon.metrics()))
    assert out["port"] == out["jax"]
    if case == "preempt":
        assert summary["preemptions"] > 0
    if case == "speculate":
        assert summary["iterations_per_token"] < 1.0
    if case == "chunked":
        assert summary["prefill_chunks"] > len(setup["port"]["reqs"])


def test_trace_events_match_jax(setup):
    """The span vocabulary the simulators emit through the tracer: the
    iteration-level simulator with chunks and preemption, then the
    replicated cluster under the autoscaler with a crash, retries and
    brownout on one tracer; the same events (name, phase, time, duration,
    track, row, args) in the same order as the reference's."""
    got = {}
    for name in ("jax", "port"):
        side = setup[name]
        sim, sch, mon_mod, prof_mod, _ = side["mods"]
        tr_mod, cl = side["obs"]
        tracer = tr_mod.Tracer()
        prof = prof_mod.ResourceProfiler(copy.deepcopy(side["pred"]),
                                         side["cfg"])
        mon = mon_mod.Monitor(prof)
        sim.simulate_continuous(
            [copy.deepcopy(r) for r in side["reqs"][:48]], side["cfg"],
            profiler=prof, monitor=mon, nodes=side["nodes"],
            latency=side["lat"], tracer=tracer, track=5,
            **CONTINUOUS["preempt"])
        reqs = [copy.deepcopy(r) for r in side["reqs"][:48]]
        for i, r in enumerate(reqs):
            r.tier = "batch" if i % 2 else "interactive"
        sim.simulate_cluster(
            reqs, side["cfg"], sch.get_scheduler("slo-odbs"),
            sch.SchedulerConfig(), n_replicas=2, router="slo_aware",
            profiler=prof, monitor=mon, tracer=tracer,
            autoscale=cl.AutoscalerConfig(interval=0.5, min_replicas=2,
                                          max_replicas=4, spawn_delay=0.5),
            faults=[cl.FaultEvent(t=0.5, kind="crash", rid=1)],
            health=cl.HealthConfig(check_interval=0.2, detect_lag=0.4,
                                   brownout_tiers=("batch",)))
        got[name] = [(e.name, e.ph, e.t0, e.dur, e.track, e.row, e.args)
                     for e in tracer.events]
    assert got["port"] == got["jax"]
    names = {e[0] for e in got["port"]}
    assert {"queued", "prefill_chunk", "decode", "preempt", "batch_prefill",
            "batch_decode", "route", "replica_failed", "retry",
            "brownout"} <= names


def test_replicated_cluster_matches_jax():
    """Per-partition heterogeneity (a float, a ``{"scale": s}`` dict, a
    ``HardwareProfile``), the count check and the deprecated global
    ``scale``, as in the reference."""
    got = []
    for sim, hw in ((simulator, HardwareProfile),
                    (jax_sim, JaxHardwareProfile)):
        parts = sim.replicated_cluster(
            profiles=[1.0, {"scale": 0.5}, hw(scale=0.25)])
        with pytest.raises(ValueError):
            sim.replicated_cluster(2, profiles=[1.0])
        with pytest.raises(TypeError):
            sim.replicated_cluster()
        with pytest.warns(DeprecationWarning):
            legacy = sim.replicated_cluster(2, scale=0.5)
        with warnings.catch_warnings():
            warnings.simplefilter("error")
            plain = sim.replicated_cluster(2)
        got.append([[(n.node_id, n.memory, n.performance, n.name)
                     for n in nodes] + [lat] for nodes, lat in
                    parts + legacy + plain])
    assert got[0] == got[1]
    base = got[0][0][0][2]
    assert got[0][1][0][2] == base * 0.5 and got[0][2][0][2] == base * 0.25


@pytest.mark.parametrize("check", ["conserves", "ua_beats_fifo",
                                   "helr_not_worse_than_bgs",
                                   "morphling_costs_latency"])
def test_paper_directional_checks_hold_in_the_port(setup, check):
    """The reference's directional checks of the paper's claims
    (``tests/test_serving.py:101-126``), on the port's simulator."""
    side = setup["port"]
    ua, _ = _simulate(side, "slo-odbs")
    if check == "conserves":
        assert all(r.finish_time is not None for r in ua.requests)
        assert ua.throughput > 0
        assert 0 <= ua.slo_violation_rate <= 1
    elif check == "ua_beats_fifo":
        fifo, _ = _simulate(side, "fifo")
        assert ua.slo_violation_rate <= fifo.slo_violation_rate + 1e-9
    elif check == "helr_not_worse_than_bgs":
        ub, _ = _simulate(side, "slo-odbs", deploy="bgs")
        assert ua.avg_latency <= ub.avg_latency * 1.05
    else:
        oh = simulator.morphling_deploy_overhead(side["cfg"], side["nodes"],
                                                 side["lat"])
        ref = setup["jax"]
        assert oh > 0
        assert oh == jax_sim.morphling_deploy_overhead(ref["cfg"], ref["nodes"],
                                                       ref["lat"])
        mor, _ = _simulate(side, "fifo", overhead=oh)
        ud, _ = _simulate(side, "fifo")
        assert mor.avg_latency > ud.avg_latency
