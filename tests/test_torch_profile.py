"""The port's online cost profiler and calibrated pricing against the JAX
package's (``tests/test_profile.py``'s cases, each run through both
packages on the same spans, samples and acceptance counts): the span sink
with its per-iteration dedupe, residual ratios and band-crossing drift,
half-life decay, per-replica and per-model scopes, the
``CalibratedLatencyModel`` chain and its coverage counters, the v1, v2 and
v3 registries, the acceptance EMA, the replica's execution/belief split
and the metrics profile block: ``to_json()``, prices and counters equal.

Then the serve CLI's observability flags against the JAX CLI's, both given
the same fitted predictor: on the simulated cluster the trace, metrics and
saved profile are equal (the simulator's clock), and a ``--profile-in``
rerun prints the same lines; on the live reduced smollm (``--replicas 2
--paged --speculate``, the padded ``--metrics-json`` run and ``ci.sh``'s
traced and profile smokes) everything but wall-clock times is equal."""
import contextlib
import copy
import dataclasses
import io
import json
import re
import sys
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from repro import obs as jax_obs
from repro.configs import get_config as jax_get_config
from repro.core import deployer as jax_deployer
from repro.core import get_scheduler as jax_get_scheduler
from repro.core import monitor as jax_monitor
from repro.core import profiler as jax_profiler
from repro.core import scheduler as jax_scheduler
from repro.core import types as jax_types
from repro.data import workload as jax_workload
from repro.launch import serve as jax_serve
from repro.models import api as jax_api
from repro.serving import cluster as jax_cluster
from repro.serving import simulator as jax_simulator
from repro_torch import obs
from repro_torch.configs import get_config
from repro_torch.core import deployer, get_scheduler, monitor, profiler
from repro_torch.core import scheduler, types
from repro_torch.launch import serve
from repro_torch.models import api
from repro_torch.params import from_jax_params, predictor_from_numpy
from repro_torch.serving import cluster, simulator

ARCH = "chatglm2-6b"


def _side(name: str) -> SimpleNamespace:
    """One package's modules under common names, and its analytic latency
    model of chatglm2-6b on the paper's cluster (HELR deployment)."""
    if name == "jax":
        ns = SimpleNamespace(obs=jax_obs, cfg=jax_get_config(ARCH),
                             deployer=jax_deployer, sim=jax_simulator,
                             cluster=jax_cluster, sched=jax_scheduler,
                             get_scheduler=jax_get_scheduler,
                             types=jax_types, monitor=jax_monitor,
                             profiler=jax_profiler,
                             small=jax_get_config("smollm-135m").reduced())
    else:
        ns = SimpleNamespace(obs=obs, cfg=get_config(ARCH), deployer=deployer,
                             sim=simulator, cluster=cluster, sched=scheduler,
                             get_scheduler=get_scheduler, types=types,
                             monitor=monitor, profiler=profiler,
                             small=get_config("smollm-135m").reduced())
    nodes, lat = ns.sim.paper_cluster()
    dmap = ns.deployer.helr(ns.cfg.param_count() * 2.0, ns.cfg.n_layers,
                            nodes, lat)
    ns.lm = ns.sim.LatencyModel(ns.cfg, nodes, lat, dmap)
    ns.bad = dataclasses.replace(ns.lm, efficiency=ns.lm.efficiency * 0.5)
    return ns


SIDES = ("jax", "port")


def both(fn):
    """``fn`` run on each package; asserts the results equal and returns
    the port's."""
    got = {s: fn(_side(s)) for s in SIDES}
    assert got["port"] == got["jax"]
    return got["port"]


def _feed(s, prof, tr, lm, n=40, seed=0):
    """Measured (ground-truth) spans through the tracer into the profiler,
    over a spread of operating points (``tests/test_profile.py``'s)."""
    rng = np.random.default_rng(seed)
    t = 0.0
    for _ in range(n):
        b = int(rng.choice([1, 2, 4, 8]))
        kv = float(rng.choice([64, 128, 256, 512]))
        d = lm.token_time(b, kv)
        tr.span("decode", t, t + d, row=2,
                args={"batch": b, "kv": kv, "q_tokens": 1})
        t += d
        pl = int(rng.choice([32, 64, 128, 256]))
        dp = lm.prefill_time(b, pl)
        tr.span("batch_prefill", t, t + dp, args={"batch": b, "tokens": pl})
        t += dp
    return t


def _events(tr):
    return [(e.name, e.ph, e.t0, e.dur, e.track, e.row, e.args)
            for e in tr.events]


GRID = ((1, 64), (4, 256), (8, 512), (32, 1000), (64, 300), (2, 100))


def _prices(cal):
    return ([cal.token_time(b, kv) for b, kv in GRID]
            + [cal.prefill_time(b, int(kv)) for b, kv in GRID],
            cal.coverage_counters())


# ---------------------------------------------------------------- bucketing

def test_operating_point_buckets_match_jax():
    pts = [0.0, 0.5, 1, 2, 3, 4, 5, 8, 9, 16, 17, 64, 100, 110, 128, 1000,
           4097.5]
    got = both(lambda s: ([s.obs.batch_bucket(int(b)) for b in pts],
                          [s.obs.token_bucket(t) for t in pts],
                          [s.obs.kv_bucket(t) for t in pts]))
    assert got[0][1:8] == [1, 1, 2, 3, 4, 8, 8] and got[0][8] == 16
    assert got[1][0] == 0 and got[1][11] != got[1][14]
    assert got[1][12] == got[1][13]


# ----------------------------------------------------------------- the sink

def test_sink_collects_cells_and_dedupes_slot_copies_matches_jax():
    def run(s):
        prof = s.obs.CostProfiler()
        tr = s.obs.Tracer(retain=False)
        tr.add_sink(prof.on_event)
        for slot in range(4):      # one batch-of-4 iteration, 4 slot copies
            tr.span("decode", 1.0, 1.01, row=2 + slot,
                    args={"batch": 4, "kv": 128.0, "q_tokens": 1})
        one = prof.decode_cell(4, 128.0).count
        tr.span("decode", 2.0, 2.02, row=2, args={"batch": 4, "kv": 128.0})
        tr.span("decode", 3.0, 3.01, args={"rid": 1})      # no point: ignored
        tr.instant("finish", 4.0)
        tr.span("queued", 0.0, 5.0, args={"batch": 1, "kv": 1.0})
        return one, prof.to_json(), tr.events
    one, reg, kept = both(run)
    assert one == 1 and kept == []
    assert [c["count"] for c in reg["fleet"]["cells"]] == [2]


def test_batch_decode_drain_normalizes_per_iteration_matches_jax():
    def run(s):
        prof = s.obs.CostProfiler()
        tr = s.obs.Tracer()
        tr.add_sink(prof.on_event)
        tr.span("batch_decode", 0.0, 1.0,
                args={"batch": 8, "kv": 200.0, "q_tokens": 1, "iters": 50.0})
        cell = prof.decode_cell(8, 200.0)
        return cell.count, cell.ema_s, prof.to_json()
    count, ema, _ = both(run)
    assert count == 50 and ema == pytest.approx(1.0 / 50.0)


# -------------------------------------------------------- residuals & drift

def test_residual_ratio_and_drift_instant_match_jax():
    def run(s):
        tr = s.obs.Tracer()
        prof = s.obs.CostProfiler(reference=s.bad, tracer=tr, drift_tol=0.25,
                                  drift_min_samples=4)
        tr.add_sink(prof.on_event)
        _feed(s, prof, tr, s.lm, n=30)
        return (prof.phase_correction("prefill"),
                prof.phase_correction("decode"), prof.metrics(),
                prof.to_json(), _events(tr),
                s.obs.check_invariants(tr.events))
    pre, dec, m, _, events, errs = both(run)
    assert pre[1] >= 30 and pre[0] == pytest.approx(0.5, rel=0.05)
    assert abs(dec[0] - 1.0) < 0.25 and errs == []
    drifts = [e for e in events if e[0] == "profile_drift"]
    assert len(drifts) == 1 and drifts[0][6]["phase"] == "prefill"
    assert m["drift_events"] == 1


def test_drift_rearms_after_band_reentry_matches_jax():
    def run(s):
        prof = s.obs.CostProfiler(reference=s.lm, tracer=s.obs.Tracer(),
                                  drift_tol=0.2, drift_min_samples=2,
                                  half_life=1)
        pred = s.lm.prefill_time(1, 128)
        counts = []
        for factor, n in ((2.0, 4), (1.0, 6), (2.0, 4)):
            for _ in range(n):
                prof.observe_prefill(pred * factor, batch=1, tokens=128)
            counts.append(prof.drift_events)
        return counts, prof.to_json(), _events(prof.tracer)
    counts, _, _ = both(run)
    assert counts == [1, 1, 2]


# -------------------------------------------------------------- calibration

def test_calibration_recovers_miscalibrated_predictions_matches_jax():
    def run(s):
        tr = s.obs.Tracer(retain=False)
        prof = s.obs.CostProfiler(reference=s.bad, tracer=tr)
        tr.add_sink(prof.on_event)
        _feed(s, prof, tr, s.lm, n=40)
        for _ in range(3):
            prof.observe_prefill(s.lm.prefill_time(4, 256), batch=4,
                                 tokens=256)
        cal = s.obs.CalibratedLatencyModel(s.bad, prof)
        covered = cal.prefill_time(4, 256)
        uncovered = cal.prefill_time(64, 300)
        virgin = s.obs.CalibratedLatencyModel(s.bad, s.obs.CostProfiler())
        return (covered, uncovered, s.lm.prefill_time(4, 256),
                s.lm.prefill_time(64, 300), cal.coverage_counters(),
                _prices(cal), virgin.token_time(4, 256) ==
                s.bad.token_time(4, 256), virgin.coverage_counters(),
                cal.peak_flops == s.bad.peak_flops,
                cal.efficiency == s.bad.efficiency)
    got = both(run)
    assert got[0] == pytest.approx(got[2], rel=0.05)
    assert got[1] == pytest.approx(got[3], rel=0.05)
    assert got[4]["cell_hits"] >= 1 and got[4]["covered_frac"] > 0
    assert got[6] and got[7]["cell_misses"] == 1 and got[8] and got[9]


def test_well_calibrated_model_is_a_fixed_point_matches_jax():
    def run(s):
        tr = s.obs.Tracer(retain=False)
        prof = s.obs.CostProfiler(reference=s.lm, tracer=tr)
        tr.add_sink(prof.on_event)
        _feed(s, prof, tr, s.lm, n=20)
        cal = s.obs.CalibratedLatencyModel(s.lm, prof)
        return _prices(cal), [s.lm.token_time(b, kv) for b, kv in GRID] + \
            [s.lm.prefill_time(b, int(kv)) for b, kv in GRID]
    (prices, _), analytic = both(run)
    assert prices == pytest.approx(analytic)


# ----------------------------------------------------------------- registry

def test_registry_round_trips_across_packages():
    """A registry the JAX profiler wrote loads in the port to the same
    predictions and writes back byte-identical, and the other way round;
    unknown versions raise in both."""
    regs = {}
    for name in SIDES:
        s = _side(name)
        tr = s.obs.Tracer(retain=False)
        prof = s.obs.CostProfiler(reference=s.bad, tracer=tr)
        tr.add_sink(prof.on_event)
        _feed(s, prof, tr, s.lm, n=25)
        prof.observe_acceptance(3, 4)
        regs[name] = (json.dumps(prof.to_json()), prof)
    assert regs["port"][0] == regs["jax"][0]
    for src, dst in (("jax", "port"), ("port", "jax")):
        s = _side(dst)
        back = s.obs.CostProfiler.from_json(json.loads(regs[src][0]),
                                            reference=s.bad)
        assert json.dumps(back.to_json()) == regs[src][0]
        assert back.metrics() == regs[src][1].metrics()
        assert back.spec_acceptance == regs[src][1].spec_acceptance
        assert _prices(s.obs.CalibratedLatencyModel(s.bad, back)) == \
            _prices(s.obs.CalibratedLatencyModel(_side(src).bad,
                                                 regs[src][1]))
        with pytest.raises(ValueError, match="profile_version"):
            s.obs.CostProfiler.from_json({"profile_version": 999})


def test_registry_file_save_load_matches_jax(tmp_path):
    for name in SIDES:
        s = _side(name)
        prof = s.obs.CostProfiler()
        prof.observe_decode(0.01, batch=4, kv=128)
        prof.save(tmp_path / f"{name}.json")
    assert (tmp_path / "port.json").read_text() == \
        (tmp_path / "jax.json").read_text()
    back = obs.CostProfiler.load(tmp_path / "jax.json")
    assert back.decode_cell(4, 128).count == 1
    assert back.decode_cell(4, 128).ema_s == pytest.approx(0.01)


# ----------------------------------------------------- acceptance EMA

def test_spec_acceptance_ema_and_bootstrap_match_jax():
    def run(s):
        prof = s.obs.CostProfiler()
        seen = [prof.spec_acceptance]
        prof.observe_acceptance(4, 4)
        seen.append(prof.spec_acceptance)
        for _ in range(20):
            prof.observe_acceptance(1, 4)
        prof.observe_acceptance(0, 0)                 # zero drafts: ignored
        seen.append(prof.spec_acceptance)
        cfg = s.sched.SchedulerConfig().with_speculation(4, seen[-1])
        return (seen, prof.spec_samples, cfg.spec_speedup,
                s.sched.spec_speedup(4, seen[-1]),
                s.sched.SchedulerConfig().spec_speedup, prof.metrics())
    seen, samples, speedup, want, plain, _ = both(run)
    assert seen[:2] == [0.5, 1.0] and seen[2] == pytest.approx(0.25, abs=0.05)
    assert samples == 21 and speedup == pytest.approx(want) and plain == 1.0


# ------------------------------------------- replica execution/belief split

def _req(s, rid, *, in_len=64, out_len=32, slo=30.0, arrival=0.0):
    toks = list(range(100, 100 + in_len))
    r = s.types.Request(rid=rid, tokens=toks, input_len=len(toks), slo=slo,
                        arrival=arrival, true_output_len=out_len)
    r.predicted_output_len = out_len
    return r


def test_replica_price_model_changes_beliefs_not_execution_matches_jax():
    def run(s):
        out = []
        for price in (False, True):
            nodes, lat = s.sim.paper_cluster()
            rep = s.cluster.Replica(0, s.cfg, nodes, lat)
            if price:
                rep.price = dataclasses.replace(
                    rep.lm, efficiency=rep.lm.efficiency * 0.5)
            for i in range(4):
                rep.enqueue(_req(s, i), 0.0)
            out.append((rep.projected_drain(),
                        rep.projected_finish(_req(s, 99, slo=5.0), 0.0),
                        rep.capacity_rps(),
                        rep.start_batch(0.0, s.get_scheduler("slo-odbs"),
                                        s.sched.SchedulerConfig())))
        return out
    honest, deluded = both(run)
    assert deluded[0] > honest[0] and deluded[1] > honest[1]
    assert deluded[2] < honest[2] and deluded[3] == honest[3]


def test_simulate_continuous_latency_model_override_matches_jax():
    def run(s):
        def mk():
            reqs = [_req(s, i, in_len=48, out_len=8) for i in range(4)]
            for r in reqs:
                r.predicted_output_len = r.true_output_len
            return reqs
        base = s.sim.simulate_continuous(mk(), s.cfg, max_batch=4, max_new=8,
                                         latency_model=s.lm)
        slow = s.sim.simulate_continuous(mk(), s.cfg, max_batch=4, max_new=8,
                                         latency_model=s.bad)
        return (base.makespan, slow.makespan, base.emitted_tokens,
                slow.emitted_tokens)
    base, slow, e1, e2 = both(run)
    assert slow > base and e1 == e2


def test_simulator_spans_feed_profiler_coverage_matches_jax():
    def run(s):
        def mk():
            rng = np.random.default_rng(5)
            return [_req(s, i, in_len=int(rng.integers(32, 128)),
                         out_len=int(rng.integers(4, 16)), arrival=0.1 * i)
                    for i in range(8)]
        kw = dict(max_batch=4, max_new=16, chunk_tokens=32)
        prof = s.obs.CostProfiler(reference=s.lm)
        tr = s.obs.Tracer(retain=False)
        tr.add_sink(prof.on_event)
        observed = s.sim.simulate_continuous(mk(), s.cfg, tracer=tr, **kw)
        plain = s.sim.simulate_continuous(mk(), s.cfg, **kw)
        stamps = [(r.rid, r.finish_time) for r in observed.requests]
        assert stamps == [(r.rid, r.finish_time) for r in plain.requests]
        return observed.makespan, prof.coverage(), prof.to_json()
    _, cov, _ = both(run)
    assert cov["decode"]["samples"] > 0 and cov["prefill"]["samples"] > 0


# ------------------------------------------------------------ metrics schema

def test_metrics_schema_v6_profile_block_matches_jax():
    def run(s):
        prof = s.obs.CostProfiler()
        prof.observe_decode(0.01, batch=4, kv=128)
        p = s.obs.metrics_payload("x", latency_s=1.0, profile=prof.metrics())
        verdicts = [s.obs.validate_metrics(p)]
        for old in (3, 4, 5):
            verdicts.append(s.obs.validate_metrics(
                dict(s.obs.metrics_payload("x"), schema=old)))
        v2 = {k: v for k, v in s.obs.metrics_payload("x").items()
              if k != "profile"}
        verdicts.append(s.obs.validate_metrics(dict(v2, schema=2)))
        verdicts.append(s.obs.validate_metrics(
            dict(s.obs.metrics_payload("x"), profile=3)))
        return p, verdicts
    p, verdicts = both(run)
    assert p["schema"] == 6 and p["profile"]["coverage"]["decode"]["samples"] == 1
    assert [v == [] for v in verdicts] == [True] * 4 + [False] * 2


def _monitor(s, **kw):
    """A monitor over the reduced smollm's predictor at seed 0 (the port's
    carrying the JAX weights)."""
    jpred = jax_profiler.LengthPredictor(
        jax_profiler.PredictorConfig(vocab=s.small.vocab_size), seed=0)
    pred = jpred if s.obs is jax_obs else predictor_from_numpy(
        jax.tree.map(np.array, jpred.params),
        profiler.PredictorConfig(vocab=s.small.vocab_size), device="cpu")
    return s.monitor.Monitor(s.profiler.ResourceProfiler(pred, s.small), **kw)


def test_monitor_publishes_length_prediction_confusion_matches_jax():
    def run(s):
        mon = _monitor(s, update_on_miss=False)
        pred = mon.profiler.predictor
        buckets = pred.length_to_bucket([4, 50])
        for i, true in enumerate((4, 4, 50)):
            r = _req(s, i, in_len=6, out_len=true)
            r.predicted_bucket = int(buckets[0])
            mon.observe(r)
        return [int(b) for b in buckets], mon.metrics()
    buckets, m = both(run)
    lp = m["length_prediction"]
    assert lp["accuracy"] == pytest.approx(2 / 3, abs=0.01)
    assert lp["confusion"][f"{buckets[0]}->{buckets[1]}"] == 1


# -------------------- per-replica profiles, quantile pricing, decay

def test_per_replica_cells_and_fleet_fallback_match_jax():
    def run(s):
        prof = s.obs.CostProfiler(reference=s.lm)
        pred = s.lm.prefill_time(2, 128)
        for _ in range(10):
            prof.observe_prefill(pred, batch=2, tokens=128, replica=0)
            prof.observe_prefill(pred * 2.0, batch=2, tokens=128, replica=1)
        cals = [s.obs.CalibratedLatencyModel(s.lm, prof, replica=r)
                for r in (0, 1, 7)]
        return ([prof.prefill_cell(2, 128, replica=r).ratio_ema
                 for r in (0, 1)], prof.prefill_cell(2, 128).ratio_ema,
                [_prices(c) for c in cals], prof.replica_coverage(),
                prof.metrics(), prof.to_json(), pred)
    ratios, fleet, prices, cov, m, _, pred = both(run)
    assert ratios == pytest.approx([1.0, 2.0]) and fleet == pytest.approx(1.5)
    assert set(cov) == {0, 1} and cov[1]["prefill"]["samples"] == 10
    assert m["replicas"]["1"]["calibration_ratio"]["prefill"] == \
        pytest.approx(2.0)


def test_quantile_pricing_prices_the_tail_matches_jax():
    def run(s):
        prof = s.obs.CostProfiler(reference=s.lm)
        pred = s.lm.prefill_time(2, 128)
        for i in range(20):
            prof.observe_prefill(pred * (3.0 if i % 10 == 9 else 1.0),
                                 batch=2, tokens=128)
        qs = [s.obs.CalibratedLatencyModel(s.lm, prof, quantile=q)
              .prefill_time(2, 128) for q in (None, 0.5, 0.9, 0.95, 0.99)]
        tail = s.obs.CalibratedLatencyModel(s.lm, prof, quantile=0.95)
        tail.prefill_time(2, 128)
        return qs, pred, tail.coverage_counters()
    qs, pred, counters = both(run)
    assert qs[0] == pytest.approx(1.2 * pred)
    assert qs[3] == pytest.approx(3.0 * pred, rel=0.06)
    assert qs[1:] == sorted(qs[1:]) and counters["quantile"] == 0.95


def test_drift_attributed_to_the_offending_replica_matches_jax():
    def run(s):
        tr = s.obs.Tracer()
        prof = s.obs.CostProfiler(reference=s.lm, tracer=tr, drift_tol=0.25,
                                  drift_min_samples=4)
        tr.add_sink(prof.on_event)
        pred = s.lm.prefill_time(2, 128)
        t = 0.0
        for _ in range(10):
            for track, f in ((0, 1.0), (1, 2.0)):
                tr.span("batch_prefill", t, t + pred * f, track=track,
                        args={"batch": 2, "tokens": 128})
                t += pred * f
        return (prof.drift_by_replica(), prof.drift_events, _events(tr),
                s.obs.check_invariants(tr.events))
    by_rep, n, events, errs = both(run)
    drifts = [e for e in events if e[0] == "profile_drift"]
    assert by_rep == {1: 1} and n == 1 and errs == []
    assert len(drifts) == 1 and drifts[0][4] == 1


def test_drift_reaches_monitor_metrics_matches_jax():
    def run(s):
        mon = _monitor(s)
        prof = s.obs.CostProfiler(reference=s.lm, drift_min_samples=2,
                                  monitor=mon)
        p = s.lm.prefill_time(1, 128)
        for _ in range(4):
            prof.observe_prefill(p * 2.0, batch=1, tokens=128, replica=3)
        return mon.metrics()
    m = both(run)["profile_drift"]
    assert m == {"events": 1, "by_replica": {"3": 1},
                 "by_phase": {"prefill": 1}}


def test_decay_tracks_regime_change_matches_jax():
    def run(s):
        out = []
        for half_life in (8, None):
            prof = s.obs.CostProfiler(reference=s.lm, half_life=half_life)
            p = s.lm.prefill_time(2, 128)
            for f in [1.0] * 30 + [2.0] * 30:
                prof.observe_prefill(p * f, batch=2, tokens=128)
            out.append((prof.phase_correction("prefill"), prof.metrics(),
                        prof.to_json()))
        return out
    (decayed, m, _), (stale, _, _) = both(run)
    assert decayed[0] == pytest.approx(2.0, rel=0.08)
    assert stale[0] == pytest.approx(1.5, rel=0.02) and m["half_life"] == 8


def test_registry_per_replica_and_decay_round_trip_matches_jax(tmp_path):
    def run(s):
        prof = s.obs.CostProfiler(reference=s.lm, half_life=8)
        p = s.lm.prefill_time(2, 128)
        for _ in range(12):
            prof.observe_prefill(p, batch=2, tokens=128, replica=0)
            prof.observe_prefill(p * 2.0, batch=2, tokens=128, replica=1)
        f = tmp_path / f"{id(s)}.json"
        prof.save(f)
        back = s.obs.CostProfiler.load(f, reference=s.lm)
        assert json.dumps(back.to_json()) == json.dumps(prof.to_json())
        assert back.metrics() == prof.metrics()
        return (back.half_life, f.read_text(),
                _prices(s.obs.CalibratedLatencyModel(s.lm, back, replica=1,
                                                     quantile=0.95)),
                _prices(s.obs.CalibratedLatencyModel(s.lm, prof, replica=1,
                                                     quantile=0.95)))
    half_life, _, loaded, live = both(run)
    assert half_life == 8 and loaded == live


def test_registry_v2_loads_as_single_model_matches_jax():
    def run(s):
        src = s.obs.CostProfiler(reference=s.lm)
        p = s.lm.prefill_time(2, 128)
        for _ in range(6):
            src.observe_prefill(p * 1.5, batch=2, tokens=128, replica=1,
                                model=ARCH)
        v2 = {k: v for k, v in src.to_json().items()
              if k not in ("models", "replica_models")}
        v2["profile_version"] = 2
        back = s.obs.CostProfiler.from_json(json.loads(json.dumps(v2)),
                                            reference=s.lm)
        cal = s.obs.CalibratedLatencyModel(s.lm, back, model=ARCH)
        return (back.model_profiles, back.drift_by_model(), _prices(cal),
                cal.prefill_time(2, 128) / p,
                back.prefill_cell(2, 128, replica=1).count, back.to_json(),
                v2["fleet"])
    models, mdrift, _, ratio, count, regen, fleet = both(run)
    assert models == {} and mdrift == {} and count == 6
    assert ratio == pytest.approx(1.5)
    assert regen["profile_version"] == 3 and regen["models"] == {}
    assert regen["fleet"] == fleet


def test_per_model_scopes_and_calibration_chain_match_jax():
    def run(s):
        prof = s.obs.CostProfiler(reference=s.lm)
        p = s.lm.prefill_time(2, 128)
        for _ in range(8):
            prof.observe_prefill(p * 2.0, batch=2, tokens=128, replica=0,
                                 model="a")
            prof.observe_prefill(p, batch=2, tokens=128, replica=1, model="b")
        fresh = s.obs.CalibratedLatencyModel(s.lm, prof, replica=7, model="a")
        back = s.obs.CostProfiler.from_json(
            json.loads(json.dumps(prof.to_json())), reference=s.lm)
        assert json.dumps(back.to_json()) == json.dumps(prof.to_json())
        return ([prof.prefill_cell(2, 128, model=m).ratio_ema
                 for m in ("a", "b", None)], fresh.prefill_time(2, 128) / p,
                _prices(fresh), prof.model_coverage(), prof.metrics(),
                prof.to_json())
    ratios, fresh, _, cov, m, _ = both(run)
    assert ratios == pytest.approx([2.0, 1.0, 1.5])
    assert fresh == pytest.approx(2.0) and set(m["models"]) == {"a", "b"}
    assert cov["a"]["prefill"]["samples"] == 8


def test_v1_registry_loads_as_fleet_only_matches_jax():
    def run(s):
        src = s.obs.CostProfiler(reference=s.lm)
        p = s.lm.prefill_time(2, 128)
        for _ in range(6):
            src.observe_prefill(p * 1.5, batch=2, tokens=128)
        sub = src.to_json()["fleet"]
        v1 = {"profile_version": 1, "alpha": 0.25, "drift_tol": 0.25,
              "drift_min_samples": 8, "drift_events": 2,
              "cells": [{"key": c["key"], "count": c["count"],
                         "ema_s": c["ema_s"], "total_s": c["total_s"],
                         "hist": c["hist"], "ratio_count": c["ratio_count"],
                         "ratio_ema": c["ratio_num"] / c["ratio_den"]}
                        for c in sub["cells"]],
              "residual": sub["residual"],
              "phase_ratio": {ph: [pr[0], pr[1] / pr[2]]
                              for ph, pr in sub["phase_ratio"].items()},
              "spec": {"drafted": 0, "accepted": 0, "samples": 0,
                       "ema": 0.5, "bootstrap": 0.5}}
        back = s.obs.CostProfiler.from_json(json.loads(json.dumps(v1)),
                                            reference=s.lm)
        cals = [s.obs.CalibratedLatencyModel(s.lm, back, replica=0, **kw)
                for kw in ({}, {"quantile": 0.95})]
        with pytest.raises(ValueError, match="profile_version"):
            s.obs.CostProfiler.from_json({"profile_version": 99})
        return (back.replica_profiles, back.drift_events,
                [c.prefill_time(2, 128) / p for c in cals],
                [_prices(c) for c in cals], back.to_json())
    reps, drift, ratios, _, _ = both(run)
    assert reps == {} and drift == 2
    assert ratios == pytest.approx([1.5, 1.5])


# ------------------------------------------------------- the serve CLI

def test_parsers_differ_only_by_device():
    """The port's serve parser has the reference's flags, each with the
    reference's default, and ``--device`` besides."""
    class Parsed(Exception):
        pass

    def grab(ap, args=None):
        raise Parsed(ap)
    mp = pytest.MonkeyPatch()
    mp.setattr(jax_serve.argparse.ArgumentParser, "parse_args", grab)
    with pytest.raises(Parsed) as caught:
        jax_serve.main()
    mp.undo()
    ref = {a.dest: (a.option_strings, a.default)
           for a in caught.value.args[0]._actions}
    mine = {a.dest: (a.option_strings, a.default)
            for a in serve.build_parser()._actions}
    assert mine.pop("device") == (["--device"], "cuda")
    # --reduced is a BooleanOptionalAction in the port (--no-reduced too)
    assert mine.pop("reduced") == (["--reduced", "--no-reduced"], True)
    assert ref.pop("reduced") == (["--reduced"], True)
    assert mine == ref


def _run(main, argv) -> str:
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        main(argv)
    return buf.getvalue()


def _jax_main(argv):
    old = sys.argv
    sys.argv = ["serve", *argv]
    try:
        jax_serve.main()
    finally:
        sys.argv = old


class _Fitted:
    """Stands in for the JAX CLI's ``LengthPredictor``: a copy of one
    already fitted as the CLI fits it, so both CLIs start from the same
    weights (``tests/test_torch_serve.py``'s)."""

    def __init__(self, fitted):
        self.fitted = fitted

    def __call__(self, *a, **kw):
        pred = copy.deepcopy(self.fitted)
        pred.fit = lambda *a, **kw: None
        return pred


def _fit(vocab):
    """The CLI's predictor: seed 0, 8 epochs on 256 pairs at ``vocab``."""
    pred = jax_profiler.LengthPredictor(
        jax_profiler.PredictorConfig(vocab=vocab), seed=0)
    toks, lens = jax_workload.train_pairs(
        jax_workload.WorkloadConfig(vocab=vocab), 256, seed=1)
    pred.fit(toks, lens, epochs=8)
    return pred


def _lines(printed, heads):
    return [ln for ln in printed.splitlines() if ln.startswith(heads)]


def _paths(tmp, side):
    return {"trace": str(tmp / f"{side}_trace.json"),
            "metrics": str(tmp / f"{side}_metrics.json"),
            "profile": str(tmp / f"{side}_profile.json")}


def _artifact_flags(p):
    return ["--trace", p["trace"], "--metrics-json", p["metrics"],
            "--profile-out", p["profile"]]


def _cli_pair(mp, tmp, argv, jpred, port_pred, flags=_artifact_flags,
              params=None):
    """Runs the JAX CLI and the port's on ``argv`` plus ``flags`` of each
    side's paths, with the same predictor (and weights); returns each
    side's printed lines with its paths blanked, the paths, and the port's
    result."""
    mp.setattr(jax_serve, "LengthPredictor", _Fitted(jpred))
    mp.setattr(serve, "fit_predictor", lambda c, d: port_pred())
    if params is not None:
        mp.setattr(serve.api, "init_params", lambda *a, **k: params)
    out = {}
    res = {}
    for side, main in (("jax", _jax_main),
                       ("port", lambda a: res.update(
                           serve.main([*a, "--device", "cpu"])))):
        p = _paths(tmp, side)
        printed = _run(main, argv + flags(p))
        for path in p.values():
            printed = printed.replace(path, "PATH")
        out[side] = (printed, p)
    return out, res


@pytest.fixture(scope="module")
def sim_runs(tmp_path_factory):
    """``serve --arch chatglm2-6b --replicas 4 --router slo_aware`` on the
    simulated cluster with ``--trace --metrics-json --profile-out``, then
    with ``--profile-in`` the JAX CLI's registry and ``--pricing-quantile
    0.95``, in both CLIs."""
    jpred = _fit(jax_profiler.PredictorConfig().vocab)

    def port_pred():
        return predictor_from_numpy(jax.tree.map(np.array, jpred.params),
                                    profiler.PredictorConfig(), device="cpu")
    tmp = tmp_path_factory.mktemp("sim")
    argv = ["--arch", ARCH, "--replicas", "4", "--router", "slo_aware"]
    with pytest.MonkeyPatch.context() as mp:
        first, res = _cli_pair(mp, tmp, argv, jpred, port_pred)
        reg = first["jax"][1]["profile"]
        again, res_in = _cli_pair(
            mp, tmp, argv, jpred, port_pred,
            flags=lambda p: ["--profile-in", reg, "--pricing-quantile",
                             "0.95"])
    return first, again, res, res_in


def test_cluster_sim_cli_artifacts_equal_jax(sim_runs):
    """On the simulated cluster the trace, the metrics and the saved
    profile are equal to the JAX CLI's after ``json.load``, and so are the
    printed lines; the trace and metrics validate."""
    first, _, res, _ = sim_runs
    (jprinted, jp), (printed, p) = first["jax"], first["port"]
    assert _lines(printed, ("serving",)) != []
    assert printed.splitlines()[1:] == jprinted.splitlines()[1:]
    for key in ("trace", "metrics", "profile"):
        with open(p[key]) as f, open(jp[key]) as g:
            mine, ref = json.load(f), json.load(g)
        assert mine == ref, key
    with open(p["trace"]) as f:
        trace = json.load(f)
    assert obs.validate_trace(trace) == []
    assert {"queued", "batch_prefill", "batch_decode", "route",
            "finish"} <= obs.event_names(trace)
    with open(p["metrics"]) as f:
        assert obs.validate_metrics(json.load(f)) == []
    assert obs.check_invariants(res["tracer"].events) == []
    assert res["cost_profiler"].coverage()["decode"]["samples"] > 0


def test_cluster_sim_cli_profile_in_lines_equal_jax(sim_runs):
    """``--profile-in`` the registry with ``--pricing-quantile 0.95``: the
    same ``cluster:``, replica, ``monitor:``, ``calibration:`` and
    ``drift:`` lines as the JAX CLI; each replica priced through a mean
    and a tail model."""
    _, again, _, res = sim_runs
    heads = ("cluster:", "  replica", "monitor:", "calibration:", "drift:")
    want = _lines(again["jax"][0], heads)
    assert _lines(again["port"][0], heads) == want
    assert [ln.split(":")[0] for ln in want if not ln.startswith(" ")] == \
        ["cluster", "monitor", "calibration", "drift"]
    qs = [m.quantile for m in res["cal_models"]]
    assert qs.count(None) == qs.count(0.95) > 0
    with pytest.raises(SystemExit):
        serve.main(["--pricing-quantile", "0", "--device", "cpu"])


@pytest.fixture(scope="module")
def smollm():
    """The reduced smollm's JAX predictor (its vocab), its port copy, and
    the port's model carrying the JAX CLI's weights (key 0)."""
    jcfg = jax_get_config("smollm-135m").reduced()
    jpred = _fit(jcfg.vocab_size)
    jparams = jax_api.init_params(jcfg, jax.random.PRNGKey(0), jnp.float32)
    model = api.init_params(get_config("smollm-135m").reduced(), seed=0,
                            device="cpu")
    model.load_state_dict(from_jax_params(jax.tree.map(np.asarray, jparams)))

    def port_pred():
        return predictor_from_numpy(
            jax.tree.map(np.array, jpred.params),
            profiler.PredictorConfig(vocab=jcfg.vocab_size), device="cpu")
    return jpred, port_pred, model


def _summaries_counts(x):
    """``x`` with every latency summary block cut to its count and the
    seconds (the keys ending in ``_s``) and throughput dropped: the values
    of a live run's metrics that are not wall-clock times."""
    if isinstance(x, dict):
        if x and set(x) <= {"count", "mean", "p50", "p95", "p99", "max"}:
            return {"count": x["count"]}
        return {k: _summaries_counts(v) for k, v in x.items()
                if not k.endswith("_s") and k != "throughput"}
    return x


def _cells(reg):
    """A registry's scopes with each cell's key and sample count."""
    scopes = {"fleet": reg["fleet"]} | {
        f"replica {r}": s for r, s in reg["replicas"].items()} | {
        f"model {m}": s for m, s in reg["models"].items()}
    return {k: [(c["key"], c["count"], c["ratio_count"]) for c in s["cells"]]
            for k, s in scopes.items()}


def _no_times(trace):
    return [{k: v for k, v in ev.items() if k not in ("ts", "dur")}
            for ev in trace["traceEvents"]]


def _live_artifacts_match(out: dict, res: dict):
    """Both CLIs' live run with ``--trace --metrics-json --profile-out``:
    the same replica, router, speculation, acceptance and digest lines;
    the same trace events but for their times (names, phases, tracks,
    rows, order, args); the same metrics keys and every value that is not
    a time; the same profile cells and sample counts.  Returns the JAX
    CLI's lines and the port's trace and registry."""
    heads = ("replica", "router:", "outputs_digest=", "measured acceptance",
             "speculate:", "paged:", "drift:", "profile:", "trace:")
    want = _lines(out["jax"][0], heads)
    assert _lines(out["port"][0], heads) == want
    assert any(ln.startswith("outputs_digest=") for ln in want)
    loaded = {}
    for side in SIDES:
        p = out[side][1]
        with open(p["trace"]) as f, open(p["metrics"]) as g, \
                open(p["profile"]) as h:
            loaded[side] = (json.load(f), json.load(g), json.load(h))
    (tr, m, reg), (jtr, jm, jreg) = loaded["port"], loaded["jax"]
    assert _no_times(tr) == _no_times(jtr)
    assert obs.validate_trace(tr) == [] and obs.validate_metrics(m) == []
    assert _summaries_counts(m) == _summaries_counts(jm)
    assert _cells(reg) == _cells(jreg)
    assert reg["spec"] == jreg["spec"]
    assert obs.check_invariants(res["tracer"].events) == []
    return want, tr, reg


LIVE_ARGVS = {
    "cluster_speculate": ["--replicas", "2", "--paged", "--speculate"],
    "padded": [],
}


@pytest.mark.parametrize("case", sorted(LIVE_ARGVS))
def test_live_cli_artifacts_match_jax_times_aside(smollm, tmp_path, case):
    """Live engines on the reduced smollm with the JAX CLI's weights, both
    CLIs with ``--trace --metrics-json --profile-out``, times aside
    (``_live_artifacts_match``).  Two live replicas with speculation plan
    at the measured acceptance; the padded path traces nothing."""
    jpred, port_pred, model = smollm
    with pytest.MonkeyPatch.context() as mp:
        out, res = _cli_pair(mp, tmp_path, LIVE_ARGVS[case], jpred, port_pred,
                             params=model)
    want, tr, reg = _live_artifacts_match(out, res)
    if case == "padded":
        assert tr["traceEvents"] == [] and reg["fleet"]["cells"] == []
        return
    assert {"prefill_chunk", "finish"} <= obs.event_names(tr)
    assert reg["spec"]["samples"] > 0
    assert [ln.startswith("replica") for ln in want].count(True) == 2
    assert set(reg["replicas"]) == {"0", "1"}
    # replica 0 planned at the bootstrap, replica 1 at what replica 0's
    # share measured
    first, second = (r.spec_acceptance for r in res["replicas"])
    assert first == 0.5 and second != first


def test_profile_round_trip_matches_jax(smollm, tmp_path):
    """``ci.sh``'s traced and profile smokes: ``--paged --speculate
    --chunk-tokens 8 --requests 8`` with ``--trace --metrics-json
    --profile-out`` in both CLIs (times aside, ``_live_artifacts_match``),
    then the port's with ``--profile-in`` that registry: the three digests
    are equal, the registry loads byte-stable, and the second run starts
    from the first run's acceptance."""
    jpred, port_pred, model = smollm
    argv = ["--paged", "--speculate", "--chunk-tokens", "8", "--requests",
            "8"]
    with pytest.MonkeyPatch.context() as mp:
        a, res_a = _cli_pair(mp, tmp_path, argv, jpred, port_pred,
                             params=model)
        res_b = {}
        b = _run(lambda args: res_b.update(serve.main(args)),
                 argv + ["--profile-in", a["port"][1]["profile"],
                         "--device", "cpu"])
    _, tr, reg = _live_artifacts_match(a, res_a)
    assert {"queued", "admitted", "prefill_chunk", "finish"} <= \
        obs.event_names(tr)
    assert reg["spec"]["samples"] > 0
    digests = [re.search(r"outputs_digest=(\w+)", printed).group(1)
               for printed in (a["jax"][0], a["port"][0], b)]
    assert len(set(digests)) == 1
    assert _lines(b, ("drift:", "measured acceptance")) != []
    loaded = obs.CostProfiler.load(a["port"][1]["profile"])
    assert json.dumps(obs.CostProfiler.from_json(loaded.to_json()).to_json()) \
        == json.dumps(loaded.to_json())
    assert any(c["samples"] > 0 for c in loaded.coverage().values())
    assert res_b["cost_profiler"].spec_samples == \
        2 * res_a["cost_profiler"].spec_samples
