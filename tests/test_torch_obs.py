"""The port's observability layer against the JAX package's
(``tests/test_obs.py``'s cases, each run through both packages on the same
seeded inputs or the same event list): histogram quantiles, merges and
rotation; the span vocabularies; ``check_invariants``; Chrome-trace export
and the metrics schema with both validators on the same malformed objects;
the monitor's latency quantiles and replica gauges; and tracing identity
on the iteration-level simulator and on the reduced smollm's paged engine
with converted weights (the same outputs with and without a tracer, and
the same events as the JAX engine, times aside)."""
import copy
import json
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from repro import obs as jax_obs
from repro.configs import get_config as jax_get_config
from repro.core import monitor as jax_monitor
from repro.core import profiler as jax_profiler
from repro.core import types as jax_types
from repro.models import api as jax_api
from repro.obs import trace as jax_trace
from repro.serving import PagedEngine as JaxPagedEngine
from repro.serving import PagedEngineConfig as JaxPagedEngineConfig
from repro.serving import simulate_continuous as jax_simulate_continuous
from repro_torch import obs
from repro_torch.configs import get_config
from repro_torch.core import monitor, profiler, types
from repro_torch.models import api
from repro_torch.obs import trace
from repro_torch.params import from_jax_params, predictor_from_numpy
from repro_torch.serving import PagedEngine, PagedEngineConfig
from repro_torch.serving import simulate_continuous

BS = 8
SIDES = {"jax": jax_obs, "port": obs}


def _hist_state(h):
    return (dict(h.counts), h.n, h.total, h.min_v, h.max_v)


def _samples(dist, seed, n=4000):
    rng = np.random.default_rng(seed)
    return {"lognormal": rng.lognormal(-3.0, 1.5, n),
            "exponential": rng.exponential(0.05, n),
            "uniform": rng.uniform(1e-4, 2.0, n)}[dist]


QS = (0.0, 0.01, 0.1, 0.25, 0.5, 0.5, 0.75, 0.9, 0.95, 0.99, 1.0)


# ------------------------------------------------------------ histograms

@pytest.mark.parametrize("dist,seed", [("lognormal", 0), ("exponential", 1),
                                       ("uniform", 2)])
def test_histogram_quantiles_match_jax(dist, seed):
    """The same samples give the same buckets, quantiles, mean and summary
    in both packages, and every quantile is within sqrt(growth)-1 of the
    true order statistic; quantiles are monotone in q."""
    xs = _samples(dist, seed)
    got = {}
    for side, mod in SIDES.items():
        h = mod.Histogram()
        h.record_many(xs)
        got[side] = (_hist_state(h), [h.quantile(q) for q in QS], h.mean,
                     h.summary(), h.rel_error_bound)
    assert got["port"] == got["jax"]
    h = obs.Histogram()
    h.record_many(xs)
    srt = np.sort(xs)
    for q in (0.01, 0.25, 0.5, 0.9, 0.95, 0.99):
        true = srt[int(q * (h.n - 1))]
        assert abs(h.quantile(q) - true) <= h.rel_error_bound * true + 1e-12
    assert h.quantile(0.0) == srt[0] and h.quantile(1.0) == srt[-1]
    vals = got["port"][1]
    assert vals == sorted(vals)


def test_histogram_merge_record_idx_and_edges_match_jax():
    """Merges (of the union, with an empty one either way), ``record_idx``
    with the bucket ``_bucket`` gives, zero and negative samples, and the
    empty histogram: the same state and reports in both packages; a merge
    across bucketings raises in both."""
    rng = np.random.default_rng(3)
    a, b = rng.exponential(0.1, 500), rng.exponential(1.0, 700)
    got = {}
    for side, mod in SIDES.items():
        ha, hb, hu = mod.Histogram(), mod.Histogram(), mod.Histogram()
        ha.record_many(a)
        hb.record_many(b)
        hu.record_many(np.concatenate([a, b]))
        ha.merge(hb)
        assert ha.counts == hu.counts
        with pytest.raises(ValueError):
            ha.merge(mod.Histogram(growth=2.0))
        idx = mod.Histogram()
        for v in b:
            idx.record_idx(idx._bucket(v), v)
        edge = mod.Histogram()
        edge.record_many([0.0, -3.5, 1e-9, 1e-8])
        empty = mod.Histogram()
        into_empty = mod.Histogram()
        into_empty.merge(hb)
        hb.merge(mod.Histogram())
        got[side] = (_hist_state(ha), ha.summary(), _hist_state(idx),
                     _hist_state(edge), edge.quantile(0.5), edge.summary(),
                     empty.summary(), _hist_state(into_empty),
                     _hist_state(hb), [hu.quantile(q) for q in QS])
        assert math.isnan(empty.quantile(0.5)) and math.isnan(empty.mean)
        assert idx.counts == hb.counts
    assert got["port"] == got["jax"]


def test_rotating_histogram_matches_jax():
    """Two-window rotation: after 300 samples at window 64 both packages
    keep the same previous and active windows (the last 64 + 44 samples),
    the same merged view and quantiles; a burst is forgotten after 2W
    samples; window 1 and ``record_idx`` agree; window 0 raises."""
    W = 64
    rng = np.random.default_rng(11)
    xs = rng.lognormal(-3.0, 1.2, 300)
    got = {}
    for side, mod in SIDES.items():
        rh = mod.RotatingHistogram(window=W)
        for v in xs:
            rh.record(v)
        spike = mod.RotatingHistogram(window=W)
        for v in [100.0] * W + [0.01] * (2 * W):
            spike.record_idx(spike.active._bucket(v), v)
        tiny = mod.RotatingHistogram(window=1)
        tiny.record(5.0)
        tiny.record(7.0)
        with pytest.raises(ValueError):
            mod.RotatingHistogram(window=0)
        got[side] = (_hist_state(rh.previous), _hist_state(rh.active),
                     _hist_state(rh.merged()), rh.n, rh.total, rh.mean,
                     rh.min_v, rh.max_v, [rh.quantile(q) for q in QS],
                     rh.summary(), rh.rel_error_bound, spike.max_v,
                     spike.quantile(1.0), tiny.n, tiny.quantile(1.0))
    assert got["port"] == got["jax"]
    assert got["port"][3] == W + 300 % W
    fresh = obs.Histogram()
    fresh.record_many(xs[4 * W - W:])           # the retained suffix
    assert got["port"][2][0] == fresh.counts
    assert got["port"][11] == pytest.approx(0.01)


# ------------------------------------------------------- span vocabulary

def test_vocabularies_and_rows_match_jax():
    assert obs.SPAN_NAMES == jax_obs.SPAN_NAMES
    assert obs.INSTANT_NAMES == jax_obs.INSTANT_NAMES
    assert obs.EVENT_NAMES == jax_obs.EVENT_NAMES
    assert obs.SPAN_NAMES & obs.INSTANT_NAMES == set()
    assert obs.EVENT_NAMES == obs.SPAN_NAMES | obs.INSTANT_NAMES
    assert trace.ROW_NAMES == jax_trace.ROW_NAMES
    assert [trace.row_name(r) for r in range(6)] == \
        [jax_trace.row_name(r) for r in range(6)] == \
        ["engine", "queue", "slot 0", "slot 1", "slot 2", "slot 3"]
    assert [obs.slot_row(s) for s in range(4)] == \
        [jax_obs.slot_row(s) for s in range(4)]
    assert (obs.ROW_ENGINE, obs.ROW_QUEUE) == \
        (jax_obs.ROW_ENGINE, jax_obs.ROW_QUEUE)


# The event lists of tests/test_obs.py, and more: a well-formed lifecycle
# (overlapping queued waits exempt from nesting), an unknown name, a
# partial overlap on one lane, the same pair on two lanes, instants and
# spans outside their vocabularies, and a span nested in another
LANES = {
    "clean": [("span", "queued", 0.0, 1.0, 0, 1),
              ("span", "queued", 0.5, 2.0, 0, 1),
              ("instant", "admitted", 1.0, None, 0, 2),
              ("span", "prefill_chunk", 1.0, 1.5, 0, 2),
              ("span", "decode", 1.5, 1.6, 0, 2),
              ("instant", "finish", 1.6, None, 0, 2)],
    "unknown": [("span", "warp_drive", 0.0, 1.0, 0, 0)],
    "overlap": [("span", "decode", 0.0, 1.0, 0, 2),
                ("span", "verify", 0.5, 1.5, 0, 2)],
    "two_lanes": [("span", "decode", 0.0, 1.0, 0, 2),
                  ("span", "verify", 0.5, 1.5, 0, 3)],
    "wrong_kind": [("span", "finish", 0.0, 1.0, 1, 2),
                   ("instant", "decode", 0.5, None, 1, 2)],
    "nested": [("span", "batch_decode", 0.0, 2.0, 3, 0),
               ("span", "batch_prefill", 0.5, 1.0, 3, 0),
               ("span", "batch_prefill", 1.5, 2.5, 3, 0)],
}


def _emit(mod, events, **kw):
    tr = mod.Tracer(**kw)
    for kind, name, t0, t1, track, row in events:
        if kind == "span":
            tr.span(name, t0, t1, track=track, row=row,
                    args={"rid": int(10 * t0)})
        else:
            tr.instant(name, t0, track=track, row=row)
    return tr


@pytest.mark.parametrize("case", sorted(LANES))
def test_check_invariants_matches_jax(case):
    got = {side: obs_mod.check_invariants(_emit(obs_mod, LANES[case]).events)
           for side, obs_mod in SIDES.items()}
    assert got["port"] == got["jax"]
    assert (got["port"] == []) == (case in ("clean", "two_lanes"))
    # a negative duration, which no tracer emits
    ev = [obs.TraceEvent("decode", "X", 1.0, -0.5)]
    jev = [jax_obs.TraceEvent("decode", "X", 1.0, -0.5)]
    assert obs.check_invariants(ev) == jax_obs.check_invariants(jev) != []


def test_tracer_sinks_retain_and_null_match_jax():
    """Sinks see every event in both packages; ``retain=False`` stores
    nothing; ``clear`` empties; the disabled tracer records nothing and is
    false."""
    got = {}
    for side, mod in SIDES.items():
        seen = []
        tr = _emit(mod, [], retain=False)
        tr.add_sink(lambda ev: seen.append((ev.name, ev.ph, ev.t0, ev.dur,
                                            ev.track, ev.row, ev.args)))
        for e in LANES["clean"]:
            _emit(mod, [e])                     # a second tracer: unseen
        kept = _emit(mod, LANES["clean"])
        for ev in kept.events:
            (tr.span(ev.name, ev.t0, ev.t0 + ev.dur, track=ev.track,
                     row=ev.row, args=ev.args) if ev.ph == "X" else
             tr.instant(ev.name, ev.t0, track=ev.track, row=ev.row))
        n_kept = len(kept.events)
        kept.clear()
        mod.NULL_TRACER.span("decode", 0.0, 1.0)
        mod.NULL_TRACER.instant("finish", 1.0)
        got[side] = (seen, tr.events, n_kept, kept.events, bool(tr),
                     bool(mod.NULL_TRACER), mod.NULL_TRACER.events)
    assert got["port"] == got["jax"]
    assert len(got["port"][0]) == 6 and got["port"][1] == []
    assert got["port"][4] and not got["port"][5]


# ----------------------------------------------------------- trace export

def test_chrome_export_matches_jax(tmp_path):
    """The same events export to the same Chrome-trace object and file:
    microsecond stamps, an async b/e pair per queued interval, track and
    row metadata, track names."""
    events = LANES["clean"] + LANES["nested"] + [
        ("span", "queued", 0.25, 1.0, 2, 1),
        ("instant", "route", 0.25, None, 2, 0)]
    got, files = {}, {}
    for side, mod in SIDES.items():
        tr = _emit(mod, events)
        got[side] = mod.to_chrome(tr, track_names={2: "replica two"})
        path = tmp_path / f"{side}.json"
        assert mod.export_trace(tr.events, path,
                                track_names={2: "replica two"}) == got[side]
        files[side] = path.read_text()
        assert mod.event_names(got[side]) == {e[1] for e in events}
    assert got["port"] == got["jax"] and files["port"] == files["jax"]
    assert obs.validate_trace(got["port"]) == []
    named = [e for e in got["port"]["traceEvents"] if e["ph"] != "M"]
    assert {e["ph"] for e in named} == {"X", "i", "b", "e"}
    x = next(e for e in named if e["ph"] == "X")
    assert x["ts"] == pytest.approx(1.0e6) and x["dur"] == pytest.approx(5e5)


BAD_TRACES = [
    {}, {"traceEvents": 3}, {"traceEvents": ["x"]},
    {"traceEvents": [{"name": "decode", "ph": "X", "ts": -1, "dur": -2,
                      "pid": 0, "tid": 0}]},
    {"traceEvents": [{"name": "nope", "ph": "X", "ts": 0, "dur": 0,
                      "pid": 0, "tid": 0}]},
    {"traceEvents": [{"name": "decode", "ph": "Q", "ts": 0}]},
    {"traceEvents": [{"ph": "M", "name": "anything"},
                     {"name": "finish", "ph": "i", "ts": 1.0, "pid": 0,
                      "tid": 2, "s": "t"}]},
]


@pytest.mark.parametrize("i", range(len(BAD_TRACES)))
def test_validate_trace_matches_jax(i):
    obj = copy.deepcopy(BAD_TRACES[i])
    got = obs.validate_trace(obj)
    assert got == jax_obs.validate_trace(obj)
    assert (got == []) == (i == len(BAD_TRACES) - 1)


def test_metrics_payload_and_validator_match_jax(tmp_path):
    """The same payload in both packages (schema 6), written to the same
    file; the validator gives the same verdicts on the same malformed
    payloads, old schemas 3-5 accepted."""
    kw = dict(latency_s=1.0, p99_latency_s=2.0, monitor={"observed": 1},
              profile={"cells": 0}, extra={"k": 3})
    p, jp = obs.metrics_payload("x", **kw), jax_obs.metrics_payload("x", **kw)
    assert p == jp and p["schema"] == 6 and obs.validate_metrics(p) == []
    obs.write_metrics(tmp_path / "a.json", p)
    jax_obs.write_metrics(tmp_path / "b.json", jp)
    assert (tmp_path / "a.json").read_text() == \
        (tmp_path / "b.json").read_text()
    bad = [3, {"bench": "x", "schema": 1}, {"bench": 3, "schema": 6},
           dict(p, throughput="fast"), dict(p, profile=3),
           {k: v for k, v in p.items() if k != "latency_s"}]
    for old in (3, 4, 5):
        bad.append(dict(p, schema=old))
    for obj in bad:
        got = obs.validate_metrics(obj)
        assert got == jax_obs.validate_metrics(obj)
    assert [obs.validate_metrics(b) == [] for b in bad] == \
        [False] * 6 + [True] * 3


# -------------------------------------------------------- monitor quantiles

def _monitors():
    """A JAX monitor and the port's, each over the reduced smollm's
    predictor at seed 0 (the port's with the JAX weights)."""
    jcfg = jax_get_config("smollm-135m").reduced()
    jpred = jax_profiler.LengthPredictor(
        jax_profiler.PredictorConfig(vocab=jcfg.vocab_size), seed=0)
    tpred = predictor_from_numpy(
        jax.tree.map(np.array, jpred.params),
        profiler.PredictorConfig(vocab=jcfg.vocab_size), device="cpu")
    cfg = get_config("smollm-135m").reduced()
    return {"jax": (jax_monitor.Monitor(jax_profiler.ResourceProfiler(
                jpred, jcfg)), jax_types, jax_obs),
            "port": (monitor.Monitor(profiler.ResourceProfiler(tpred, cfg)),
                     types, obs)}


def test_monitor_latency_quantiles_match_jax():
    """Finished requests with serving-path breakdowns and interleave
    samples give the same p50/p95/p99 blocks in both monitors."""
    got = {}
    for side, (mon, ty, mod) in _monitors().items():
        for i in range(8):
            r = ty.Request(rid=i, tokens=[1 + i] * 6, input_len=6, slo=30.0,
                           arrival=0.0, true_output_len=3)
            r.start_time = 0.1 * i
            r.finish_time = 0.1 * i + 1.0 + 0.05 * i
            r.first_token_time = 0.1 * i + 0.4
            r.breakdown = mod.LatencyBreakdown(
                queue_wait_s=0.1 * i, ttft_s=0.4,
                e2e_s=r.finish_time - r.arrival)
            mon.observe(r)
        mon.observe_interleave(chunks=4, stalls=[0.01, 0.02],
                               itl=[0.001, 0.002, 0.004])
        got[side] = mon.metrics()
    assert got["port"] == got["jax"]
    for key in ("queue_wait", "ttft", "itl", "e2e", "prefill_stall"):
        assert set(got["port"][key]) == {"count", "mean", "p50", "p95", "p99",
                                         "max"}, key
    assert got["port"]["ttft"]["count"] == 8


def test_monitor_replica_gauges_and_drift_match_jax():
    """Peak and running-mean replica gauges across snapshots, and the drift
    counters ``observe_drift`` feeds, equal in both monitors."""
    got = {}
    for side, (mon, _, _) in _monitors().items():
        mon.observe_replicas([4, 6], [0.9, 0.7])
        mon.observe_replicas([0, 0], [0.0, 0.0])     # drained final snapshot
        for rid, phase in ((3, "prefill"), (1, "decode"), (3, "prefill")):
            mon.observe_drift(rid, phase)
        got[side] = mon.metrics()
    assert got["port"] == got["jax"]
    m = got["port"]
    assert m["cluster_queue_peak"] == 6 and m["cluster_queue_depths"] == [0, 0]
    assert m["cluster_util_mean"] == pytest.approx(0.4)
    assert m["profile_drift"] == {"events": 3, "by_replica": {"1": 1, "3": 2},
                                  "by_phase": {"decode": 1, "prefill": 2}}


# ----------------------------------------------------- tracing is free

def _ev(e):
    return (e.name, e.ph, e.track, e.row, e.args)


def test_simulator_tracing_identity_matches_jax():
    """simulate_continuous with a tracer: the same outputs as the untraced
    run, events within the invariants, and the same events, times
    included (the simulator's clock), as the JAX simulator's."""
    got = {}
    for side, (sim, ty, mod, cfg) in {
            "jax": (jax_simulate_continuous, jax_types, jax_obs,
                    jax_get_config("chatglm2-6b")),
            "port": (simulate_continuous, types, obs,
                     get_config("chatglm2-6b"))}.items():
        def mk():
            rng = np.random.default_rng(7)
            reqs = []
            for i in range(12):
                toks = [1] * int(rng.integers(32, 256))
                reqs.append(ty.Request(
                    rid=i, tokens=toks, input_len=len(toks), slo=30.0,
                    arrival=0.05 * i, true_output_len=int(rng.integers(4, 24))))
                reqs[-1].predicted_output_len = reqs[-1].true_output_len
            return reqs
        tr = mod.Tracer()
        kw = dict(max_batch=4, max_new=24, block_size=16, n_blocks=64,
                  chunk_tokens=64, preempt=True)
        traced = sim(mk(), cfg, tracer=tr, **kw)
        plain = sim(mk(), cfg, **kw)
        stamps = [(r.rid, r.finish_time) for r in traced.requests]
        assert stamps == [(r.rid, r.finish_time) for r in plain.requests]
        assert traced.makespan == plain.makespan
        assert mod.check_invariants(tr.events) == []
        assert mod.validate_trace(mod.to_chrome(tr)) == []
        got[side] = (stamps, [(e.t0, e.dur) + _ev(e) for e in tr.events],
                     json.dumps(mod.to_chrome(tr)))
    assert got["port"] == got["jax"]
    names = {e[2] for e in got["port"][1]}
    assert {"prefill_chunk", "finish"} <= names


@pytest.fixture(scope="module")
def smollm():
    """The reduced smollm-135m: JAX parameters at key 0 and the port's
    model carrying the same weights."""
    jcfg = jax_get_config("smollm-135m").reduced()
    jparams = jax_api.init_params(jcfg, jax.random.PRNGKey(0), jnp.float32)
    cfg = get_config("smollm-135m").reduced()
    model = api.init_params(cfg, seed=0, device="cpu")
    model.load_state_dict(from_jax_params(jax.tree.map(np.asarray, jparams)))
    return (cfg, model), (jcfg, jparams)


def test_engine_tracing_identity_matches_jax(smollm):
    """The paged engine (chunked prefill) with a tracer: the same tokens
    as without one, a lifecycle trace within the invariants, every
    finished request with its breakdown, and the same events as the JAX
    engine's on the same requests, times aside."""
    (cfg, model), (jcfg, jparams) = smollm
    kw = dict(max_batch=2, block_size=BS, n_blocks=32, max_seq_len=48,
              max_new_tokens=8, chunk_tokens=BS)
    got = {}
    for side, (eng, pcfg_cls, c, p, ty, mod) in {
            "jax": (JaxPagedEngine, JaxPagedEngineConfig, jcfg, jparams,
                    jax_types, jax_obs),
            "port": (PagedEngine, PagedEngineConfig, cfg, model, types,
                     obs)}.items():
        def mk():
            return [ty.Request(rid=i, tokens=[2 + i] * 10, input_len=10,
                               slo=30.0, arrival=0.0,
                               true_output_len=4 + i % 3) for i in range(4)]
        tr = mod.Tracer()
        served = mk()
        traced = eng(c, p, pcfg_cls(**kw), tracer=tr).run_continuous(served)
        plain = eng(c, p, pcfg_cls(**kw)).run_continuous(mk())
        assert traced.outputs == plain.outputs
        assert mod.check_invariants(tr.events) == []
        for r in served:
            bd = r.breakdown
            assert bd.e2e_s >= bd.ttft_s >= 0 and bd.prefill_s > 0
        got[side] = (traced.outputs, [_ev(e) for e in tr.events])
    assert got["port"] == got["jax"]
    assert {"queued", "admitted", "prefill_chunk", "decode", "finish"} <= \
        {e[0] for e in got["port"][1]}
