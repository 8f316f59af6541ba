"""The port's serve path against the JAX package: workload streams,
length predictor (predictions, one Adam step, one online update),
schedulers, the padded and continuous engines and the whole default serve
path, on converted weights at the reduced smollm-135m size on the CPU; plus
the port's structural rules (no JAX, card by default)."""
import copy
import dataclasses
import re
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.configs import list_archs as jax_list_archs
from repro.core import profiler as jax_profiler
from repro.core import scheduler as jax_scheduler
from repro.data import workload as jax_workload
from repro.launch import serve as jax_serve
from repro.models import api as jax_api
from repro.models import transformer as jax_transformer
from repro.obs.hist import Histogram as JaxHistogram
from repro.serving import EngineConfig as JaxEngineConfig
from repro.serving import InferenceEngine as JaxInferenceEngine
from repro_torch.configs import H100, _PORTED, get_config, group_period
from repro_torch.core import profiler, scheduler
from repro_torch.core.types import Batch
from repro_torch.data import workload
from repro_torch.device import resolve_device
from repro_torch.launch import serve
from repro_torch.models import api
from repro_torch.obs.hist import Histogram
from repro_torch.params import from_jax_params, predictor_from_numpy
from repro_torch.serving import EngineConfig, InferenceEngine

ROOT = Path(__file__).resolve().parents[1]
VOCAB = 512                      # the reduced config's vocab


@pytest.fixture(scope="module")
def cfgs():
    return get_config("smollm-135m").reduced(), \
        jax_get_config("smollm-135m").reduced()


@pytest.fixture(scope="module")
def weights(cfgs):
    """(JAX params, port model carrying the same weights)."""
    cfg, jcfg = cfgs
    jparams = jax_api.init_params(jcfg, jax.random.PRNGKey(0), jnp.float32)
    model = api.init_params(cfg, seed=0, device="cpu")
    model.load_state_dict(from_jax_params(jax.tree.map(np.asarray, jparams)))
    return jparams, model


@pytest.fixture(scope="module")
def jax_pred():
    """The serve path's JAX predictor: seed 0, 8 epochs on 256 pairs."""
    pred = jax_profiler.LengthPredictor(
        jax_profiler.PredictorConfig(vocab=VOCAB), seed=0)
    toks, lens = jax_workload.train_pairs(
        jax_workload.WorkloadConfig(vocab=VOCAB), 256, seed=1)
    pred.fit(toks, lens, epochs=8)
    return pred


def _convert(jpred):
    return predictor_from_numpy(jax.tree.map(np.array, jpred.params),
                                profiler.PredictorConfig(vocab=VOCAB),
                                device="cpu")


def _params_close(tpred, jparams, atol):
    for name, p in tpred.net.named_parameters():
        np.testing.assert_allclose(p.detach().numpy(),
                                   np.asarray(jparams[name]), atol=atol,
                                   err_msg=name)


def _reqs(n, seed, vocab=VOCAB, prompt=10, out_max=8, mod=workload):
    reqs = mod.gen_requests(mod.WorkloadConfig(n_requests=n, seed=seed,
                                               vocab=vocab))
    for r in reqs:
        r.tokens = [t % vocab for t in r.tokens[:prompt]]
        r.input_len = len(r.tokens)
        r.true_output_len = min(r.true_output_len % out_max + 1, out_max)
    return reqs


@pytest.mark.parametrize("pattern", ["poisson", "bursty", "diurnal"])
def test_workload_streams_match_jax(pattern):
    mine = workload.gen_requests(workload.WorkloadConfig(
        n_requests=40, seed=3, arrival_pattern=pattern))
    ref = jax_workload.gen_requests(jax_workload.WorkloadConfig(
        n_requests=40, seed=3, arrival_pattern=pattern))
    for a, b in zip(mine, ref, strict=True):
        assert (a.rid, a.tokens, a.input_len, a.slo, a.arrival,
                a.true_output_len) == (b.rid, b.tokens, b.input_len, b.slo,
                                       b.arrival, b.true_output_len)
    t1, l1 = workload.train_pairs(workload.WorkloadConfig(vocab=VOCAB), 64)
    t2, l2 = jax_workload.train_pairs(jax_workload.WorkloadConfig(vocab=VOCAB), 64)
    np.testing.assert_array_equal(t1, t2)
    np.testing.assert_array_equal(l1, l2)


def test_histogram_matches_jax(rng):
    vals = rng.lognormal(-5, 2, size=500)
    mine, ref = Histogram(), JaxHistogram()
    for v in vals:
        mine.record(v)
        ref.record(v)
    assert mine.counts == ref.counts
    assert mine.summary() == ref.summary()


def test_predictions_match_jax(jax_pred):
    pred = _convert(jax_pred)
    reqs = _reqs(24, 7, prompt=40)
    pred.predict_batch(reqs)
    jreqs = _reqs(24, 7, prompt=40)
    jax_pred.predict_batch(jreqs)
    assert [r.predicted_bucket for r in reqs] == \
        [r.predicted_bucket for r in jreqs]
    assert [r.predicted_output_len for r in reqs] == \
        [r.predicted_output_len for r in jreqs]
    assert pred.predict(reqs[0].tokens) == jax_pred.predict(reqs[0].tokens)
    np.testing.assert_array_equal(pred.buckets, jax_pred.buckets)


def test_adam_step_matches_jax():
    jpred = jax_profiler.LengthPredictor(
        jax_profiler.PredictorConfig(vocab=VOCAB), seed=4)
    tpred = _convert(jpred)
    toks, lens = jax_workload.train_pairs(
        jax_workload.WorkloadConfig(vocab=VOCAB), 32, seed=2)
    labels = jpred.length_to_bucket(lens)
    mask = (toks > 0).astype(np.float32)
    grads = jax.grad(jpred._loss)(jpred.params, jnp.asarray(toks),
                                  jnp.asarray(mask), jnp.asarray(labels))
    tt, tm = tpred._tensors(toks)
    tgrads = tpred._grads(tt, tm, torch.as_tensor(labels))
    for name, g in tgrads.items():
        np.testing.assert_allclose(g.numpy(), np.asarray(grads[name]),
                                   atol=1e-7, err_msg=name)
    # The first Adam step maps g to lr*g/(|g|+eps): near |g| ~ eps = 1e-8 it
    # amplifies a 1e-9 gradient difference up to ~1e-5, so the update is
    # compared on the same (JAX) gradients and the gradients above alone.
    jpred._adam_step(grads, jpred.cfg.lr)
    tpred._adam_step({n: torch.from_numpy(np.array(g))
                      for n, g in grads.items()}, tpred.cfg.lr)
    _params_close(tpred, jpred.params, 1e-6)
    for name in tpred.opt_m:
        np.testing.assert_allclose(tpred.opt_m[name].numpy(),
                                   np.asarray(jpred.opt_state[name]), atol=1e-6)


def test_online_update_matches_jax(jax_pred):
    jpred = copy.deepcopy(jax_pred)
    tpred = _convert(jpred)
    tokens = _reqs(1, 11, prompt=37)[0].tokens
    jpred.online_update(tokens, 300)
    tpred.online_update(tokens, 300)
    _params_close(tpred, jpred.params, 1e-5)


def test_fit_learns_the_length_signal():
    pred = profiler.LengthPredictor(profiler.PredictorConfig(), seed=0,
                                    device="cpu")
    toks, lens = workload.train_pairs(workload.WorkloadConfig(), 768, seed=1)
    assert pred.fit(toks, lens, epochs=20) > 0.9
    toks, lens = workload.train_pairs(workload.WorkloadConfig(), 256, seed=99)
    assert pred.accuracy(toks, lens) > 0.5


@pytest.mark.parametrize("name", ["slo-odbs", "slo-dbs", "odbs", "fifo", "s3"])
def test_schedulers_match_jax(cfgs, jax_pred, name):
    cfg, jcfg = cfgs
    reqs = _reqs(30, 5, vocab=cfg.vocab_size, prompt=16, out_max=16)
    profiler.ResourceProfiler(_convert(jax_pred), cfg).profile(reqs)
    jreqs = _reqs(30, 5, vocab=cfg.vocab_size, prompt=16, out_max=16,
                  mod=jax_workload)
    jax_profiler.ResourceProfiler(jax_pred, jcfg).profile(jreqs)
    assert [r.kv_bytes_estimate for r in reqs] == \
        [r.kv_bytes_estimate for r in jreqs]
    mine = scheduler.get_scheduler(name)(reqs, scheduler.SchedulerConfig(
        max_batch=4, threshold=3e3))
    ref = jax_scheduler.get_scheduler(name)(jreqs, jax_scheduler.SchedulerConfig(
        max_batch=4, threshold=3e3))
    assert [[r.rid for r in b.requests] for b in mine] == \
        [[r.rid for r in b.requests] for b in ref]


def _engines(cfgs, weights, **kw):
    cfg, jcfg = cfgs
    jparams, model = weights
    return (InferenceEngine(cfg, model, EngineConfig(**kw)),
            JaxInferenceEngine(jcfg, jparams, JaxEngineConfig(**kw)))


def test_run_batch_matches_jax(cfgs, weights):
    eng, jeng = _engines(cfgs, weights, max_batch=8, cache_len=32,
                         max_new_tokens=10)
    reqs = _reqs(8, 5, out_max=10)
    tl = {r.rid: r.true_output_len for r in reqs}
    got = eng.run_batch(Batch(requests=reqs), true_lens=tl)
    want = jeng.run_batch(Batch(requests=reqs), true_lens=tl)
    assert got.outputs == want.outputs
    assert got.steps == want.steps
    for r in reqs:
        assert len(got.outputs[r.rid]) == r.true_output_len
    free = eng.run_batch(Batch(requests=reqs[:3]))        # EOS / budget stop
    assert free.outputs == jeng.run_batch(Batch(requests=reqs[:3])).outputs


def test_run_continuous_matches_jax(cfgs, weights):
    eng, jeng = _engines(cfgs, weights, max_batch=3, cache_len=48,
                         max_new_tokens=8)
    reqs = sorted(_reqs(8, 6, out_max=8), key=lambda r: r.arrival)
    got = eng.run_continuous(reqs)
    want = jeng.run_continuous(reqs)
    assert got.outputs == want.outputs
    assert got.steps == want.steps


def test_serve_path_matches_jax(capsys, cfgs, weights, jax_pred,
                                monkeypatch):
    """The reference's default serve path (its own CLI, reduced model) and
    the port's serve path with the same weights and the same fitted
    predictor print the same outputs digest and monitor metrics."""
    monkeypatch.setattr("sys.argv", ["serve"])
    jax_serve.main()
    printed = capsys.readouterr().out
    digest = re.search(r"outputs_digest=(\w+)", printed).group(1)
    monitor = re.search(r"^monitor: (.*)$", printed, re.M).group(1)
    cfg, _ = cfgs
    out = serve.serve(cfg, weights[1], serve.make_requests(cfg, 12, 16),
                      _convert(jax_pred))
    assert out["digest"] == digest
    assert str(out["monitor"].metrics()) == monitor
    assert len(out["outputs"]) == 12 and out["tokens"] > 0


def test_serve_main_runs_on_cpu(capsys):
    out = serve.main(["--device", "cpu", "--requests", "5", "--max-new", "4"])
    assert len(out["outputs"]) == 5
    assert f"outputs_digest={out['digest']}" in capsys.readouterr().out
    cont = serve.main(["--device", "cpu", "--requests", "5", "--max-new", "4",
                       "--continuous"])
    assert cont["outputs"] == out["outputs"]


@pytest.mark.parametrize("arch", sorted(_PORTED) + ["qwen2-moe-period2"])
def test_fit_depth_keeps_whole_group_periods(arch):
    """``serve.fit_depth`` at every budget that fits a whole number of
    group periods exactly, and one byte below each: the deepest whole
    number of periods that fits, at the same width; every layer where all
    fit (``cfg`` itself); ``ValueError`` below one period.  The period is
    the reference's ``group_period``; "qwen2-moe-period2" is qwen2-moe with
    MoE on every second layer, whose cuts keep dense/MoE pairs.
    jamba-1.5-large-398b steps by 8 (the lcm of its attention period 8 and
    MoE period 2), and not one period fits the card's budget for weights
    in f32 or in bf16."""
    name = "qwen2-moe-a2.7b" if arch.endswith("period2") else arch
    full, jfull = get_config(name), jax_get_config(name)
    if arch.endswith("period2"):
        full, jfull = (dataclasses.replace(c, moe=dataclasses.replace(
            c.moe, moe_period=2)) for c in (full, jfull))
    period = group_period(full)
    assert period == jax_transformer.group_period(jfull)
    assert period == (8 if name == "jamba-1.5-large-398b" else
                      2 if name in ("gemma2-27b", "llama4-maverick-400b-a17b")
                      or arch.endswith("period2") else 1)
    assert serve.fit_depth(full, 4 * full.param_count()) is full
    assert serve.fit_depth(full, 1e15) is full
    f32 = {n: 4 * dataclasses.replace(full, n_layers=n).param_count()
           for n in range(period, full.n_layers + 1, period)}
    assert f32[full.n_layers] == 4 * jfull.param_count()
    for n, nbytes in f32.items():
        cut = serve.fit_depth(full, nbytes)
        assert cut.n_layers == n and cut.n_layers % period == 0
        assert (cut.d_model, cut.d_ff, cut.n_heads, cut.vocab_size, cut.moe,
                cut.n_encoder_layers) == (full.d_model, full.d_ff, full.n_heads,
                                          full.vocab_size, full.moe,
                                          full.n_encoder_layers)
        plan = [(s.attn, s.mlp) for s in cut.layer_plan()]
        assert plan == [(s.attn, s.mlp) for s in full.layer_plan()[:n]]
        if n == period:
            with pytest.raises(ValueError,
                               match=re.escape(f"{nbytes:.4g} bytes")):
                serve.fit_depth(full, nbytes - 1)
        else:
            assert serve.fit_depth(full, nbytes - 1).n_layers == n - period
    if arch.endswith("period2"):
        assert [s.mlp for s in full.layer_plan()[:2]] == ["dense", "moe"]
    if name == "jamba-1.5-large-398b":
        budget = serve.WEIGHT_SHARE * H100.hbm_bytes
        for bytes_per_param in (4, 2):
            one = bytes_per_param * dataclasses.replace(
                full, n_layers=period).param_count()
            assert one > budget
            with pytest.raises(ValueError, match=re.escape(f"{one:.4g} bytes")):
                serve.fit_depth(full, budget, bytes_per_param)
    if arch == "whisper-medium":
        # whole on one 80 GB H100, the encoder's 24 layers counted
        assert full.n_encoder_layers == 24
        assert serve.fit_depth(full, serve.WEIGHT_SHARE * H100.hbm_bytes) is full


@pytest.mark.parametrize("bytes_per_param", [4, 2], ids=["f32", "bf16"])
def test_fit_depth_llama4_at_the_weights_element_size(bytes_per_param):
    """llama4-maverick-400b-a17b on one 80 GB H100 (0.7 of its memory for
    the weights): not one two-layer period (a dense layer, then 128
    experts) fits in f32, 74.2 GB, and ``fit_depth`` raises naming it; in
    bf16 the period takes 37.1 GB, and it keeps those 2 layers."""
    full = get_config("llama4-maverick-400b-a17b")
    budget = serve.WEIGHT_SHARE * H100.hbm_bytes
    one = bytes_per_param * dataclasses.replace(full, n_layers=2).param_count()
    assert round(one / 1e8) == (742 if bytes_per_param == 4 else 371)
    if bytes_per_param == 4:
        for args in ((), (4,)):       # 4 bytes a parameter is the default
            with pytest.raises(ValueError,
                               match=re.escape(f"{one:.4g} bytes")):
                serve.fit_depth(full, budget, *args)
        return
    cut = serve.fit_depth(full, budget, bytes_per_param)
    assert cut.n_layers == 2 and cut.d_model == full.d_model
    assert [s.mlp for s in cut.layer_plan()] == ["dense", "moe"]
    assert one <= budget < 2 * one


def test_serve_cli_flags(monkeypatch, tmp_path):
    ap = serve.build_parser()
    assert ap.parse_args([]).reduced is True
    assert ap.parse_args(["--no-reduced"]).reduced is False
    assert ap.parse_args([]).device == "cuda"
    args = ap.parse_args([])
    assert (args.replicas, args.router, args.fleet, args.autoscale,
            args.models, args.retry_budget, args.detect_lag) == \
        (1, "round_robin", "joint", False, None, 2, 1.0)
    assert (args.trace, args.metrics_json, args.profile_out, args.profile_in,
            args.pricing_quantile, args.profile_half_life) == \
        (None, None, None, None, None, 0)
    # the cluster paths run (their lines are held to the reference's in
    # the tests below), and so do the observability flags and --speculate
    # on either cluster path (held to the reference's in
    # tests/test_torch_profile.py); a pricing quantile outside (0, 1] and
    # the reference's refusals of --paged with --autoscale or --models exit.
    # The fit is deterministic, so each vocab's predictor is fitted once
    # and copied to the later runs (a fit takes seconds on a loaded CPU)
    fitted, fit = {}, serve.fit_predictor

    def fit_once(vocab, device):
        if vocab not in fitted:
            fitted[vocab] = fit(vocab, device)
        return copy.deepcopy(fitted[vocab])
    monkeypatch.setattr(serve, "fit_predictor", fit_once)
    out = serve.main(["--replicas", "2", "--device", "cpu"])
    res = out["cluster"]
    assert len(res.finished) + len(res.shed) == len(res.requests) == 128
    small = ["--requests", "3", "--max-new", "2", "--device", "cpu"]
    trace, prof = str(tmp_path / "t.json"), str(tmp_path / "p.json")
    out = serve.main(["--paged", "--trace", trace, "--profile-out", prof]
                     + small)
    assert len(out["tracer"].events) > 0 and (tmp_path / "p.json").exists()
    out = serve.main(["--paged", "--profile-in", prof] + small)
    assert out["cost_profiler"].cells and len(out["outputs"]) == 3
    out = serve.main(["--replicas", "2", "--speculate", "--device", "cpu"])
    assert out["cluster"].summary()["offered"] == 128
    out = serve.main(["--replicas", "2", "--paged", "--speculate"] + small)
    assert len(out["outputs"]) == 3
    assert [rep.spec_tokens for rep in out["replicas"]] == [4, 4]
    for argv in (["--pricing-quantile", "0"],
                 ["--autoscale", "--paged"],
                 ["--models", "chatglm2-6b", "--paged"]):
        with pytest.raises(SystemExit):
            serve.main(argv + ["--device", "cpu"])
    # whisper-medium resolves, then fails where the reference's CLI fails:
    # its engine passes no frame embeddings to the model API's prefill
    with pytest.raises(KeyError, match="frames"):
        serve.main(["--arch", "whisper-medium", "--device", "cpu",
                    "--requests", "2", "--max-new", "2"])
    monkeypatch.setattr("sys.argv", ["serve", "--arch", "whisper-medium",
                                     "--requests", "2", "--max-new", "2"])
    with pytest.raises(KeyError, match="frames"):
        jax_serve.main()


class _Fitted:
    """Stands in for the JAX CLI's ``LengthPredictor``: a copy of an
    already fitted one (the same seed, pairs and epochs as the CLI's own
    fit), so the JAX run and the port's start from the same weights."""

    def __init__(self, fitted):
        self.fitted = fitted

    def __call__(self, *a, **kw):
        pred = copy.deepcopy(self.fitted)
        pred.fit = lambda *a, **kw: None
        return pred


@pytest.fixture(scope="module")
def sim_pred():
    """The simulated cluster path's JAX predictor: the default vocab, seed
    0, 8 epochs on 256 pairs."""
    pred = jax_profiler.LengthPredictor(jax_profiler.PredictorConfig(), seed=0)
    toks, lens = jax_workload.train_pairs(jax_workload.WorkloadConfig(), 256,
                                          seed=1)
    pred.fit(toks, lens, epochs=8)
    return pred


def _lines(printed, heads):
    return [ln for ln in printed.splitlines() if ln.startswith(heads)]


CLUSTER_SIM_ARGVS = {
    "slo_aware": ["--replicas", "4", "--router", "slo_aware"],
    "models_autoscale": ["--replicas", "4", "--models",
                         "chatglm2-6b:0.6,qwen2-1.5b:0.4", "--autoscale"],
    "faults": ["--replicas", "4", "--fault-crash", "2.5:1", "--fault-mtbf",
               "20", "--fault-mttr", "2", "--brownout-tiers", "batch"],
}


@pytest.mark.parametrize("case", sorted(CLUSTER_SIM_ARGVS))
def test_cluster_sim_cli_matches_jax(capsys, monkeypatch, sim_pred, case):
    """``serve --arch chatglm2-6b --replicas 4`` on the simulated cluster
    (slo_aware routing; a two-model fleet under the joint autoscaler; a
    scripted crash, random crashes and brownout), the port's CLI against
    the JAX CLI with the same fitted predictor: the same ``cluster:``,
    replica and ``monitor:`` lines, online updates included."""
    argv = ["--arch", "chatglm2-6b"] + CLUSTER_SIM_ARGVS[case]
    monkeypatch.setattr("sys.argv", ["serve", *argv])
    monkeypatch.setattr(jax_serve, "LengthPredictor", _Fitted(sim_pred))
    jax_serve.main()
    want = _lines(capsys.readouterr().out, ("cluster:", "  replica",
                                            "monitor:"))
    monkeypatch.setattr(serve, "fit_predictor", lambda c, d: predictor_from_numpy(
        jax.tree.map(np.array, sim_pred.params), profiler.PredictorConfig(),
        device="cpu"))
    out = serve.main([*argv, "--device", "cpu"])
    got = _lines(capsys.readouterr().out, ("cluster:", "  replica",
                                           "monitor:"))
    assert got == want and len(got) >= 3
    res, stats = out["cluster"], out["monitor"].stats
    assert len(res.finished) + len(res.shed) == len(res.requests)
    assert stats.slo_observed == len(res.requests)


CLUSTER_LIVE_ARGVS = {
    "round_robin": ["--replicas", "2", "--paged"],
    "prefix_affinity": ["--replicas", "2", "--paged", "--prefix-cache",
                        "--workload", "shared-prefix", "--router",
                        "prefix_affinity"],
}


@pytest.mark.parametrize("case", sorted(CLUSTER_LIVE_ARGVS))
def test_cluster_live_cli_matches_jax(capsys, monkeypatch, weights, jax_pred,
                                      case):
    """``serve --replicas 2 --paged`` at the reduced smollm: two live paged
    replicas, each serving its routed share; the port's CLI with the JAX
    run's weights and predictor prints the same replica lines, ``router:``
    line and outputs digest, the reference's split of the shared-prefix
    templates (both hash to replica 1, which takes all 12) included."""
    argv = CLUSTER_LIVE_ARGVS[case]
    monkeypatch.setattr("sys.argv", ["serve", *argv])
    monkeypatch.setattr(jax_serve, "LengthPredictor", _Fitted(jax_pred))
    jax_serve.main()
    heads = ("replica", "router:", "outputs_digest=")
    want = _lines(capsys.readouterr().out, heads)
    monkeypatch.setattr(serve.api, "init_params", lambda *a, **k: weights[1])
    monkeypatch.setattr(serve, "fit_predictor",
                        lambda c, d: _convert(jax_pred))
    out = serve.main([*argv, "--device", "cpu"])
    got = _lines(capsys.readouterr().out, heads)
    assert got == want
    assert len(out["outputs"]) == 12
    assert out["router"]["dispatched"] + out["router"]["shed"] == 12
    served = [len(rep.queue) for rep in out["replicas"]]
    if case == "prefix_affinity":
        assert served == [0, 12] and out["router"]["affinity_hits"] == 10
        assert out["results"][0].prefix_hits > 0
    else:
        assert served == [6, 6]


def test_get_config_names_the_later_slice():
    """Every arch of the reference registry resolves in the port, to the
    reference's name; an unknown name raises ``KeyError``."""
    names = jax_list_archs(include_extra=True)
    assert len(names) == 11 and "jamba-1.5-large-398b" in names
    for name in names:
        assert get_config(name).name == jax_get_config(name).name == name
    assert sorted(_PORTED) == sorted(names)
    with pytest.raises(KeyError):
        get_config("no-such-arch")


def test_entry_points_need_the_card_or_an_explicit_cpu(cfgs):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    cfg, _ = cfgs
    with pytest.raises(RuntimeError, match="device='cpu'"):
        api.init_params(cfg)
    with pytest.raises(RuntimeError):
        profiler.LengthPredictor()
    with pytest.raises(RuntimeError):
        serve.main([])
    assert resolve_device("cpu").type == "cpu"


def test_port_imports_no_jax_and_nothing_of_repro():
    files = sorted((ROOT / "src" / "repro_torch").rglob("*.py"))
    files += [ROOT / "chip_smoke.py", ROOT / "chip_compare.py",
              ROOT / "chip_variants.py", ROOT / "chip_gloo.py"]
    assert len(files) > 20
    names = {str(f.relative_to(ROOT / "src" / "repro_torch")) for f in files
             if "repro_torch" in f.parts}
    assert {"serving/simulator.py", "serving/cluster/replica.py",
            "serving/cluster/router.py", "serving/cluster/autoscaler.py",
            "serving/cluster/faults.py", "serving/cluster/fleet.py",
            "distributed/fault_tolerance.py", "obs/export.py",
            "obs/profile.py", "obs/calibrate.py", "training/optimizer.py",
            "training/trainer.py", "training/grad_compress.py",
            "checkpoint/manager.py", "data/pipeline.py",
            "launch/train.py", "sharding/mesh.py", "sharding/plan.py",
            "sharding/specs.py", "distributed/collectives.py",
            "distributed/ranks.py", "launch/mesh.py",
            "kernels/decode_attention/partial.py", "launch/dryrun.py",
            "launch/hillclimb.py"} <= names
    bad = re.compile(r"^\s*(import|from)\s+(jax|jaxlib|repro)(\.|\s|$)", re.M)
    for path in files:
        text = path.read_text()
        assert not bad.search(text), path
        assert "import jax" not in text, path
