"""The port's serve path against the JAX package: workload streams,
length predictor (predictions, one Adam step, one online update),
schedulers, the padded and continuous engines and the whole default serve
path, on converted weights at the reduced smollm-135m size on the CPU; plus
the port's structural rules (no JAX, card by default)."""
import copy
import re
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.core import profiler as jax_profiler
from repro.core import scheduler as jax_scheduler
from repro.data import workload as jax_workload
from repro.launch import serve as jax_serve
from repro.models import api as jax_api
from repro.obs.hist import Histogram as JaxHistogram
from repro.serving import EngineConfig as JaxEngineConfig
from repro.serving import InferenceEngine as JaxInferenceEngine
from repro_torch.configs import get_config
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


def test_serve_cli_flags():
    ap = serve.build_parser()
    assert ap.parse_args([]).reduced is True
    assert ap.parse_args(["--no-reduced"]).reduced is False
    assert ap.parse_args([]).device == "cuda"
    for argv in (["--paged"], ["--replicas", "2"], ["--trace", "t.json"],
                 ["--workload", "shared-prefix"]):
        with pytest.raises(SystemExit):
            serve.main(argv + ["--device", "cpu"])
    with pytest.raises(NotImplementedError):
        serve.main(["--arch", "gemma2-27b", "--device", "cpu"])


def test_get_config_names_the_later_slice():
    with pytest.raises(NotImplementedError, match="queue 1"):
        get_config("rwkv6-3b")
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
    files.append(ROOT / "chip_smoke.py")
    assert len(files) > 20
    bad = re.compile(r"^\s*(import|from)\s+(jax|jaxlib|repro)(\.|\s|$)", re.M)
    for path in files:
        text = path.read_text()
        assert not bad.search(text), path
        assert "import jax" not in text, path
