"""The port's RWKV-6 model and its serve path against the JAX package, at
the reduced rwkv6-3b size on converted weights (f32, CPU: the WKV6 op runs
its plain version): config, parameters, each module, prefill and decode
logits (the JAX op on its XLA path and on the Pallas kernel in interpret
mode), the padded and continuous engines token for token on mixed-length
batches, and the default serve path's digest and monitor line."""
import dataclasses
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.core import profiler as jax_profiler
from repro.data import workload as jax_workload
from repro.kernels.backend import use_backend
from repro.launch import serve as jax_serve
from repro.models import api as jax_api
from repro.models import common as jax_common
from repro.models import mlp as jax_mlp
from repro.models import rwkv as jax_rwkv
from repro.models import transformer as jax_transformer
from repro.serving import EngineConfig as JaxEngineConfig
from repro.serving import InferenceEngine as JaxInferenceEngine
from repro.serving.sampling import greedy as jax_greedy
from repro_torch.configs import get_config
from repro_torch.core import profiler
from repro_torch.core.types import Batch, Request
from repro_torch.launch import serve
from repro_torch.models import api, common, mlp, rwkv, transformer
from repro_torch.params import from_jax_params, predictor_from_numpy
from repro_torch.serving import EngineConfig, InferenceEngine
from repro_torch.serving.sampling import greedy

ARCH = "rwkv6-3b"
ATOL = 1e-5


@pytest.fixture(scope="module")
def models():
    """(port cfg, JAX cfg, JAX params, port model with the JAX weights).
    The decay lora's B starts at zero in both inits; it is perturbed here
    so that the decay depends on the data, as in a trained model."""
    jcfg = jax_get_config(ARCH).reduced()
    cfg = get_config(ARCH).reduced()
    jparams = jax_api.init_params(jcfg, jax.random.PRNGKey(0), jnp.float32)
    rng = np.random.default_rng(5)
    lora_b = jparams["blocks"]["l0"]["mixer"]["w_lora_b"]
    jparams["blocks"]["l0"]["mixer"]["w_lora_b"] = jnp.asarray(
        rng.standard_normal(lora_b.shape).astype(np.float32) * 0.5)
    model = api.init_params(cfg, seed=0, device="cpu")
    model.load_state_dict(from_jax_params(jax.tree.map(np.asarray, jparams)))
    return cfg, jcfg, jparams, model


@pytest.fixture(scope="module")
def init_weights():
    """(JAX params as the reference initialises them, port model carrying
    them): the weights the reference's serve CLI uses."""
    cfg = get_config(ARCH).reduced()
    jparams = jax_api.init_params(jax_get_config(ARCH).reduced(),
                                  jax.random.PRNGKey(0), jnp.float32)
    model = api.init_params(cfg, seed=0, device="cpu")
    model.load_state_dict(from_jax_params(jax.tree.map(np.asarray, jparams)))
    return jparams, model


def _block0(jparams):
    return jax.tree.map(lambda a: a[0], jparams["blocks"]["l0"])


def _layer0(jparams, key):
    return _block0(jparams)[key]


def _x(rng, *shape):
    return rng.standard_normal(shape).astype(np.float32)


def _fields(cfg):
    return {f.name: (dataclasses.asdict(getattr(cfg, f.name))
                     if f.name == "rwkv" else getattr(cfg, f.name))
            for f in dataclasses.fields(cfg) if f.name != "source"}


@pytest.mark.parametrize("reduced", [True, False])
def test_config_matches_jax(reduced):
    cfg, jcfg = get_config(ARCH), jax_get_config(ARCH)
    if reduced:
        cfg, jcfg = cfg.reduced(), jcfg.reduced()
    for name, val in _fields(cfg).items():
        want = getattr(jcfg, name)
        if name == "rwkv":
            want = dataclasses.asdict(want)
        assert val == want, name
    assert [s.mixer for s in cfg.layer_plan()] == \
        [s.mixer for s in jcfg.layer_plan()] == ["rwkv6"] * cfg.n_layers
    for b, s in ((1, 16), (4, 1088)):
        assert cfg.kv_cache_bytes(b, s) == jcfg.kv_cache_bytes(b, s)
    assert cfg.padded_vocab == jcfg.padded_vocab


def test_init_params_shapes_match_jax(models):
    cfg, jcfg, jparams, model = models
    fresh = api.init_params(cfg, seed=3, device="cpu").state_dict()
    conv = from_jax_params(jax.tree.map(np.asarray, jparams))
    assert {k: tuple(v.shape) for k, v in fresh.items()} == \
        {k: tuple(v.shape) for k, v in conv.items()}
    assert "blocks.1.mixer.w_lora_b" in conv and "blocks.0.mlp.key.w" in conv
    np.testing.assert_array_equal(
        conv["blocks.1.mixer.u"].numpy(),
        np.asarray(jparams["blocks"]["l0"]["mixer"]["u"])[1])
    # the reference's init values where they are not random
    blk = api.init_params(cfg, seed=3, device="cpu").blocks[0]
    assert (blk.mixer.w0 == -5.0).all() and (blk.mixer.w_lora_b == 0).all()
    assert (blk.mixer.mix_g == 0.5).all() and (blk.mlp.mix_k == 0.5).all()
    again = api.init_params(cfg, seed=3, device="cpu").state_dict()
    assert all(torch.equal(fresh[k], again[k]) for k in fresh)


def test_group_norm_matches_jax(rng):
    x = _x(rng, 2, 5, 64)
    scale, bias = _x(rng, 64), _x(rng, 64)
    got = common.group_norm(*(torch.from_numpy(a) for a in (x, scale, bias)), 4)
    want = jax_common.group_norm(x, scale, bias, 4)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL)


def test_channel_mix_matches_jax(rng, models):
    cfg, jcfg, jparams, model = models
    x = _x(rng, 2, 7, cfg.d_model)
    jx = jnp.asarray(x)
    got = mlp.channel_mix_apply(cfg, model.blocks[0].mlp, torch.from_numpy(x),
                                mlp.token_shift(torch.from_numpy(x)))
    want = jax_mlp.channel_mix_apply(jcfg, _layer0(jparams, "mlp"), jx,
                                     jax_mlp.token_shift(jx))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL)
    np.testing.assert_array_equal(mlp.token_shift(torch.from_numpy(x)).numpy(),
                                  np.asarray(jax_mlp.token_shift(jx)))


def test_rwkv_prefill_and_decode_match_jax(rng, models):
    cfg, jcfg, jparams, model = models
    b, t = 3, 11
    x = _x(rng, b, t, cfg.d_model)
    kv_len = np.array([11, 4, 7], np.int32)
    p, jp = model.blocks[0].mixer, _layer0(jparams, "mixer")
    y, cache = rwkv.rwkv_prefill(cfg, p, torch.from_numpy(x), cache_len=16,
                                 kv_len=torch.from_numpy(kv_len))
    jy, jc = jax_rwkv.rwkv_prefill(jcfg, jp, x, cache_len=16,
                                   kv_len=jnp.asarray(kv_len))
    np.testing.assert_allclose(y.numpy(), np.asarray(jy), atol=ATOL)
    for key in ("shift", "state"):
        np.testing.assert_allclose(cache[key].numpy(), np.asarray(jc[key]),
                                   atol=ATOL)
    for _ in range(3):
        xt = _x(rng, b, 1, cfg.d_model)
        y, cache = rwkv.rwkv_decode(cfg, p, torch.from_numpy(xt), cache)
        jy, jc = jax_rwkv.rwkv_decode(jcfg, jp, xt, jc)
        np.testing.assert_allclose(y.numpy(), np.asarray(jy), atol=ATOL)
        for key in ("shift", "state"):
            np.testing.assert_allclose(cache[key].numpy(), np.asarray(jc[key]),
                                       atol=ATOL)


def test_block_apply_matches_jax(rng, models):
    """The whole RWKV-6 block, prefill then two decode steps, cache
    (shift, state, cm_shift) included."""
    cfg, jcfg, jparams, model = models
    spec, jspec = cfg.layer_plan()[0], jcfg.layer_plan()[0]
    b, t = 2, 9
    x = _x(rng, b, t, cfg.d_model)
    kv_len = np.array([9, 3], np.int32)
    y, c = transformer.block_apply(cfg, spec, model.blocks[0], torch.from_numpy(x),
                                   positions=None, cache=None,
                                   kv_len=torch.from_numpy(kv_len),
                                   mode="prefill", cache_len=16)
    jy, jc, _ = jax_transformer.block_apply(
        jcfg, jspec, _block0(jparams), x, positions=None, plan=None,
        cache=None, kv_len=jnp.asarray(kv_len), mode="prefill", cache_len=16)
    np.testing.assert_allclose(y.numpy(), np.asarray(jy), atol=ATOL)

    def check(c, jc):
        assert set(c) == {"shift", "state", "cm_shift"}
        for key in ("shift", "state"):
            np.testing.assert_allclose(c[key].numpy(),
                                       np.asarray(jc["mixer"][key]), atol=ATOL)
        np.testing.assert_allclose(c["cm_shift"].numpy(),
                                   np.asarray(jc["cm_shift"]), atol=ATOL)
    check(c, jc)
    for _ in range(2):
        xt = _x(rng, b, 1, cfg.d_model)
        y, c = transformer.block_apply(cfg, spec, model.blocks[0],
                                       torch.from_numpy(xt), positions=None,
                                       cache=c, kv_len=None, mode="decode",
                                       cache_len=0)
        jy, jc, _ = jax_transformer.block_apply(
            jcfg, jspec, _block0(jparams), xt, positions=None, plan=None,
            cache=jc, kv_len=None, mode="decode", cache_len=0)
        np.testing.assert_allclose(y.numpy(), np.asarray(jy), atol=ATOL)
        check(c, jc)


@pytest.mark.parametrize("backend", ["xla", "pallas_interpret"])
def test_prefill_and_decode_logits_match_jax(rng, models, backend):
    """Right-padded mixed-length batch: last-valid-row prefill logits (the
    JAX op on ``backend``) and four decode steps, on converted weights."""
    cfg, jcfg, jparams, model = models
    toks = rng.integers(0, cfg.vocab_size, size=(3, 37)).astype(np.int32)
    kv_len = np.array([37, 4, 20], np.int32)
    for i, n in enumerate(kv_len):
        toks[i, n:] = 0
    with use_backend(backend):
        jl, jc = jax_api.prefill(jcfg, jparams, {"tokens": jnp.asarray(toks)},
                                 cache_len=48, kv_len=jnp.asarray(kv_len))
    tl, tc = api.prefill(cfg, model, {"tokens": torch.from_numpy(toks).long()},
                         cache_len=48, kv_len=torch.from_numpy(kv_len))
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=1e-4)
    for step in range(4):
        nxt = np.array(jax_greedy(jl, jcfg.vocab_size))
        assert np.array_equal(greedy(tl, cfg.vocab_size).numpy(), nxt)
        jl, jc = jax_api.decode_step(jcfg, jparams, jnp.asarray(nxt)[:, None],
                                     jc, jnp.asarray(kv_len + step))
        tl, tc = api.decode_step(cfg, model,
                                 torch.from_numpy(nxt)[:, None].long(), tc,
                                 torch.from_numpy(kv_len + step))
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=1e-4)


def _reqs(lens, seed, vocab, out_len=8):
    rng = np.random.default_rng(seed)
    return [Request(rid=i, tokens=rng.integers(2, vocab, n).tolist(),
                    input_len=n, slo=1.0 + i, arrival=0.1 * i,
                    true_output_len=1 + (out_len + i) % out_len)
            for i, n in enumerate(lens)]


def _engines(models, **kw):
    cfg, jcfg, jparams, model = models
    return (InferenceEngine(cfg, model, EngineConfig(**kw)),
            JaxInferenceEngine(jcfg, jparams, JaxEngineConfig(**kw)))


def test_run_batch_mixed_lengths_matches_jax(models):
    """A mixed-length batch: the short rows' state runs through the padding
    (the reference's behaviour, kept), and the outputs equal the JAX
    engine's token for token."""
    eng, jeng = _engines(models, max_batch=4, cache_len=32, max_new_tokens=8)
    reqs = _reqs((3, 12, 7, 1), 3, models[0].vocab_size)
    tl = {r.rid: r.true_output_len for r in reqs}
    got = eng.run_batch(Batch(requests=reqs), true_lens=tl)
    want = jeng.run_batch(Batch(requests=reqs), true_lens=tl)
    assert got.outputs == want.outputs and got.steps == want.steps
    free = eng.run_batch(Batch(requests=reqs[:2]))        # EOS / budget stop
    assert free.outputs == jeng.run_batch(Batch(requests=reqs[:2])).outputs


PAD_PROMPT = [5, 17, 33]


def test_padding_runs_into_the_state_as_in_the_reference(models, init_weights):
    """The prompt [5, 17, 33] batched with a 12-token prompt continues
    differently from the same prompt alone after its first token: the
    recurrence runs over the right padding, in the port as in the JAX
    engine, on the reference's own init (ROADMAP queue 3)."""
    cfg, jcfg, _, _ = models
    jparams, model = init_weights
    kw = dict(max_batch=2, cache_len=32, max_new_tokens=8)
    eng = InferenceEngine(cfg, model, EngineConfig(**kw))
    jeng = JaxInferenceEngine(jcfg, jparams, JaxEngineConfig(**kw))
    other = np.random.default_rng(4).integers(2, cfg.vocab_size, 12).tolist()
    short, long_ = (Request(rid=i, tokens=p, input_len=len(p), slo=1.0,
                            arrival=0.0, true_output_len=8)
                    for i, p in enumerate((PAD_PROMPT, other)))
    tl = {0: 8, 1: 8}
    pair = eng.run_batch(Batch(requests=[short, long_]), true_lens=tl).outputs
    alone = eng.run_batch(Batch(requests=[short]), true_lens=tl).outputs
    assert pair == jeng.run_batch(Batch(requests=[short, long_]),
                                  true_lens=tl).outputs
    assert alone == jeng.run_batch(Batch(requests=[short]), true_lens=tl).outputs
    assert pair[0][0] == alone[0][0] and pair[0] != alone[0]


def test_run_continuous_matches_jax(models):
    eng, jeng = _engines(models, max_batch=3, cache_len=48, max_new_tokens=8)
    reqs = _reqs((5, 11, 2, 9, 14, 3, 7), 6, models[0].vocab_size)
    got = eng.run_continuous(reqs)
    want = jeng.run_continuous(reqs)
    assert got.outputs == want.outputs and got.steps == want.steps


def test_serve_path_matches_jax(capsys, models, init_weights, monkeypatch):
    """The reference's default serve path on rwkv6-3b (its own CLI, reduced
    model) and the port's, with the same weights and the same fitted
    predictor, print the same outputs digest and monitor metrics."""
    cfg, jcfg, _, _ = models
    monkeypatch.setattr("sys.argv", ["serve", "--arch", ARCH])
    jax_serve.main()
    printed = capsys.readouterr().out
    digest = re.search(r"outputs_digest=(\w+)", printed).group(1)
    monitor = re.search(r"^monitor: (.*)$", printed, re.M).group(1)
    jpred = jax_profiler.LengthPredictor(
        jax_profiler.PredictorConfig(vocab=cfg.vocab_size), seed=0)
    toks, lens = jax_workload.train_pairs(
        jax_workload.WorkloadConfig(vocab=cfg.vocab_size), 256, seed=1)
    jpred.fit(toks, lens, epochs=8)
    pred = predictor_from_numpy(jax.tree.map(np.array, jpred.params),
                                profiler.PredictorConfig(vocab=cfg.vocab_size),
                                device="cpu")
    out = serve.serve(cfg, init_weights[1], serve.make_requests(cfg, 12, 16),
                      pred)
    assert out["digest"] == digest
    assert str(out["monitor"].metrics()) == monitor
    assert len(out["outputs"]) == 12 and out["tokens"] > 0


def test_serve_main_runs_rwkv_on_cpu(capsys):
    out = serve.main(["--arch", ARCH, "--device", "cpu", "--requests", "5",
                      "--max-new", "4"])
    assert len(out["outputs"]) == 5
    assert f"outputs_digest={out['digest']}" in capsys.readouterr().out
    cont = serve.main(["--arch", ARCH, "--device", "cpu", "--requests", "5",
                       "--max-new", "4", "--continuous"])
    assert len(cont["outputs"]) == 5


def test_paged_and_prefix_continuation_raise_as_in_the_reference(models):
    cfg, jcfg, *_ = models
    assert api.paged_compatible(cfg) == jax_api.paged_compatible(jcfg)
    assert not api.paged_compatible(cfg)[0]
    with pytest.raises(ValueError, match="rwkv6 state is recurrent"):
        serve.main(["--arch", ARCH, "--device", "cpu", "--paged",
                    "--requests", "2"])
    model = api.init_params(cfg, device="cpu")
    prefix = [{"k": torch.zeros(1, 2, 4, 16)}] * cfg.n_layers
    with pytest.raises(NotImplementedError, match="recurrent"):
        api.prefill(cfg, model, {"tokens": torch.zeros(1, 4, dtype=torch.long)},
                    cache_len=8, prefix_kv=prefix)
