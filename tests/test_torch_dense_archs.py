"""The port's dense archs chatglm2-6b (the paper's own model) and qwen2-1.5b
against the JAX package on the CPU, on converted weights (f32; the
attention kernels run their plain versions): configs, init, prefill and
decode logits at the reduced size and at a narrow variant with the
published head layout (32 or 12 query heads over 2 KV heads at head_dim
128), decode through the cache against the reference's full forward, the
default serve path's digest and monitor line against the JAX CLI, the
``--continuous`` and ``--paged`` serve paths, and the paged engine token
for token against the JAX ``PagedEngine``."""
import dataclasses
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.core import profiler as jax_profiler
from repro.core.types import Request as JaxRequest
from repro.data import workload as jax_workload
from repro.launch import serve as jax_serve
from repro.models import api as jax_api
from repro.models import transformer as jax_transformer
from repro.serving import PagedEngine as JaxPagedEngine
from repro.serving import PagedEngineConfig as JaxPagedEngineConfig
from repro.serving.sampling import greedy as jax_greedy
from repro_torch.configs import get_config
from repro_torch.core import profiler
from repro_torch.core.types import Request
from repro_torch.launch import serve
from repro_torch.models import api
from repro_torch.params import from_jax_params, predictor_from_numpy
from repro_torch.serving import PagedEngine, PagedEngineConfig
from repro_torch.serving.sampling import greedy

ARCHS = ["chatglm2-6b", "qwen2-1.5b"]
ATOL = 1e-5                      # logits, f32: summation order only
FORWARD_ATOL = 1e-5              # decode through the cache vs the full forward
# the published layouts: (query heads, KV heads, head_dim) of the full config
PUBLISHED = {"chatglm2-6b": (32, 2, 128), "qwen2-1.5b": (12, 2, 128)}


def _cfgs(arch, layout):
    """(port cfg, JAX cfg): the reduced config, or ("published") a narrow
    2-layer variant with d_model 256 and the published head layout."""
    cfg, jcfg = get_config(arch).reduced(), jax_get_config(arch).reduced()
    if layout == "published":
        h, kv, hd = PUBLISHED[arch]
        kw = dict(d_model=256, n_heads=h, n_kv_heads=kv, head_dim=hd,
                  n_layers=2)
        cfg, jcfg = (dataclasses.replace(c, **kw) for c in (cfg, jcfg))
    return cfg, jcfg


def _weights(cfg, jcfg, perturb_seed=None):
    """(JAX params, port model carrying them).  With ``perturb_seed`` every
    weight gets seeded noise, so biases and norm scales are not their
    trivial init."""
    jparams = jax_api.init_params(jcfg, jax.random.PRNGKey(0), jnp.float32)
    jparams = jax.tree.map(np.asarray, jparams)
    if perturb_seed is not None:
        rng = np.random.default_rng(perturb_seed)
        jparams = jax.tree.map(
            lambda a: a + 0.05 * rng.standard_normal(a.shape).astype(np.float32),
            jparams)
    model = api.init_params(cfg, seed=0, device="cpu")
    model.load_state_dict(from_jax_params(jparams))
    return jparams, model


@pytest.fixture(scope="module", params=ARCHS)
def arch(request):
    return request.param


@pytest.fixture(scope="module")
def init_weights(arch):
    """(cfg, JAX cfg, JAX params as the reference initialises them, port
    model carrying them): the weights the reference's serve CLI uses."""
    cfg, jcfg = _cfgs(arch, "reduced")
    return (cfg, jcfg, *_weights(cfg, jcfg))


@pytest.fixture(scope="module")
def perturbed(arch):
    cfg, jcfg = _cfgs(arch, "reduced")
    return (cfg, jcfg, *_weights(cfg, jcfg, perturb_seed=3))


@pytest.mark.parametrize("reduced", [True, False])
def test_config_matches_jax(arch, reduced):
    cfg, jcfg = get_config(arch), jax_get_config(arch)
    if reduced:
        cfg, jcfg = cfg.reduced(), jcfg.reduced()
    for f in dataclasses.fields(cfg):
        if f.name != "source":
            assert getattr(cfg, f.name) == getattr(jcfg, f.name), f.name
    assert cfg.source == jcfg.source
    assert cfg.layer_plan() == tuple(
        type(cfg.layer_plan()[0])(mixer=s.mixer, attn=s.attn, mlp=s.mlp)
        for s in jcfg.layer_plan())
    assert cfg.padded_vocab == jcfg.padded_vocab
    assert cfg.param_count() == jcfg.param_count()
    for b, s in ((1, 16), (4, 1088)):
        assert cfg.kv_cache_bytes(b, s) == jcfg.kv_cache_bytes(b, s)
    if not reduced:
        # the published layout: 2 KV heads of 128, groups of 16 and 6
        assert (cfg.n_kv_heads, cfg.head_dim_eff, cfg.qkv_bias) == (2, 128, True)
        assert cfg.kv_cache_bytes(1, 1, bytes_per=4) == \
            cfg.n_layers * 2 * 2 * 128 * 4


def test_init_params_shapes_and_seeding(init_weights):
    cfg, jcfg, jparams, _ = init_weights
    fresh = api.init_params(cfg, seed=3, device="cpu").state_dict()
    conv = from_jax_params(jparams)
    assert {k: tuple(v.shape) for k, v in fresh.items()} == \
        {k: tuple(v.shape) for k, v in conv.items()}
    assert "blocks.1.mixer.q.b" in fresh and "blocks.0.mixer.v.b" in fresh
    assert ("head.w" in fresh) == (not cfg.tie_embeddings)
    again = api.init_params(cfg, seed=3, device="cpu").state_dict()
    other = api.init_params(cfg, seed=4, device="cpu").state_dict()
    assert all(torch.equal(fresh[k], again[k]) for k in fresh)
    assert not torch.equal(fresh["embed.w"], other["embed.w"])
    assert sum(v.numel() for k, v in fresh.items() if not k.endswith(".b")) \
        == cfg.param_count()


def _ragged(rng, cfg, b=3, s=11):
    toks = rng.integers(0, cfg.vocab_size, size=(b, s)).astype(np.int32)
    kv_len = np.array([s, 4, 7][:b], np.int32)
    for i, n in enumerate(kv_len):
        toks[i, n:] = 0
    return toks, kv_len


@pytest.mark.parametrize("layout", ["reduced", "published"])
def test_prefill_and_decode_logits_match_jax(rng, arch, layout):
    """Right-padded ragged batch on perturbed converted weights: last-valid
    prefill logits and three decode steps within ATOL; at the published
    layout the plain attention versions run group 16 (or 6) at D = 128."""
    cfg, jcfg = _cfgs(arch, layout)
    jparams, model = _weights(cfg, jcfg, perturb_seed=1)
    toks, kv_len = _ragged(rng, cfg)
    jl, jc = jax_api.prefill(jcfg, jparams, {"tokens": jnp.asarray(toks)},
                             cache_len=24, kv_len=jnp.asarray(kv_len))
    tl, tc = api.prefill(cfg, model, {"tokens": torch.from_numpy(toks).long()},
                         cache_len=24, kv_len=torch.from_numpy(kv_len))
    assert tl.shape == (3, cfg.padded_vocab)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=ATOL)
    for step in range(3):
        nxt = np.array(jax_greedy(jl, jcfg.vocab_size))
        assert np.array_equal(greedy(tl, cfg.vocab_size).numpy(), nxt)
        jl, jc = jax_api.decode_step(jcfg, jparams, jnp.asarray(nxt)[:, None],
                                     jc, jnp.asarray(kv_len + step))
        tl, tc = api.decode_step(cfg, model, torch.from_numpy(nxt)[:, None].long(),
                                 tc, torch.from_numpy(kv_len + step))
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=ATOL)


def test_decode_matches_the_reference_forward(perturbed):
    """The port's prefill and four greedy decode steps through its cache
    reproduce the reference's teacher-forced ``lm_forward`` on the whole
    sequence (the port's analogue of the reference's decode-vs-forward
    consistency case for chatglm2-6b)."""
    cfg, jcfg, jparams, model = perturbed
    b, s, n_steps = 2, 20, 4
    toks = np.random.default_rng(0).integers(0, cfg.vocab_size, (b, s))
    logits, cache = api.prefill(cfg, model, {"tokens": torch.from_numpy(toks)},
                                cache_len=s + n_steps)
    seq = toks
    kv_len = torch.full((b,), s, dtype=torch.int32)
    for i in range(n_steps):
        nxt = greedy(logits, cfg.vocab_size).numpy()[:, None]
        seq = np.concatenate([seq, nxt], axis=1)
        logits, cache = api.decode_step(cfg, model, torch.from_numpy(nxt).long(),
                                        cache, kv_len + i)
    full, _ = jax_transformer.lm_forward(jcfg, jparams, jnp.asarray(seq))
    np.testing.assert_allclose(logits.numpy(), np.asarray(full[:, -1]),
                               atol=FORWARD_ATOL)


def _jax_predictor(vocab):
    pred = jax_profiler.LengthPredictor(
        jax_profiler.PredictorConfig(vocab=vocab), seed=0)
    toks, lens = jax_workload.train_pairs(
        jax_workload.WorkloadConfig(vocab=vocab), 256, seed=1)
    pred.fit(toks, lens, epochs=8)
    return predictor_from_numpy(jax.tree.map(np.array, pred.params),
                                profiler.PredictorConfig(vocab=vocab),
                                device="cpu")


def test_serve_path_matches_jax(capsys, arch, init_weights, monkeypatch):
    """The reference's serve CLI with ``--arch`` (reduced model, its own
    init) and the port's serve path on the same weights and fitted
    predictor print the same outputs digest and monitor metrics and name
    the same production-mesh plan; the port's ``--continuous`` and
    ``--paged`` paths give the same outputs."""
    cfg, _, _, model = init_weights
    monkeypatch.setattr("sys.argv", ["serve", "--arch", arch])
    jax_serve.main()
    printed = capsys.readouterr().out
    digest = re.search(r"outputs_digest=(\w+)", printed).group(1)
    monitor = re.search(r"^monitor: (.*)$", printed, re.M).group(1)
    jplan = re.search(r"plan for production mesh: (\w+)", printed).group(1)
    pred = _jax_predictor(cfg.vocab_size)
    reqs = serve.make_requests(cfg, 12, 16)
    out = serve.serve(cfg, model, reqs, pred)
    assert out["digest"] == digest
    assert str(out["monitor"].metrics()) == monitor
    assert len(out["outputs"]) == 12 and out["tokens"] > 0
    for kw in (dict(continuous=True),
               dict(paged=serve.paged_config(cfg, reqs, 16, 2e6))):
        assert serve.serve(cfg, model, reqs, pred, **kw)["outputs"] == \
            out["outputs"]
    # the port's CLI names the same plan (its own seeded weights)
    mine = serve.main(["--arch", arch, "--device", "cpu", "--requests", "3",
                       "--max-new", "4"])
    assert len(mine["outputs"]) == 3
    assert f"plan for production mesh: {jplan})" in capsys.readouterr().out


def _templates(cfg, n=6, seed=7):
    rng = np.random.default_rng(seed)
    tmpl = [rng.integers(0, cfg.vocab_size, 24).tolist() for _ in range(2)]
    return [(i, tmpl[i % 2] + rng.integers(0, cfg.vocab_size, 8).tolist(),
             int(rng.integers(2, 8)), 10.0, float(i)) for i in range(n)]


def _plain(cfg, n=7, seed=5):
    reqs = jax_workload.gen_requests(jax_workload.WorkloadConfig(
        n_requests=n, seed=seed, vocab=cfg.vocab_size))
    return [(r.rid, [t % cfg.vocab_size for t in r.tokens[:10]],
             min(r.true_output_len % 8 + 1, 8), r.slo, r.arrival) for r in reqs]


# PagedBatchResult fields that read the wall clock
CLOCKED = {"prefill_s", "decode_s", "prefill_stall_s", "inter_token_s"}


@pytest.mark.parametrize("flags", ["plain", "prefix"])
def test_paged_engine_matches_jax(init_weights, flags):
    """Token-identical outputs and equal counters (all but the clocked
    ones) against the JAX PagedEngine: the plain flag set, and the prefix
    cache on template-sharing prompts."""
    cfg, jcfg, jparams, model = init_weights
    specs, kw = (_plain(cfg), {}) if flags == "plain" else \
        (_templates(cfg), dict(prefix_cache=True))
    kw = dict(max_batch=4, block_size=8, n_blocks=64, max_seq_len=64,
              max_new_tokens=12, **kw)
    mk = lambda cls: [cls(rid=rid, tokens=list(t), input_len=len(t), slo=slo,
                          arrival=arr, true_output_len=out)
                      for rid, t, out, slo, arr in specs]
    res = PagedEngine(cfg, model, PagedEngineConfig(**kw)).run_continuous(
        mk(Request))
    jres = JaxPagedEngine(jcfg, jparams, JaxPagedEngineConfig(**kw)
                          ).run_continuous(mk(JaxRequest))
    assert res.outputs == jres.outputs and res.outputs
    for f in dataclasses.fields(jres):
        if f.name not in CLOCKED:
            assert getattr(res, f.name) == getattr(jres, f.name), f.name
    if flags == "prefix":
        assert res.prefix_hits > 0
