"""The port's minicpm3-4b (Multi-head Latent Attention: the cache holds the
compressed latent and the rope key; prefill expands them for flash
attention at D = dn + dr, Dv = dv; decode runs in the latent space with the
up-projection absorbed) against the JAX package on the CPU, on converted
weights (f32; flash attention runs its plain version): config, the MLA
projections and expansion, the absorbed decode, prefill and decode logits
and the latent cache, and the padded and ``--continuous`` serve paths'
digests and monitor lines against the JAX CLI's."""
import dataclasses
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.launch import serve as jax_serve
from repro.models import api as jax_api
from repro.models import attention as jax_attention
from repro.serving.sampling import greedy as jax_greedy
from repro_torch.configs import get_config
from repro_torch.launch import serve
from repro_torch.models import api
from repro_torch.models import attention
from repro_torch.params import from_jax_params
from repro_torch.serving.sampling import greedy
from test_torch_dense_archs import _jax_predictor

ARCH = "minicpm3-4b"
ATOL, RTOL = 5e-5, 5e-4        # logits, f32: summation order only
OP_ATOL = 1e-5                 # one layer's MLA functions, f32


def _weights(cfg, jcfg, perturb_seed=None):
    jparams = jax.tree.map(np.asarray, jax_api.init_params(
        jcfg, jax.random.PRNGKey(0), jnp.float32))
    if perturb_seed is not None:
        rng = np.random.default_rng(perturb_seed)
        jparams = jax.tree.map(
            lambda a: a + 0.05 * rng.standard_normal(a.shape).astype(np.float32),
            jparams)
    model = api.init_params(cfg, seed=0, device="cpu")
    model.load_state_dict(from_jax_params(jparams))
    return jparams, model


@pytest.fixture(scope="module")
def init_weights():
    cfg, jcfg = get_config(ARCH).reduced(), jax_get_config(ARCH).reduced()
    return (cfg, jcfg, *_weights(cfg, jcfg))


@pytest.fixture(scope="module")
def perturbed():
    cfg, jcfg = get_config(ARCH).reduced(), jax_get_config(ARCH).reduced()
    return (cfg, jcfg, *_weights(cfg, jcfg, perturb_seed=2))


@pytest.mark.parametrize("reduced", [True, False])
def test_config_matches_jax(reduced):
    cfg, jcfg = get_config(ARCH), jax_get_config(ARCH)
    if reduced:
        cfg, jcfg = cfg.reduced(), jcfg.reduced()
    for f in dataclasses.fields(cfg):
        if f.name not in ("source", "mla"):
            assert getattr(cfg, f.name) == getattr(jcfg, f.name), f.name
    assert cfg.source == jcfg.source
    assert dataclasses.asdict(cfg.mla) == dataclasses.asdict(jcfg.mla)
    assert cfg.mla.qk_head_dim == jcfg.mla.qk_head_dim
    assert (cfg.head_dim_eff, cfg.v_head_dim_eff) == \
        (jcfg.head_dim_eff, jcfg.v_head_dim_eff)
    assert [(s.mixer, s.attn, s.mlp) for s in cfg.layer_plan()] == \
        [(s.mixer, s.attn, s.mlp) for s in jcfg.layer_plan()]
    assert cfg._attn_params() == jcfg._attn_params()
    assert cfg.param_count() == jcfg.param_count()
    for b, s in ((1, 7), (4, 64), (4, 1088), (1, 32_768)):
        assert cfg.kv_cache_bytes(b, s) == jcfg.kv_cache_bytes(b, s)
    if not reduced:
        # 62 layers of the 256-wide latent and the 32-wide rope key
        assert (cfg.head_dim_eff, cfg.v_head_dim_eff) == (96, 64)
        assert cfg.kv_cache_bytes(1, 1, bytes_per=4) == 62 * (256 + 32) * 4


def test_init_params_shapes_and_count(init_weights):
    cfg, _, jparams, _ = init_weights
    fresh = api.init_params(cfg, seed=3, device="cpu").state_dict()
    conv = from_jax_params(jparams)
    assert {k: tuple(v.shape) for k, v in fresh.items()} == \
        {k: tuple(v.shape) for k, v in conv.items()}
    assert {"blocks.0.mixer.q_down.w", "blocks.1.mixer.kv_up.w"} <= set(fresh)
    assert sum(v.numel() for v in fresh.values()) == cfg.param_count()


def test_mla_projections_and_expansion_match_jax(rng, perturbed):
    cfg, jcfg, jparams, model = perturbed
    # one layer a group: layer i is group i of the reference's "l0"
    p, jp = model.blocks[1].mixer, jax.tree.map(
        lambda a: a[1], jparams["blocks"]["l0"]["mixer"])
    x = rng.standard_normal((2, 7, cfg.d_model)).astype(np.float32)
    pos = np.tile(np.arange(3, 10), (2, 1))
    got = attention._mla_qkv(cfg, p, torch.from_numpy(x), torch.from_numpy(pos))
    want = jax_attention._mla_qkv(jcfg, jp, jnp.asarray(x), jnp.asarray(pos))
    for a, b in zip(got, want):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=OP_ATOL)
    for a, b in zip(attention._mla_expand(cfg, p, *got[1:]),
                    jax_attention._mla_expand(jcfg, jp, *want[1:])):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=OP_ATOL)


def test_mla_decode_absorbed_matches_jax(rng, perturbed):
    """The latent-space decode against the reference's on a random latent
    cache with ragged lengths (one row at 1, one at the whole cache)."""
    cfg, jcfg, jparams, model = perturbed
    m = cfg.mla
    p, jp = model.blocks[0].mixer, jax.tree.map(
        lambda a: a[0], jparams["blocks"]["l0"]["mixer"])
    b, s = 4, 12
    q = rng.standard_normal((b, cfg.n_heads, m.qk_head_dim)).astype(np.float32)
    cache = {"c_kv": rng.standard_normal((b, s, m.kv_lora_rank)).astype(np.float32),
             "k_rope": rng.standard_normal((b, s, m.qk_rope_head_dim)
                                           ).astype(np.float32)}
    kv_len = np.array([1, 5, 9, s], np.int32)
    got = attention._mla_decode_absorbed(
        cfg, p, torch.from_numpy(q),
        {k: torch.from_numpy(v) for k, v in cache.items()},
        torch.from_numpy(kv_len))
    want = jax_attention._mla_decode_absorbed(
        jcfg, jp, jnp.asarray(q), {k: jnp.asarray(v) for k, v in cache.items()},
        jnp.asarray(kv_len))
    assert tuple(got.shape) == (b, cfg.n_heads, m.v_head_dim)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=OP_ATOL)


def test_prefill_and_decode_logits_match_jax(rng, perturbed):
    """Right-padded ragged batch: last-valid prefill logits, the latent
    cache, and six decode steps through it within ATOL."""
    cfg, jcfg, jparams, model = perturbed
    toks = rng.integers(0, cfg.vocab_size, size=(3, 11)).astype(np.int32)
    kv_len = np.array([11, 4, 7], np.int32)
    for i, n in enumerate(kv_len):
        toks[i, n:] = 0
    jl, jc = jax_api.prefill(jcfg, jparams, {"tokens": jnp.asarray(toks)},
                             cache_len=24, kv_len=jnp.asarray(kv_len))
    tl, tc = api.prefill(cfg, model, {"tokens": torch.from_numpy(toks).long()},
                         cache_len=24, kv_len=torch.from_numpy(kv_len))
    assert set(tc[0]) == {"c_kv", "k_rope"}
    for i in range(cfg.n_layers):
        for key in ("c_kv", "k_rope"):
            np.testing.assert_allclose(
                tc[i][key].numpy(), np.asarray(jc["l0"]["mixer"][key][i]),
                atol=ATOL, rtol=RTOL)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=ATOL, rtol=RTOL)
    for step in range(6):
        nxt = np.array(jax_greedy(jl, jcfg.vocab_size))
        assert np.array_equal(greedy(tl, cfg.vocab_size).numpy(), nxt)
        jl, jc = jax_api.decode_step(jcfg, jparams, jnp.asarray(nxt)[:, None],
                                     jc, jnp.asarray(kv_len + step))
        tl, tc = api.decode_step(cfg, model, torch.from_numpy(nxt)[:, None].long(),
                                 tc, torch.from_numpy(kv_len + step))
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=ATOL,
                                   rtol=RTOL)


@pytest.mark.parametrize("mode", ["padded", "continuous"])
def test_serve_path_matches_jax(capsys, monkeypatch, init_weights, mode):
    """The reference's serve CLI with ``--arch minicpm3-4b`` (reduced, its
    own init; ``--continuous`` too) and the port's serve path on the same
    weights and fitted predictor print the same outputs digest and monitor
    metrics; the port's CLI names the same production-mesh plan."""
    cfg, _, _, model = init_weights
    flags = ["--continuous"] if mode == "continuous" else []
    monkeypatch.setattr("sys.argv", ["serve", "--arch", ARCH] + flags)
    jax_serve.main()
    printed = capsys.readouterr().out
    out = serve.serve(cfg, model, serve.make_requests(cfg, 12, 16),
                      _jax_predictor(cfg.vocab_size),
                      continuous=mode == "continuous")
    assert f"outputs_digest={out['digest']}" in printed
    assert f"monitor: {out['monitor'].metrics()}" in printed
    assert len(out["outputs"]) == 12 and out["tokens"] > 0
    jplan = re.search(r"plan for production mesh: (\w+)", printed).group(1)
    mine = serve.main(["--arch", ARCH, "--device", "cpu", "--requests", "3",
                       "--max-new", "4"] + flags)
    assert len(mine["outputs"]) == 3
    assert f"plan for production mesh: {jplan})" in capsys.readouterr().out


def test_paged_is_refused_as_in_the_reference(monkeypatch, init_weights):
    cfg, _, _, model = init_weights
    assert api.paged_compatible(get_config(ARCH)) == \
        (False, "MLA decodes from the compressed latent cache")
    with pytest.raises(ValueError, match="latent"):
        serve.main(["--arch", ARCH, "--device", "cpu", "--paged"])
    monkeypatch.setattr("sys.argv", ["serve", "--arch", ARCH, "--paged"])
    with pytest.raises(ValueError, match="latent"):
        jax_serve.main()
    with pytest.raises(NotImplementedError, match="plain GQA cache"):
        api.prefill(cfg, model, {"tokens": torch.zeros(1, 4, dtype=torch.long)},
                    cache_len=8,
                    prefix_kv=[{"k": torch.zeros(1, 3, 1, 1)}] * cfg.n_layers)
