"""The port's model code against the JAX package on the same converted
weights and numpy inputs, at the reduced smollm-135m size (f32, CPU: the
attention kernels run their plain versions)."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.models import api as jax_api
from repro.models import attention as jax_attn
from repro.models import common as jax_common
from repro.models import mlp as jax_mlp
from repro.serving.sampling import greedy as jax_greedy
from repro_torch.configs import get_config
from repro_torch.configs.base import LayerSpec
from repro_torch.models import api, attention, common, mlp
from repro_torch.params import from_jax_params
from repro_torch.serving.sampling import greedy

ATOL = 1e-5


@pytest.fixture(scope="module")
def models():
    """(port cfg, JAX cfg, JAX params, port model with the JAX weights)."""
    jcfg = jax_get_config("smollm-135m").reduced()
    cfg = get_config("smollm-135m").reduced()
    jparams = jax_api.init_params(jcfg, jax.random.PRNGKey(0), jnp.float32)
    model = api.init_params(cfg, seed=0, device="cpu")
    model.load_state_dict(from_jax_params(jax.tree.map(np.asarray, jparams)))
    return cfg, jcfg, jparams, model


def _layer0(jparams, key):
    return jax.tree.map(lambda a: a[0], jparams["blocks"]["l0"][key])


def _x(rng, *shape):
    return rng.standard_normal(shape).astype(np.float32)


def test_reduced_config_matches_jax(models):
    cfg, jcfg, *_ = models
    for f in dataclasses.fields(cfg):
        if f.name != "source":
            assert getattr(cfg, f.name) == getattr(jcfg, f.name), f.name
    assert cfg.padded_vocab == jcfg.padded_vocab
    assert cfg.kv_cache_bytes(2, 40) == jcfg.kv_cache_bytes(2, 40)


def test_full_config_matches_jax():
    cfg, jcfg = get_config("smollm-135m"), jax_get_config("smollm-135m")
    assert (cfg.n_layers, cfg.d_model, cfg.n_heads, cfg.n_kv_heads,
            cfg.head_dim_eff, cfg.d_ff, cfg.vocab_size, cfg.tie_embeddings) \
        == (jcfg.n_layers, jcfg.d_model, jcfg.n_heads, jcfg.n_kv_heads,
            jcfg.head_dim_eff, jcfg.d_ff, jcfg.vocab_size, jcfg.tie_embeddings)
    assert cfg.kv_cache_bytes(1, 100) == jcfg.kv_cache_bytes(1, 100)


def test_init_params_shapes_match_jax(models):
    cfg, jcfg, jparams, model = models
    fresh = api.init_params(cfg, seed=3, device="cpu").state_dict()
    conv = from_jax_params(jax.tree.map(np.asarray, jparams))
    assert {k: tuple(v.shape) for k, v in fresh.items()} == \
        {k: tuple(v.shape) for k, v in conv.items()}
    again = api.init_params(cfg, seed=3, device="cpu").state_dict()
    assert all(torch.equal(fresh[k], again[k]) for k in fresh)


def test_apply_norm_matches_jax(rng, models):
    cfg, jcfg, jparams, model = models
    x = _x(rng, 2, 5, cfg.d_model)
    scale = rng.standard_normal(cfg.d_model).astype(np.float32)
    p = common.Norm(cfg)
    p.scale.data = torch.from_numpy(scale)
    got = common.apply_norm(cfg, p, torch.from_numpy(x)).numpy()
    want = jax_common.apply_norm(jcfg, {"scale": scale}, x)
    np.testing.assert_allclose(got, np.asarray(want), atol=ATOL)


def test_apply_rope_matches_jax(rng):
    x = _x(rng, 2, 7, 3, 16)
    pos = rng.integers(0, 4000, size=(2, 7))
    got = common.apply_rope(torch.from_numpy(x), torch.from_numpy(pos), 1e4)
    want = jax_common.apply_rope(x, pos, 1e4)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL)


def test_mlp_apply_matches_jax(rng, models):
    cfg, jcfg, jparams, model = models
    x = _x(rng, 2, 5, cfg.d_model)
    got = mlp.mlp_apply(cfg, model.blocks[0].mlp, torch.from_numpy(x))
    want = jax_mlp.mlp_apply(jcfg, _layer0(jparams, "mlp"), x)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL)


def test_attn_prefill_matches_jax(rng, models):
    cfg, jcfg, jparams, model = models
    b, s, cache_len = 3, 9, 16
    x = _x(rng, b, s, cfg.d_model)
    pos = np.broadcast_to(np.arange(s), (b, s))
    kv_len = np.array([9, 4, 6], np.int32)
    y, cache = attention.attn_prefill(
        cfg, LayerSpec(), model.blocks[0].mixer, torch.from_numpy(x),
        positions=torch.from_numpy(pos.copy()), cache_len=cache_len,
        kv_len=torch.from_numpy(kv_len))
    jy, jc = jax_attn.attn_prefill(
        jcfg, jcfg.layer_plan()[0], _layer0(jparams, "mixer"), x,
        positions=jnp.asarray(pos), plan=None, cache_len=cache_len,
        kv_len=jnp.asarray(kv_len))
    np.testing.assert_allclose(y.numpy(), np.asarray(jy), atol=ATOL)
    for key in ("k", "v"):
        assert cache[key].shape == (b, cache_len, cfg.n_kv_heads, cfg.head_dim_eff)
        np.testing.assert_allclose(cache[key].numpy(), np.asarray(jc[key]),
                                   atol=ATOL)


def test_pad_seq_keeps_most_recent_entries(rng):
    x = _x(rng, 2, 10, 1, 4)
    got = attention._pad_seq(torch.from_numpy(x), 6)
    np.testing.assert_array_equal(got.numpy(), np.asarray(jax_attn._pad_seq(x, 6)))
    np.testing.assert_array_equal(got.numpy(), x[:, 4:])
    padded = attention._pad_seq(torch.from_numpy(x), 12).numpy()
    np.testing.assert_array_equal(padded, np.asarray(jax_attn._pad_seq(x, 12)))


def test_attn_decode_matches_jax_in_place(rng, models):
    cfg, jcfg, jparams, model = models
    b, cache_len = 3, 16
    x = _x(rng, b, 1, cfg.d_model)
    kshape = (b, cache_len, cfg.n_kv_heads, cfg.head_dim_eff)
    k0, v0 = _x(rng, *kshape), _x(rng, *kshape)
    kv_len = np.array([3, 15, 8], np.int32)
    cache = {"k": torch.from_numpy(k0.copy()), "v": torch.from_numpy(v0.copy())}
    y, new = attention.attn_decode(cfg, LayerSpec(), model.blocks[0].mixer,
                                   torch.from_numpy(x), cache,
                                   torch.from_numpy(kv_len))
    jy, jc = jax_attn.attn_decode(jcfg, jcfg.layer_plan()[0],
                                  _layer0(jparams, "mixer"), x,
                                  {"k": k0, "v": v0}, jnp.asarray(kv_len),
                                  plan=None)
    assert new["k"] is cache["k"]           # written in place
    np.testing.assert_allclose(y.numpy(), np.asarray(jy), atol=ATOL)
    np.testing.assert_allclose(new["k"].numpy(), np.asarray(jc["k"]), atol=ATOL)
    np.testing.assert_allclose(new["v"].numpy(), np.asarray(jc["v"]), atol=ATOL)


def test_prefill_and_decode_logits_match_jax(rng, models):
    """Right-padded ragged batch: last-valid-row prefill logits and three
    decode steps from per-row lengths, on converted weights."""
    cfg, jcfg, jparams, model = models
    toks = rng.integers(0, cfg.vocab_size, size=(3, 11)).astype(np.int32)
    kv_len = np.array([11, 4, 7], np.int32)
    for i, n in enumerate(kv_len):
        toks[i, n:] = 0
    jl, jc = jax_api.prefill(jcfg, jparams, {"tokens": jnp.asarray(toks)},
                             cache_len=24, kv_len=jnp.asarray(kv_len))
    tl, tc = api.prefill(cfg, model, {"tokens": torch.from_numpy(toks).long()},
                         cache_len=24, kv_len=torch.from_numpy(kv_len))
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=1e-4)
    for step in range(3):
        nxt = np.array(jax_greedy(jl, jcfg.vocab_size))
        assert np.array_equal(greedy(tl, cfg.vocab_size).numpy(), nxt)
        jl, jc = jax_api.decode_step(jcfg, jparams, jnp.asarray(nxt)[:, None],
                                     jc, jnp.asarray(kv_len + step))
        tl, tc = api.decode_step(cfg, model, torch.from_numpy(nxt)[:, None].long(),
                                 tc, torch.from_numpy(kv_len + step))
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=1e-4)


def test_greedy_masks_padded_vocab(rng):
    """Ids >= vocab_size are padding: never chosen, as in the reference."""
    logits = _x(rng, 4, 512)
    logits[:, 500:] += 100.0
    got = greedy(torch.from_numpy(logits), 500)
    want = np.asarray(jax_greedy(logits, 500))
    np.testing.assert_array_equal(got.numpy(), want)
    assert (got.numpy() < 500).all() and got.dtype == torch.int32
    cfg = dataclasses.replace(get_config("smollm-135m").reduced(), vocab_size=500)
    assert cfg.padded_vocab == 512


def test_from_jax_params_unstacks_groups(models):
    cfg, jcfg, jparams, model = models
    sd = from_jax_params(jax.tree.map(np.asarray, jparams))
    stacked = np.asarray(jparams["blocks"]["l0"]["mixer"]["q"]["w"])
    for i in range(cfg.n_layers):
        np.testing.assert_array_equal(sd[f"blocks.{i}.mixer.q.w"].numpy(),
                                      stacked[i])
    np.testing.assert_array_equal(sd["embed.w"].numpy(),
                                  np.asarray(jparams["embed"]["w"]))


VARIANTS = {
    # per-block options of other dense families, on the reduced smollm
    "softcaps_postnorm_gelu_untied": dict(
        attn_softcap=50.0, final_softcap=30.0, post_block_norms=True,
        scale_embeddings=True, tie_embeddings=False, act="gelu"),
    "qkv_bias_layernorm_ungated": dict(qkv_bias=True, norm="layernorm",
                                       gated_mlp=False, rope_theta=1e6),
}


@pytest.mark.parametrize("variant", VARIANTS)
def test_block_options_match_jax(rng, variant):
    """Every option the port's ModelConfig keeps runs as in the reference:
    prefill and two decode steps on perturbed converted weights (so biases
    and norm scales are not their trivial init)."""
    kw = VARIANTS[variant]
    jcfg = dataclasses.replace(jax_get_config("smollm-135m").reduced(), **kw)
    cfg = dataclasses.replace(get_config("smollm-135m").reduced(), **kw)
    jparams = jax.tree.map(
        lambda a: np.asarray(a) + 0.05 * rng.standard_normal(a.shape).astype(np.float32),
        jax_api.init_params(jcfg, jax.random.PRNGKey(1), jnp.float32))
    model = api.init_params(cfg, seed=1, device="cpu")
    model.load_state_dict(from_jax_params(jparams))
    toks = rng.integers(0, cfg.vocab_size, size=(2, 7)).astype(np.int32)
    kv_len = np.array([7, 5], np.int32)
    jl, jc = jax_api.prefill(jcfg, jparams, {"tokens": jnp.asarray(toks)},
                             cache_len=12, kv_len=jnp.asarray(kv_len))
    tl, tc = api.prefill(cfg, model, {"tokens": torch.from_numpy(toks).long()},
                         cache_len=12, kv_len=torch.from_numpy(kv_len))
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=1e-4)
    for step in range(2):
        nxt = np.array(jax_greedy(jl, jcfg.vocab_size))
        jl, jc = jax_api.decode_step(jcfg, jparams, jnp.asarray(nxt)[:, None],
                                     jc, jnp.asarray(kv_len + step))
        tl, tc = api.decode_step(cfg, model, torch.from_numpy(nxt)[:, None].long(),
                                 tc, torch.from_numpy(kv_len + step))
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=1e-4)


@pytest.mark.parametrize("what", ["window", "mrope", "prefix"])
def test_unported_branches_raise(models, what):
    cfg, *_ = models
    toks = {"tokens": torch.zeros(1, 4, dtype=torch.long)}
    prefix = None
    if what == "window":
        cfg = dataclasses.replace(cfg, sliding_window=2)
    elif what == "mrope":
        cfg = dataclasses.replace(cfg, rope="mrope")
    else:
        prefix = {}
    model = api.init_params(cfg, device="cpu")
    with pytest.raises(NotImplementedError):
        api.prefill(cfg, model, toks, cache_len=8, prefix_kv=prefix)
