"""The port's whisper-medium (the encoder-decoder family: an encoder stack
over stubbed frame embeddings, decoder blocks with self-attention,
cross-attention over the encoder memory and a plain GELU MLP, LayerNorm,
sinusoidal positions, a two-part decode cache) against the JAX package on
the CPU, on converted weights (f32; the attention kernels run their plain
versions, the JAX side its own CPU dispatch): config and cost terms,
``sinusoidal_positions``, ``encode``, the cross-attention prefill and
decode, prefill logits and every cache leaf, decode steps, a greedy loop
token for token, the paged entry points raising as the reference's do,
and the smoke checks of ``tests/test_models_smoke.py`` (shapes, finite
values, the cache's structure kept across a decode step).  Two layouts:
the reduced config (2 + 2 layers, d_model 64, 16 frames) and a narrow
variant with the published head layout (16 over 16 heads of 64, d_model
256)."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.models import api as jax_api
from repro.models import attention as jax_attention
from repro.models import common as jax_common
from repro.models import encdec as jax_encdec
from repro.serving.sampling import greedy as jax_greedy
from repro_torch.configs import get_config
from repro_torch.models import api, attention, common, encdec
from repro_torch.params import from_jax_params
from repro_torch.serving.sampling import greedy

ARCH = "whisper-medium"
ATOL = 1e-5                      # f32: summation order only
N_FRAMES = {"reduced": 16, "published": 40}


def _cfgs(layout):
    """(port cfg, JAX cfg): the reduced config, or ("published") a narrow
    2 + 2-layer variant with d_model 256 and the published head layout."""
    cfg, jcfg = get_config(ARCH).reduced(), jax_get_config(ARCH).reduced()
    if layout == "published":
        kw = dict(d_model=256, n_heads=16, n_kv_heads=16, head_dim=64,
                  d_ff=512, n_layers=2, n_encoder_layers=2)
        cfg, jcfg = (dataclasses.replace(c, **kw) for c in (cfg, jcfg))
    return cfg, jcfg


def _weights(cfg, jcfg, perturb_seed=1):
    """(JAX params, port model carrying them); every weight gets seeded
    noise, so biases and norm parameters are not their trivial init."""
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


@pytest.fixture(scope="module", params=["reduced", "published"])
def layout(request):
    return request.param


@pytest.fixture(scope="module")
def weights(layout):
    cfg, jcfg = _cfgs(layout)
    return (cfg, jcfg, *_weights(cfg, jcfg))


def _inputs(rng, cfg, layout, b=3, s=7):
    """Seeded frames [B, F, d] (x 0.02, as the reference's smoke tests) and
    right-padded decoder prompts [B, S] with their lengths."""
    frames = (rng.standard_normal((b, N_FRAMES[layout], cfg.d_model))
              * 0.02).astype(np.float32)
    toks = rng.integers(0, cfg.vocab_size, (b, s)).astype(np.int32)
    kv_len = np.array([s, 3, 1][:b], np.int32)
    for i, n in enumerate(kv_len):
        toks[i, n:] = 0
    return frames, toks, kv_len


def _prefill_both(cfg, jcfg, jparams, model, frames, toks, kv_len, cache_len):
    jl, jc = jax_api.prefill(jcfg, jparams, {"frames": jnp.asarray(frames),
                                             "tokens": jnp.asarray(toks)},
                             cache_len=cache_len, kv_len=jnp.asarray(kv_len))
    tl, tc = api.prefill(cfg, model, {"frames": torch.from_numpy(frames),
                                      "tokens": torch.from_numpy(toks).long()},
                         cache_len=cache_len, kv_len=torch.from_numpy(kv_len))
    return (jl, jc), (tl, tc)


def _cache_close(tc, jc):
    """Every leaf of the port's per-layer cache against the reference's
    stacked one ({"self": {"k", "v"}, "cross": {"ck", "cv"}}, [L, ...])."""
    assert len(tc) == np.asarray(jc["self"]["k"]).shape[0]
    for i, layer in enumerate(tc):
        assert set(layer) == {"self", "cross"}
        for part, keys in (("self", ("k", "v")), ("cross", ("ck", "cv"))):
            assert set(layer[part]) == set(keys)
            for key in keys:
                np.testing.assert_allclose(
                    layer[part][key].numpy(), np.asarray(jc[part][key][i]),
                    atol=ATOL, err_msg=f"layer {i} {part}.{key}")


@pytest.mark.parametrize("reduced", [True, False])
def test_config_matches_jax(reduced):
    cfg, jcfg = get_config(ARCH), jax_get_config(ARCH)
    if reduced:
        cfg, jcfg = cfg.reduced(), jcfg.reduced()
    for f in dataclasses.fields(cfg):
        assert getattr(cfg, f.name) == getattr(jcfg, f.name), f.name
    assert cfg.is_encdec and jcfg.is_encdec
    assert cfg.padded_vocab == jcfg.padded_vocab
    assert cfg.param_count() == jcfg.param_count()
    for b, s in ((1, 16), (4, 480)):
        assert cfg.kv_cache_bytes(b, s) == jcfg.kv_cache_bytes(b, s)
    if reduced:
        assert (cfg.n_layers, cfg.n_encoder_layers, cfg.cross_kv_len) == (2, 2, 16)
    else:
        assert (cfg.n_layers, cfg.n_encoder_layers, cfg.d_model,
                cfg.padded_vocab, cfg.cross_kv_len) == (24, 24, 1024, 51968, 1536)
        # the cross cache of the decode batch: 24 x B x 1,536 x 16 x 64 x 2
        assert cfg.kv_cache_bytes(4, 0, bytes_per=4) == \
            24 * 4 * 1536 * 16 * 64 * 2 * 4


@pytest.mark.parametrize("d_model", [64, 1024])
def test_sinusoidal_positions_match_jax(d_model):
    """The reference's formula (half - 1 in the frequency denominator, sin
    then cos), at integer positions [B, S] and at a decode step's kv_len."""
    def tol(pos):
        # XLA's and torch's f32 exp may differ by an ulp (2^-23 relative)
        # in a frequency; the angle pos * freq then differs by up to pos
        # times that: two ulps of the largest position
        return 2 * int(pos.max()) * 2.0 ** -23

    pos = np.arange(12).reshape(2, 6) * 37
    got = common.sinusoidal_positions(torch.from_numpy(pos), d_model)
    want = jax_common.sinusoidal_positions(jnp.asarray(pos), d_model)
    assert got.shape == (2, 6, d_model) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=tol(pos),
                               rtol=0)
    np.testing.assert_array_equal(got[0, 0].numpy(),
                                  [0.0] * (d_model // 2) + [1.0] * (d_model // 2))
    kv_len = np.array([0, 5, 1535], np.int32)
    np.testing.assert_allclose(
        common.sinusoidal_positions(torch.from_numpy(kv_len), d_model).numpy(),
        np.asarray(jax_common.sinusoidal_positions(
            jnp.asarray(kv_len).astype(jnp.float32), d_model)),
        atol=tol(kv_len), rtol=0)


def test_init_params_shapes_and_count(weights):
    cfg, _, jparams, _ = weights
    fresh = api.init_params(cfg, seed=3, device="cpu")
    assert isinstance(fresh, encdec.EncDec)
    sd = fresh.state_dict()
    conv = from_jax_params(jparams)
    assert {k: tuple(v.shape) for k, v in sd.items()} == \
        {k: tuple(v.shape) for k, v in conv.items()}
    for name in ("enc_blocks.1.attn.q.b", "dec_blocks.1.cross_attn.v.b",
                 "dec_blocks.0.norm3.bias", "enc_norm.scale", "embed.w"):
        assert name in sd, name
    assert not any(k.startswith(("blocks.", "head.")) for k in sd)
    np.testing.assert_array_equal(
        conv["dec_blocks.1.cross_attn.k.w"].numpy(),
        jparams["dec_blocks"]["cross_attn"]["k"]["w"][1])
    again = api.init_params(cfg, seed=3, device="cpu").state_dict()
    assert all(torch.equal(sd[k], again[k]) for k in sd)
    # the reference's count has no bias term (dense or LayerNorm) and no
    # encoder final norm
    assert sum(v.numel() for k, v in sd.items()
               if not k.endswith((".b", ".bias"))) \
        == cfg.param_count() + cfg.d_model


def test_encode_matches_jax(rng, weights, layout):
    cfg, jcfg, jparams, model = weights
    frames, _, _ = _inputs(rng, cfg, layout)
    got = encdec.encode(cfg, model, torch.from_numpy(frames))
    want = jax_encdec.encode(jcfg, jparams, jnp.asarray(frames))
    assert got.shape == frames.shape
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL)


def test_cross_attention_matches_jax(rng, weights, layout):
    """``cross_attn_prefill`` (output and its {"ck", "cv"} cache) and
    ``cross_attn_decode`` over that cache on one layer's weights."""
    cfg, jcfg, jparams, model = weights
    frames, _, _ = _inputs(rng, cfg, layout)
    x = (rng.standard_normal((3, 5, cfg.d_model))).astype(np.float32)
    x1 = (rng.standard_normal((3, 1, cfg.d_model))).astype(np.float32)
    p = model.dec_blocks[1].cross_attn
    jp = jax.tree.map(lambda a: a[1], jparams["dec_blocks"]["cross_attn"])
    y, cache = attention.cross_attn_prefill(cfg, p, torch.from_numpy(x),
                                            torch.from_numpy(frames))
    jy, jcache = jax_attention.cross_attn_prefill(
        jcfg, jp, jnp.asarray(x), jnp.asarray(frames), plan=None)
    np.testing.assert_allclose(y.numpy(), np.asarray(jy), atol=ATOL)
    assert cache["ck"].shape == (3, N_FRAMES[layout], cfg.n_kv_heads,
                                 cfg.head_dim_eff)
    for key in ("ck", "cv"):
        np.testing.assert_allclose(cache[key].numpy(), np.asarray(jcache[key]),
                                   atol=ATOL)
    y1 = attention.cross_attn_decode(cfg, p, torch.from_numpy(x1), cache)
    jy1 = jax_attention.cross_attn_decode(jcfg, jp, jnp.asarray(x1), jcache)
    assert y1.shape == (3, 1, cfg.d_model)
    np.testing.assert_allclose(y1.numpy(), np.asarray(jy1), atol=ATOL)


def test_prefill_logits_and_cache_match_jax(rng, weights, layout):
    """Right-padded decoder prompts: last-valid logits and every cache leaf
    (self K/V padded to cache_len, cross K/V of every frame)."""
    cfg, jcfg, jparams, model = weights
    frames, toks, kv_len = _inputs(rng, cfg, layout)
    (jl, jc), (tl, tc) = _prefill_both(cfg, jcfg, jparams, model, frames,
                                       toks, kv_len, cache_len=12)
    assert tl.shape == (3, cfg.padded_vocab)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=ATOL)
    _cache_close(tc, jc)


def test_decode_steps_match_jax(rng, weights, layout):
    """Four decode steps through ``api.decode_step`` from the same prefill:
    logits and every cache leaf after each step (the cross part passed
    through unchanged)."""
    cfg, jcfg, jparams, model = weights
    frames, toks, kv_len = _inputs(rng, cfg, layout)
    (jl, jc), (tl, tc) = _prefill_both(cfg, jcfg, jparams, model, frames,
                                       toks, kv_len, cache_len=12)
    cross = [c["cross"]["ck"].clone() for c in tc]
    for step in range(4):
        nxt = rng.integers(0, cfg.vocab_size, (3, 1)).astype(np.int32)
        jl, jc = jax_api.decode_step(jcfg, jparams, jnp.asarray(nxt), jc,
                                     jnp.asarray(kv_len + step))
        tl, tc = api.decode_step(cfg, model, torch.from_numpy(nxt).long(), tc,
                                 torch.from_numpy(kv_len + step))
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=ATOL,
                                   err_msg=f"step {step}")
        _cache_close(tc, jc)
    assert all(torch.equal(c["cross"]["ck"], ck) for c, ck in zip(tc, cross))


def test_greedy_loop_matches_jax(rng, weights, layout):
    """A greedy loop of 8 new tokens, each decoded as the padded engine
    decodes it (position kv_len + step): the same tokens as JAX's loop."""
    cfg, jcfg, jparams, model = weights
    frames, toks, kv_len = _inputs(rng, cfg, layout)
    (jl, jc), (tl, tc) = _prefill_both(cfg, jcfg, jparams, model, frames,
                                       toks, kv_len, cache_len=16)
    jouts, touts = [], []
    for step in range(8):
        jn, tn = np.asarray(jax_greedy(jl, jcfg.vocab_size)), \
            greedy(tl, cfg.vocab_size)
        jouts.append(jn)
        touts.append(tn.numpy())
        jl, jc = jax_api.decode_step(jcfg, jparams, jnp.asarray(jn)[:, None],
                                     jc, jnp.asarray(kv_len + step))
        tl, tc = api.decode_step(cfg, model, tn[:, None].long(), tc,
                                 torch.from_numpy(kv_len + step))
    np.testing.assert_array_equal(np.stack(touts), np.stack(jouts))


def test_prefill_decode_shapes_and_cache_structure(rng):
    """The port's analogue of the reference's ``test_prefill_decode_shapes``
    (``tests/test_models_smoke.py``) for whisper-medium: the reduced config
    on its own seeded init, full-length prompts over 16 frames; logits of
    the padded vocab, finite, and the cache's structure kept across a
    decode step."""
    cfg = get_config(ARCH).reduced()
    model = api.init_params(cfg, seed=1, device="cpu")
    b, s = 2, 16
    batch = {"tokens": torch.from_numpy(rng.integers(0, cfg.vocab_size, (b, s))),
             "frames": torch.from_numpy(rng.standard_normal(
                 (b, 16, cfg.d_model)).astype(np.float32)) * 0.02}
    kv_len = torch.full((b,), s, dtype=torch.int32)
    logits, cache = api.prefill(cfg, model, batch, cache_len=s + 8,
                                kv_len=kv_len)
    assert logits.shape == (b, cfg.padded_vocab)
    assert torch.isfinite(logits).all()
    nxt = greedy(logits, cfg.vocab_size)[:, None].long()
    shapes = [{p: {k: tuple(v.shape) for k, v in c[p].items()} for p in c}
              for c in cache]
    logits2, cache2 = api.decode_step(cfg, model, nxt, cache, kv_len)
    assert logits2.shape == (b, cfg.padded_vocab)
    assert torch.isfinite(logits2).all()
    assert [{p: {k: tuple(v.shape) for k, v in c[p].items()} for p in c}
            for c in cache2] == shapes
    assert shapes[0] == {"self": {"k": (b, s + 8, 4, 16), "v": (b, s + 8, 4, 16)},
                         "cross": {"ck": (b, 16, 4, 16), "cv": (b, 16, 4, 16)}}


def test_paged_and_prefix_paths_raise_as_in_the_reference(weights):
    """The encoder-decoder is not paged and has no prefix continuation, as
    in the reference: ``paged_compatible`` says why, the paged steps and a
    ``prefix_kv`` prefill raise ``NotImplementedError``, paged pools raise
    ``ValueError``, and a prefill without frames raises ``KeyError``."""
    cfg, jcfg, jparams, model = weights
    assert api.paged_compatible(cfg) == jax_api.paged_compatible(jcfg) == \
        (False, "enc-dec cross-attention cache is not paged")
    toks = torch.zeros((1, 4), dtype=torch.long)
    kv = torch.zeros(1, dtype=torch.int32)
    for fn, jfn in ((api.paged_decode_step, jax_api.paged_decode_step),
                    (api.paged_spec_step, jax_api.paged_spec_step)):
        extra = (kv, kv) if fn is api.paged_spec_step else ()
        with pytest.raises(NotImplementedError, match="enc-dec uses cross"):
            fn(cfg, model, toks, None, None, kv, *extra)
        with pytest.raises(NotImplementedError, match="enc-dec uses cross"):
            jfn(jcfg, jparams, jnp.asarray(toks.numpy()), None, None,
                jnp.asarray(kv.numpy()), *(jnp.asarray(kv.numpy()),) * len(extra))
    with pytest.raises(ValueError, match="not paged"):
        api.init_paged_pools(cfg, 8, 4, device="cpu")
    with pytest.raises(ValueError, match="not paged"):
        jax_api.init_paged_pools(jcfg, 8, 4)
    frames = torch.zeros((1, 16, cfg.d_model))
    with pytest.raises(NotImplementedError, match="prefix-continuation"):
        api.prefill(cfg, model, {"tokens": toks, "frames": frames},
                    cache_len=8, prefix_kv=[])
    with pytest.raises(NotImplementedError, match="prefix-continuation"):
        jax_api.prefill(jcfg, jparams, {"tokens": jnp.asarray(toks.numpy()),
                                        "frames": jnp.asarray(frames.numpy())},
                        cache_len=8, prefix_kv=[])
    with pytest.raises(KeyError, match="frames"):
        api.prefill(cfg, model, {"tokens": toks}, cache_len=8)
    with pytest.raises(KeyError, match="frames"):
        jax_api.prefill(jcfg, jparams, {"tokens": jnp.asarray(toks.numpy())},
                        cache_len=8)
