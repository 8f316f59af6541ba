"""The port's gemma2-27b (local sliding-window layers on a ring cache,
global layers, attention and final softcaps, sandwich norms, GELU, scaled
tied embeddings) against the JAX package on the CPU, on converted weights
(f32; the attention kernels run their plain versions): config, prefill and
decode logits with the ring narrower than the cache and with the window
wider than it, the ring's layout, the ring decode through the
flash-decoding kernel's plain version against the reference's
``_ring_decode`` before and after the ring wraps, a long decode across the
window, and the padded and ``--continuous`` serve paths' digests and
monitor lines against the JAX CLI's."""
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
from repro.models import transformer as jax_transformer
from repro.serving.sampling import greedy as jax_greedy
from repro_torch.configs import get_config
from repro_torch.launch import serve
from repro_torch.models import api
from repro_torch.models import attention
from repro_torch.models.transformer import Transformer
from repro_torch.params import from_jax_params
from repro_torch.serving.sampling import greedy
from test_torch_dense_archs import _jax_predictor

ARCH = "gemma2-27b"
ATOL, RTOL = 5e-5, 5e-4        # logits, f32: summation order only
RING_ATOL = 1e-6               # one attention call, f32
FORWARD_ATOL = 5e-4            # the reference's decode-vs-forward tolerance


def _weights(cfg, jcfg, perturb_seed=None):
    """(JAX params, port model carrying them); ``perturb_seed`` adds seeded
    noise to every weight, so norm scales are not their trivial init."""
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


@pytest.mark.parametrize("reduced", [True, False])
def test_config_matches_jax(reduced):
    cfg, jcfg = get_config(ARCH), jax_get_config(ARCH)
    if reduced:
        cfg, jcfg = cfg.reduced(), jcfg.reduced()
    for f in dataclasses.fields(cfg):
        if f.name != "source":
            assert getattr(cfg, f.name) == getattr(jcfg, f.name), f.name
    assert cfg.source == jcfg.source
    assert [(s.mixer, s.attn, s.mlp) for s in cfg.layer_plan()] == \
        [(s.mixer, s.attn, s.mlp) for s in jcfg.layer_plan()]
    assert [s.attn for s in cfg.layer_plan()[:2]] == ["window", "full"]
    assert cfg.padded_vocab == jcfg.padded_vocab
    assert cfg.param_count() == jcfg.param_count()
    for b, s in ((1, 7), (2, 8), (4, 64), (2, 4640), (1, 32_768)):
        assert cfg.kv_cache_bytes(b, s) == jcfg.kv_cache_bytes(b, s)
    if reduced:
        assert (cfg.sliding_window, cfg.n_layers) == (8, 2)
    else:
        # a window layer holds at most 4,096 positions
        per = 2 * 16 * 128 * 2
        assert cfg.kv_cache_bytes(1, 8192) == 23 * (8192 + 4096) * per


def test_init_params_shapes_and_count(init_weights):
    cfg, _, jparams, _ = init_weights
    fresh = api.init_params(cfg, seed=3, device="cpu").state_dict()
    conv = from_jax_params(jparams)
    assert {k: tuple(v.shape) for k, v in fresh.items()} == \
        {k: tuple(v.shape) for k, v in conv.items()}
    assert "blocks.0.norm1_post.scale" in fresh and "head.w" not in fresh
    assert sum(v.numel() for v in fresh.values()) == cfg.param_count() \
        + 2 * cfg.n_layers * cfg.d_model        # the sandwich norms


def _ragged(rng, cfg, s=11):
    toks = rng.integers(0, cfg.vocab_size, size=(3, s)).astype(np.int32)
    kv_len = np.array([s, 4, 9], np.int32)
    for i, n in enumerate(kv_len):
        toks[i, n:] = 0
    return toks, kv_len


@pytest.mark.parametrize("window", [8, 32], ids=["ring", "wider_than_cache"])
def test_prefill_and_decode_logits_match_jax(rng, window):
    """Right-padded ragged batch on perturbed converted weights: last-valid
    prefill logits and six decode steps, at cache_len 24.  Window 8: the
    local layer keeps a ring of 8 slots (rows of 11 and 9 tokens already
    wrapped); window 32: its cache is the plain 24 slots, decoded as a ring
    of 24 as in the reference."""
    cfg, jcfg = (dataclasses.replace(c.reduced(), sliding_window=window)
                 for c in (get_config(ARCH), jax_get_config(ARCH)))
    jparams, model = _weights(cfg, jcfg, perturb_seed=1)
    toks, kv_len = _ragged(rng, cfg)
    jl, jc = jax_api.prefill(jcfg, jparams, {"tokens": jnp.asarray(toks)},
                             cache_len=24, kv_len=jnp.asarray(kv_len))
    tl, tc = api.prefill(cfg, model, {"tokens": torch.from_numpy(toks).long()},
                         cache_len=24, kv_len=torch.from_numpy(kv_len))
    assert tuple(tc[0]["k"].shape) == (3, min(window, 24), cfg.n_kv_heads,
                                       cfg.head_dim_eff)
    assert tuple(tc[1]["k"].shape) == (3, 24, cfg.n_kv_heads, cfg.head_dim_eff)
    for key in ("k", "v"):
        np.testing.assert_allclose(tc[0][key].numpy(),
                                   np.asarray(jc["l0"]["mixer"][key][0]),
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


def test_build_window_cache_matches_jax(rng):
    """Ring layout for lengths below, at and past the window (slot =
    position % w, each row's newest w entries, unreached slots clamped)."""
    k = rng.standard_normal((6, 20, 2, 4)).astype(np.float32)
    kv_len = np.array([1, 5, 8, 9, 13, 20], np.int32)
    for w in (8, 5):
        got = attention.build_window_cache(torch.from_numpy(k),
                                           torch.from_numpy(kv_len), w)
        want = jax_attention.build_window_cache(jnp.asarray(k),
                                                jnp.asarray(kv_len), w)
        assert np.array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("w,window", [(8, 8), (24, 4096)],
                         ids=["ring_of_the_window", "ring_of_the_cache"])
def test_ring_decode_through_decode_attention_matches_jax(rng, w, window):
    """The ring decode the model runs (``ring_decode_attention``: the
    flash-decoding kernel, here its plain version, over the first
    min(kv_len + 1, w) slots, no window) and
    the plain ``ring_decode`` against the reference's ``_ring_decode``:
    kv_len below, at and past w, the ring wrapped up to three times, at
    group 2 with the softcap."""
    cfg = get_config(ARCH).reduced()
    jcfg = jax_get_config(ARCH).reduced()
    b, h, kv, d = 7, 4, 2, 16
    kv_len = np.array([0, 3, w - 2, w - 1, w, w + 5, 3 * w + 1], np.int32)
    q = rng.standard_normal((b, h, d)).astype(np.float32)
    k = rng.standard_normal((b, w, kv, d)).astype(np.float32) * 2
    v = rng.standard_normal((b, w, kv, d)).astype(np.float32)
    want = np.asarray(jax_attention._ring_decode(
        jcfg, jnp.asarray(q), {"k": jnp.asarray(k), "v": jnp.asarray(v)},
        jnp.asarray(kv_len), window))
    tq, tk, tv = (torch.from_numpy(a) for a in (q, k, v))
    tl = torch.from_numpy(kv_len)
    through_k3 = attention.ring_decode_attention(tq, tk, tv, tl,
                                                 softcap=cfg.attn_softcap)
    plain = attention.ring_decode(cfg, tq, {"k": tk, "v": tv}, tl, window)
    np.testing.assert_allclose(through_k3.numpy(), want, atol=RING_ATOL)
    np.testing.assert_allclose(plain.numpy(), want, atol=RING_ATOL)


def test_long_decode_across_the_window():
    """Port analogue of the reference's ring-cache long-decode case: a
    12-token prompt (already past the window of 8) and 6 greedy steps, the
    logits equal to the reference's decode at every step and the last ones
    to its teacher-forced full forward."""
    cfg, jcfg = get_config(ARCH).reduced(), jax_get_config(ARCH).reduced()
    key = jax.random.PRNGKey(4)
    jparams = jax.tree.map(np.asarray, jax_api.init_params(jcfg, key,
                                                           jnp.float32))
    model = Transformer(cfg, torch.Generator())
    model.load_state_dict(from_jax_params(jparams))
    b, s, n_steps = 1, 12, 6
    toks = np.array(jax.random.randint(key, (b, s), 0, cfg.vocab_size))
    jl, jc = jax_transformer.lm_prefill(jcfg, jparams, jnp.asarray(toks),
                                        cache_len=s + n_steps)
    tl, tc = api.prefill(cfg, model, {"tokens": torch.from_numpy(toks).long()},
                         cache_len=s + n_steps)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=ATOL, rtol=RTOL)
    seq = toks
    for i in range(n_steps):
        nxt = np.array(jnp.argmax(jl[:, :cfg.vocab_size], -1))[:, None]
        assert np.array_equal(greedy(tl, cfg.vocab_size).numpy()[:, None], nxt)
        seq = np.concatenate([seq, nxt], axis=1)
        kv_len = np.full((b,), s + i, np.int32)
        jl, jc = jax_transformer.lm_decode_step(jcfg, jparams, jnp.asarray(nxt),
                                                jc, jnp.asarray(kv_len))
        tl, tc = api.decode_step(cfg, model, torch.from_numpy(nxt).long(), tc,
                                 torch.from_numpy(kv_len))
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=ATOL,
                                   rtol=RTOL)
    full, _ = jax_transformer.lm_forward(jcfg, jparams, jnp.asarray(seq))
    np.testing.assert_allclose(tl.numpy(), np.asarray(full[:, -1]),
                               atol=FORWARD_ATOL, rtol=FORWARD_ATOL)


def _jax_cli(capsys, monkeypatch, flags):
    monkeypatch.setattr("sys.argv", ["serve", "--arch", ARCH] + flags)
    jax_serve.main()
    printed = capsys.readouterr().out
    return (re.search(r"outputs_digest=(\w+)", printed).group(1),
            re.search(r"^monitor: (.*)$", printed, re.M).group(1),
            re.search(r"plan for production mesh: (\w+)", printed).group(1))


@pytest.mark.parametrize("mode", ["padded", "continuous"])
def test_serve_path_matches_jax(capsys, monkeypatch, init_weights, mode):
    """The reference's serve CLI with ``--arch gemma2-27b`` (reduced, its own
    init; ``--continuous`` too) and the port's serve path on the same
    weights and fitted predictor print the same outputs digest and monitor
    metrics; the port's CLI names the same production-mesh plan."""
    cfg, _, _, model = init_weights
    flags = ["--continuous"] if mode == "continuous" else []
    digest, monitor, jplan = _jax_cli(capsys, monkeypatch, flags)
    out = serve.serve(cfg, model, serve.make_requests(cfg, 12, 16),
                      _jax_predictor(cfg.vocab_size),
                      continuous=mode == "continuous")
    assert out["digest"] == digest
    assert str(out["monitor"].metrics()) == monitor
    assert len(out["outputs"]) == 12 and out["tokens"] > 0
    mine = serve.main(["--arch", ARCH, "--device", "cpu", "--requests", "3",
                       "--max-new", "4"] + flags)
    assert len(mine["outputs"]) == 3
    assert f"plan for production mesh: {jplan})" in capsys.readouterr().out


def test_paged_is_refused_as_in_the_reference(monkeypatch):
    ok, why = api.paged_compatible(get_config(ARCH))
    assert not ok and "ring cache" in why
    with pytest.raises(ValueError, match="ring cache"):
        serve.main(["--arch", ARCH, "--device", "cpu", "--paged"])
    monkeypatch.setattr("sys.argv", ["serve", "--arch", ARCH, "--paged"])
    with pytest.raises(ValueError, match="ring cache"):
        jax_serve.main()


def test_prefix_continuation_over_a_ring_raises(init_weights):
    cfg, _, _, model = init_weights
    kv = torch.zeros(1, 3, cfg.n_kv_heads, cfg.head_dim_eff)
    with pytest.raises(NotImplementedError, match="plain GQA cache"):
        api.prefill(cfg, model, {"tokens": torch.zeros(1, 4, dtype=torch.long)},
                    cache_len=8, prefix_kv=[{"k": kv, "v": kv}] * cfg.n_layers)


def test_n_layers_cuts_the_depth_and_keeps_the_pattern():
    """``serve.fit_depth`` (how gemma2-27b fits one card) keeps the width
    and cuts the depth to the deepest whole number of local/global pairs
    whose f32 weights fit; a model that fits keeps every layer, and a
    budget below one pair raises."""
    full = get_config(ARCH)
    f32 = {n: 4 * dataclasses.replace(full, n_layers=n).param_count()
           for n in (22, 24, 26)}
    for nbytes, want in ((f32[24], 24), (f32[26] - 1, 24), (f32[24] - 1, 22),
                         (4 * full.param_count(), 46)):
        cut = serve.fit_depth(full, nbytes)
        assert cut.n_layers == want
        assert cut.n_layers % full.window_pattern == 0
        assert (cut.d_model, cut.d_ff, cut.n_heads, cut.vocab_size) == \
            (full.d_model, full.d_ff, full.n_heads, full.vocab_size)
    assert serve.fit_depth(full, 4 * full.param_count()) is full
    two = 4 * dataclasses.replace(full, n_layers=2).param_count()
    assert serve.fit_depth(full, two).n_layers == full.window_pattern
    with pytest.raises(ValueError, match="one group period"):
        serve.fit_depth(full, two - 1)
