"""The port's qwen2-vl-7b (multimodal RoPE over three position streams, 28
query heads over 4 KV heads, the vision stub's embedding input) against the
JAX package on the CPU, on converted weights (f32; the attention kernels
run their plain versions): ``apply_mrope`` on distinct temporal, height and
width positions and, at text positions, its equality with ``apply_rope``;
the config; prefill and decode logits on a padded ragged batch, from
tokens and from embeddings, and the multi-stream positions through the
whole stack; the padded and ``--paged`` serve paths' digests and monitor
lines against the JAX CLI's."""
import ast
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
from repro.models import common as jax_common
from repro.models import transformer as jax_transformer
from repro.serving.sampling import greedy as jax_greedy
from repro_torch.configs import get_config
from repro_torch.launch import serve
from repro_torch.models import api, common
from repro_torch.models import transformer as T
from repro_torch.serving.sampling import greedy
from test_torch_dense_archs import _jax_predictor, _ragged, _weights

ARCH = "qwen2-vl-7b"
ROPE_ATOL = 1e-5                 # one rotation, f32 angles
ATOL = 1e-4                      # logits after the whole stack, f32
# the paged engine's monitor histograms of wall-clock seconds
CLOCKED_METRICS = ("queue_wait", "ttft", "itl", "e2e")


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """The paged serve path's monitor judges SLOs on the wall clock; under
    the parallel test run the workers' intra-op thread pools oversubscribe
    the cores and slow its small torch ops many times over, past a
    request's deadline.  One thread per worker here, restored after."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def init_weights():
    cfg, jcfg = get_config(ARCH).reduced(), jax_get_config(ARCH).reduced()
    return (cfg, jcfg, *_weights(cfg, jcfg))


# name -> (B, S, H, D, sections, theta): the reduced config's and the
# published head layout's sections
MROPE_CASES = {
    "reduced": (2, 7, 4, 16, (2, 3, 3), 1e6),
    "published": (2, 5, 3, 128, (16, 24, 24), 1e6),
}


@pytest.mark.parametrize("case", list(MROPE_CASES))
def test_apply_mrope_matches_jax(rng, case):
    """Three genuinely distinct position streams (t, h, w drawn apart, as
    an image's patches have them)."""
    b, s, h, d, sections, theta = MROPE_CASES[case]
    x = rng.standard_normal((b, s, h, d)).astype(np.float32)
    pos3 = np.stack([rng.integers(0, 4000, (b, s)) for _ in range(3)]
                    ).astype(np.int32)
    assert not np.array_equal(pos3[0], pos3[1])
    want = jax_common.apply_mrope(jnp.asarray(x), jnp.asarray(pos3), theta,
                                  sections)
    got = common.apply_mrope(torch.from_numpy(x), torch.from_numpy(pos3),
                             theta, sections)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ROPE_ATOL)
    with pytest.raises(ValueError, match="sections"):
        common.apply_mrope(torch.from_numpy(x), torch.from_numpy(pos3), theta,
                           (1, 1, 1))


@pytest.mark.parametrize("case", list(MROPE_CASES))
def test_apply_mrope_at_text_positions_is_rope(rng, case):
    """t = h = w (the text mode's positions): M-RoPE is plain RoPE, in the
    port as in the reference."""
    b, s, h, d, sections, theta = MROPE_CASES[case]
    x = torch.from_numpy(rng.standard_normal((b, s, h, d)).astype(np.float32))
    pos = torch.from_numpy(rng.integers(0, 4000, (b, s)).astype(np.int32))
    got = common.apply_mrope(x, pos.expand(3, b, s), theta, sections)
    np.testing.assert_allclose(got.numpy(),
                               common.apply_rope(x, pos, theta).numpy(),
                               atol=ROPE_ATOL)
    want = jax_common.apply_rope(jnp.asarray(x.numpy()),
                                 jnp.asarray(pos.numpy()), theta)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ROPE_ATOL)


@pytest.mark.parametrize("reduced", [True, False])
def test_config_matches_jax(reduced):
    cfg, jcfg = get_config(ARCH), jax_get_config(ARCH)
    if reduced:
        cfg, jcfg = cfg.reduced(), jcfg.reduced()
    for f in dataclasses.fields(cfg):
        assert getattr(cfg, f.name) == getattr(jcfg, f.name), f.name
    assert [(s.mixer, s.attn, s.mlp) for s in cfg.layer_plan()] == \
        [(s.mixer, s.attn, s.mlp) for s in jcfg.layer_plan()]
    assert cfg.param_count() == jcfg.param_count()
    for b, s in ((1, 16), (4, 1088)):
        assert cfg.kv_cache_bytes(b, s) == jcfg.kv_cache_bytes(b, s)
    assert sum(cfg.mrope_sections) == cfg.head_dim_eff // 2
    assert (cfg.rope, cfg.frontend) == ("mrope", "vision_stub")
    if not reduced:
        # 7.62 G parameters: 30.46 GB of f32 weights; group 7 at D = 128
        assert round(cfg.param_count() / 1e7) == 762
        assert (cfg.n_heads, cfg.n_kv_heads, cfg.head_dim_eff) == (28, 4, 128)


def test_default_positions_match_jax():
    cfg, jcfg = get_config(ARCH).reduced(), jax_get_config(ARCH).reduced()
    got = T.default_positions(cfg, 2, 5, 3)
    assert tuple(got.shape) == (3, 2, 5)
    np.testing.assert_array_equal(
        got.numpy(), np.asarray(jax_transformer.default_positions(jcfg, 2, 5, 3)))


@pytest.mark.parametrize("source", ["tokens", "embeds"])
def test_prefill_and_decode_logits_match_jax(rng, source):
    """Right-padded ragged batch on perturbed converted weights: last-valid
    prefill logits and three decode steps (the decode positions broadcast
    to the three streams) within ATOL; ``embeds``: the prefill takes the
    vision stub's embeddings [B, S, d] in place of the tokens'."""
    cfg, jcfg = get_config(ARCH).reduced(), jax_get_config(ARCH).reduced()
    jparams, model = _weights(cfg, jcfg, perturb_seed=1)
    toks, kv_len = _ragged(rng, cfg)
    batch, jbatch = {"tokens": torch.from_numpy(toks).long()}, \
        {"tokens": jnp.asarray(toks)}
    if source == "embeds":
        emb = rng.standard_normal(toks.shape + (cfg.d_model,)).astype(np.float32)
        batch["embeds"], jbatch["embeds"] = torch.from_numpy(emb), \
            jnp.asarray(emb)
    jl, jc = jax_api.prefill(jcfg, jparams, jbatch, cache_len=24,
                             kv_len=jnp.asarray(kv_len))
    tl, tc = api.prefill(cfg, model, batch, cache_len=24,
                         kv_len=torch.from_numpy(kv_len))
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=ATOL)
    if source == "embeds":
        plain, _ = api.prefill(cfg, model, {"tokens": batch["tokens"]},
                               cache_len=24, kv_len=torch.from_numpy(kv_len))
        assert not np.allclose(plain.numpy(), tl.numpy())
    for step in range(3):
        nxt = np.array(jax_greedy(jl, jcfg.vocab_size))
        assert np.array_equal(greedy(tl, cfg.vocab_size).numpy(), nxt)
        jl, jc = jax_api.decode_step(jcfg, jparams, jnp.asarray(nxt)[:, None],
                                     jc, jnp.asarray(kv_len + step))
        tl, tc = api.decode_step(cfg, model, torch.from_numpy(nxt)[:, None].long(),
                                 tc, torch.from_numpy(kv_len + step))
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=ATOL)


def test_forward_with_distinct_streams_matches_jax(rng):
    """The stack's attention with genuinely distinct t/h/w positions: the
    port's prefill at given [3, B, S] positions against the reference's
    ``lm_forward`` at the same ones (last position's logits)."""
    cfg, jcfg = get_config(ARCH).reduced(), jax_get_config(ARCH).reduced()
    jparams, model = _weights(cfg, jcfg, perturb_seed=5)
    b, s = 2, 9
    toks = rng.integers(0, cfg.vocab_size, (b, s)).astype(np.int32)
    pos3 = np.stack([np.sort(rng.integers(0, 64, (b, s)), axis=-1)
                     for _ in range(3)]).astype(np.int32)
    full, _ = jax_transformer.lm_forward(jcfg, jparams, jnp.asarray(toks),
                                         positions=jnp.asarray(pos3))
    x = T.embed_tokens(cfg, model, torch.from_numpy(toks).long())
    x, _ = T.apply_stack(cfg, model, x, positions=torch.from_numpy(pos3),
                         mode="prefill")
    got = T.lm_head(cfg, model, common.apply_norm(cfg, model.final_norm, x))
    np.testing.assert_allclose(got.numpy(), np.asarray(full), atol=ATOL)


def _jax_cli(capsys, monkeypatch, flags):
    monkeypatch.setattr("sys.argv", ["serve", "--arch", ARCH] + flags)
    jax_serve.main()
    printed = capsys.readouterr().out
    return (re.search(r"outputs_digest=(\w+)", printed).group(1),
            re.search(r"^monitor: (.*)$", printed, re.M).group(1),
            re.search(r"plan for production mesh: (\w+)", printed).group(1))


@pytest.mark.parametrize("mode", ["padded", "paged"])
def test_serve_path_matches_jax(capsys, monkeypatch, init_weights, mode):
    """The reference's serve CLI with ``--arch qwen2-vl-7b`` (reduced, its
    own init; ``--paged`` too, at its default 2e6-byte pool) and the port's
    serve path on the same weights and fitted predictor print the same
    outputs digest and monitor metrics (on the paged path, the wall-clock
    histograms by their counts only); the port's CLI serves the same flags
    and names the same production-mesh plan."""
    cfg, _, _, model = init_weights
    flags = ["--paged"] if mode == "paged" else []
    digest, monitor, jplan = _jax_cli(capsys, monkeypatch, flags)
    reqs = serve.make_requests(cfg, 12, 16)
    paged = serve.paged_config(cfg, reqs, 16, 2e6) if mode == "paged" else None
    out = serve.serve(cfg, model, reqs, _jax_predictor(cfg.vocab_size),
                      paged=paged)
    assert out["digest"] == digest
    got, want = str(out["monitor"].metrics()), monitor
    if mode == "paged":
        got, want = ast.literal_eval(got), ast.literal_eval(want)
        for key in CLOCKED_METRICS:
            assert got.pop(key)["count"] == want.pop(key)["count"]
    assert got == want
    assert len(out["outputs"]) == 12 and out["tokens"] > 0
    mine = serve.main(["--arch", ARCH, "--device", "cpu", "--requests", "3",
                       "--max-new", "4"] + flags)
    assert len(mine["outputs"]) == 3
    assert f"plan for production mesh: {jplan})" in capsys.readouterr().out
