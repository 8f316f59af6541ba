"""The port's jamba-1.5-large-398b (the hybrid family: Mamba layers, one
attention layer in 8 with no positional encoding, a 16-expert top-2 MoE
MLP every other layer) against the JAX package on the CPU, on converted
weights (the attention kernels run their plain versions): the config,
its group period and parameter counts, the weights (f32 at 8 and 16
layers, bf16), the Mamba mixer's prefill (several chunks, T not a
multiple of the chunk, with and without ``kv_len``) and decode, the
blocks, prefill and decode logits, decode through the cache against the
reference's teacher-forced forward, the padded and continuous engines
token for token, the serve path's digest and plan, ``--paged`` refused as
the reference refuses it, all at the reduced size (8 layers, one group
period: d_model 64, d_inner 128, d_state 8); then the reduced model in
bf16, the reference's deployment dtype, against JAX's bf16 default
``init_params``.

The MoE layers route as in ``tests/test_torch_moe.py``: every f32
comparison of logits asserts the smallest router margin of its MoE
inputs above MARGIN, so that no near-tie could flip an expert between two
implementations."""
import dataclasses
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.core.types import Batch as JaxBatch
from repro.core.types import Request as JaxRequest
from repro.launch import serve as jax_serve
from repro.models import api as jax_api
from repro.models import attention as jax_attention
from repro.models import common as jax_common
from repro.models import mamba as jax_mamba
from repro.models import mlp as jax_mlp
from repro.models import moe as jax_moe
from repro.models import transformer as jax_transformer
from repro.serving import EngineConfig as JaxEngineConfig
from repro.serving import InferenceEngine as JaxInferenceEngine
from repro.serving.sampling import greedy as jax_greedy
from repro_torch.configs import get_config, group_period
from repro_torch.core.types import Batch, Request
from repro_torch.launch import serve
from repro_torch.models import api, attention, mamba, mlp, moe, transformer
from repro_torch.params import from_jax_params
from repro_torch.serving import EngineConfig, InferenceEngine
from repro_torch.serving.sampling import greedy
from test_torch_dense_archs import _jax_predictor, _plain, _ragged, _weights
from test_torch_llama4 import BF16_TOL, _bf16_close
from test_torch_moe import _stack_margin

ARCH = "jamba-1.5-large-398b"
ATOL = 5e-4                      # logits after the whole stack, f32
MIXER_ATOL = 1e-5                # one Mamba mixer or block, f32
MARGIN = 1e-6                    # f32: a flip needs the probabilities ~1e-7 apart
# the layer plan of one group period: attention at i % 8 == 4, MoE at odd i
PLAN = [("mamba", "dense"), ("mamba", "moe"), ("mamba", "dense"),
        ("mamba", "moe"), ("attn", "dense"), ("mamba", "moe"),
        ("mamba", "dense"), ("mamba", "moe")]


def _cfgs(n_layers=None, capacity_factor=None):
    """(port cfg, JAX cfg) at the reduced size (8 layers unless
    ``n_layers``), the MoE's capacity factor replaced if given."""
    cfg = get_config(ARCH).reduced(n_layers=n_layers)
    jcfg = jax_get_config(ARCH).reduced(n_layers=n_layers)
    if capacity_factor is not None:
        cfg, jcfg = (dataclasses.replace(c, moe=dataclasses.replace(
            c.moe, capacity_factor=capacity_factor)) for c in (cfg, jcfg))
    return cfg, jcfg


@pytest.fixture(scope="module")
def init_weights():
    """(cfg, JAX cfg, JAX params as the reference's serve CLI draws them,
    f32; port model carrying them)."""
    cfg, jcfg = _cfgs()
    return (cfg, jcfg, *_weights(cfg, jcfg))


@pytest.fixture(scope="module")
def perturbed():
    cfg, jcfg = _cfgs()
    return (cfg, jcfg, *_weights(cfg, jcfg, perturb_seed=3))


def _x(rng, *shape):
    return rng.standard_normal(shape).astype(np.float32)


def _layer(jparams, i, period=8):
    """Layer i's parameters of the reference's stacked tree."""
    return jax.tree.map(lambda a: a[i // period],
                        jparams["blocks"][f"l{i % period}"])


@pytest.mark.parametrize("reduced", [True, False])
def test_config_matches_jax(reduced):
    cfg, jcfg = get_config(ARCH), jax_get_config(ARCH)
    if reduced:
        cfg, jcfg = cfg.reduced(), jcfg.reduced()
    for f in dataclasses.fields(cfg):
        x, y = getattr(cfg, f.name), getattr(jcfg, f.name)
        if dataclasses.is_dataclass(x):
            assert dataclasses.asdict(x) == dataclasses.asdict(y), f.name
        else:
            assert x == y, f.name
    assert [(s.mixer, s.attn, s.mlp) for s in cfg.layer_plan()] == \
        [(s.mixer, s.attn, s.mlp) for s in jcfg.layer_plan()]
    assert [(s.mixer, s.mlp) for s in cfg.layer_plan()] == \
        PLAN * (cfg.n_layers // 8)
    assert group_period(cfg) == jax_transformer.group_period(jcfg) == 8
    for active in (False, True):
        assert cfg.param_count(active) == jcfg.param_count(active_only=active)
    for b, s in ((1, 16), (4, 1088), (128, 32_768)):
        assert cfg.kv_cache_bytes(b, s) == jcfg.kv_cache_bytes(b, s)
    if reduced:
        assert (cfg.n_layers, cfg.d_model, cfg.n_heads, cfg.n_kv_heads,
                cfg.head_dim_eff) == (8, 64, 4, 1, 16)
        assert (cfg.mamba.d_state, cfg.mamba.d_conv, cfg.mamba.expand) == \
            (8, 4, 2)
        assert (cfg.moe.n_experts, cfg.moe.top_k) == (4, 2)
        return
    # 397.49 G parameters (93.09 G active); one group period with the
    # embeddings 45.12 G (90.24 GB in bf16); the first five layers 23.98 G
    assert round(cfg.param_count() / 1e7) == 39749
    assert round(cfg.param_count(active_only=True) / 1e7) == 9309
    assert round(dataclasses.replace(cfg, n_layers=8).param_count() / 1e7) \
        == 4512
    five = dataclasses.replace(cfg, n_layers=5)
    assert round(five.param_count() / 1e7) == 2398
    assert five.param_count() == dataclasses.replace(jcfg, n_layers=5
                                                     ).param_count()
    assert cfg.padded_vocab == 65_536 and cfg.rope == "none"
    # a row's Mamba state: d_in x (d_state + d_conv) values a Mamba layer
    mc = cfg.mamba
    d_in = mc.expand * cfg.d_model
    n_mamba = sum(s.mixer == "mamba" for s in cfg.layer_plan())
    assert (n_mamba, d_in) == (63, 16_384)
    assert cfg.kv_cache_bytes(1, 0) == 2 * n_mamba * d_in * (mc.d_state
                                                             + mc.d_conv)


@pytest.mark.parametrize("n_layers", [8, 16])
def test_weights_load_from_jax(n_layers):
    """``from_jax_params`` loads the hybrid tree, layer ``g * 8 + i``
    taking group g's slice of ``l{i}``, the Mamba leaves included: one
    group period and two."""
    cfg, jcfg = _cfgs(n_layers)
    jparams, model = _weights(cfg, jcfg, perturb_seed=1)
    got, want = model.state_dict(), from_jax_params(jparams)
    assert set(got) == set(want)
    for k, v in want.items():
        assert torch.equal(got[k], v), k
    d_in, n = 2 * cfg.d_model, cfg.mamba.d_state
    shapes = {"in_proj.w": (cfg.d_model, 2 * d_in), "conv_w": (4, d_in),
              "conv_b": (d_in,), "bcdt_proj.w": (d_in, 2 * n + 1),
              "dt_bias": (d_in,), "a_log": (d_in, n), "d_skip": (d_in,),
              "out_proj.w": (d_in, cfg.d_model)}
    for name, shape in shapes.items():
        assert tuple(got[f"blocks.{n_layers - 1}.mixer.{name}"].shape) == shape
    assert "blocks.12.mixer.q.w" in got or n_layers == 8
    for i in range(n_layers):
        g, j = divmod(i, 8)
        leaf = "q" if i % 8 == 4 else "in_proj"
        np.testing.assert_array_equal(
            got[f"blocks.{i}.mixer.{leaf}.w"].numpy(),
            jparams["blocks"][f"l{j}"]["mixer"][leaf]["w"][g])
    fresh = api.init_params(cfg, seed=3, device="cpu")
    assert {k: tuple(v.shape) for k, v in fresh.state_dict().items()} == \
        {k: tuple(v.shape) for k, v in got.items()}


def test_bf16_weights_keep_the_reference_f32_leaves():
    """In bf16 (the reference's default draw) ``dt_bias``, ``a_log`` and
    ``d_skip`` stay f32, as the reference keeps them; every other leaf is
    bf16, and the loaded values equal JAX's."""
    cfg, jcfg = _cfgs()
    jparams, model = _bf16_weights_jamba(cfg, jcfg)
    f32 = {"dt_bias", "a_log", "d_skip"}
    for name, v in model.state_dict().items():
        want = torch.float32 if name.split(".")[-1] in f32 else torch.bfloat16
        assert v.dtype == want, name
    want = from_jax_params(jax.tree.map(
        lambda a: np.asarray(a.astype(jnp.float32)), jparams))
    for k, v in model.state_dict().items():
        assert torch.equal(v.float(), want[k]), k


def _bf16_weights_jamba(cfg, jcfg):
    """As ``_bf16_weights``, for the hybrid tree, whose Mamba keeps three
    f32 leaves."""
    jparams = jax_api.init_params(jcfg, jax.random.PRNGKey(0))
    assert {a.dtype for a in jax.tree.leaves(jparams)} == \
        {jnp.dtype("bfloat16"), jnp.dtype("float32")}
    tree = jax.tree.map(lambda a: np.asarray(a.astype(jnp.float32)), jparams)
    model = api.init_params(cfg, seed=0, dtype=torch.bfloat16, device="cpu")
    model.load_state_dict(from_jax_params(tree))
    return jparams, model


@pytest.mark.parametrize("with_kv_len", [True, False], ids=["kv_len", "full"])
def test_mamba_prefill_matches_jax(rng, perturbed, with_kv_len):
    """``mamba_prefill`` at T = 40 in chunks of 16 (three chunks, the last
    one short): the output, and the cache's conv tail and final state
    (the state at the padded end; the tail at each row's ``kv_len``,
    index 0 repeated for a row shorter than the tail)."""
    cfg, jcfg, jparams, model = perturbed
    b, t = 3, 40
    x = _x(rng, b, t, cfg.d_model)
    kv_len = np.array([40, 2, 23], np.int32) if with_kv_len else None
    p, jp = model.blocks[0].mixer, _layer(jparams, 0)["mixer"]
    y, cache = mamba.mamba_prefill(
        cfg, p, torch.from_numpy(x), cache_len=48, chunk=16,
        kv_len=None if kv_len is None else torch.from_numpy(kv_len))
    jy, jc = jax_mamba.mamba_prefill(
        jcfg, jp, jnp.asarray(x), cache_len=48, chunk=16,
        kv_len=None if kv_len is None else jnp.asarray(kv_len))
    np.testing.assert_allclose(y.numpy(), np.asarray(jy), atol=MIXER_ATOL)
    assert set(cache) == {"conv", "ssm"}
    assert cache["conv"].shape == (b, 3, 2 * cfg.d_model)
    assert cache["ssm"].shape == (b, 2 * cfg.d_model, cfg.mamba.d_state)
    assert cache["ssm"].dtype == torch.float32
    for key in ("conv", "ssm"):
        np.testing.assert_allclose(cache[key].numpy(), np.asarray(jc[key]),
                                   atol=MIXER_ATOL)
    # the chunk is a memory bound, not a semantic: one chunk gives the same
    whole, _ = mamba.mamba_prefill(cfg, p, torch.from_numpy(x), chunk=256)
    np.testing.assert_allclose(whole.numpy(), y.numpy(), atol=MIXER_ATOL)


def test_mamba_decode_matches_jax(rng, perturbed):
    """Four ``mamba_decode`` steps from a prefill's cache: outputs and the
    cache after each step."""
    cfg, jcfg, jparams, model = perturbed
    b = 3
    kv_len = np.array([9, 5, 1], np.int32)
    x = _x(rng, b, 9, cfg.d_model)
    p, jp = model.blocks[2].mixer, _layer(jparams, 2)["mixer"]
    _, cache = mamba.mamba_prefill(cfg, p, torch.from_numpy(x), cache_len=16,
                                   kv_len=torch.from_numpy(kv_len))
    _, jc = jax_mamba.mamba_prefill(jcfg, jp, jnp.asarray(x), cache_len=16,
                                    kv_len=jnp.asarray(kv_len))
    for _ in range(4):
        xt = _x(rng, b, 1, cfg.d_model)
        y, cache = mamba.mamba_decode(cfg, p, torch.from_numpy(xt), cache)
        jy, jc = jax_mamba.mamba_decode(jcfg, jp, jnp.asarray(xt), jc)
        assert y.shape == (b, 1, cfg.d_model)
        np.testing.assert_allclose(y.numpy(), np.asarray(jy), atol=MIXER_ATOL)
        for key in ("conv", "ssm"):
            np.testing.assert_allclose(cache[key].numpy(), np.asarray(jc[key]),
                                       atol=MIXER_ATOL)


@pytest.mark.parametrize("layer", [0, 1, 4])
def test_block_apply_matches_jax(rng, perturbed, layer):
    """The block, prefill then two decode steps: a Mamba block with a dense
    MLP (layer 0) and with the MoE (layer 1), and the attention block with
    no positional encoding (layer 4), caches included."""
    cfg, jcfg, jparams, model = perturbed
    spec, jspec = cfg.layer_plan()[layer], jcfg.layer_plan()[layer]
    b, t = 2, 9
    x = _x(rng, b, t, cfg.d_model)
    kv_len = np.array([9, 3], np.int32)
    pos = np.broadcast_to(np.arange(t), (b, t))
    y, c = transformer.block_apply(
        cfg, spec, model.blocks[layer], torch.from_numpy(x),
        positions=torch.from_numpy(pos.copy()), cache=None,
        kv_len=torch.from_numpy(kv_len), mode="prefill", cache_len=16)
    jy, jc, _ = jax_transformer.block_apply(
        jcfg, jspec, _layer(jparams, layer), jnp.asarray(x),
        positions=jnp.asarray(pos), plan=None, cache=None,
        kv_len=jnp.asarray(kv_len), mode="prefill", cache_len=16)
    np.testing.assert_allclose(y.numpy(), np.asarray(jy), atol=MIXER_ATOL)
    keys = ("k", "v") if spec.mixer == "attn" else ("conv", "ssm")
    assert set(c) == set(keys)

    def check(c, jc):
        for key in keys:
            np.testing.assert_allclose(c[key].numpy(),
                                       np.asarray(jc["mixer"][key]),
                                       atol=MIXER_ATOL)
    check(c, jc)
    for step in range(2):
        xt = _x(rng, b, 1, cfg.d_model)
        kl = kv_len + step
        y, c = transformer.block_apply(
            cfg, spec, model.blocks[layer], torch.from_numpy(xt),
            positions=None, cache=c, kv_len=torch.from_numpy(kl),
            mode="decode", cache_len=0)
        jy, jc, _ = jax_transformer.block_apply(
            jcfg, jspec, _layer(jparams, layer), jnp.asarray(xt),
            positions=None, plan=None, cache=jc, kv_len=jnp.asarray(kl),
            mode="decode", cache_len=0)
        np.testing.assert_allclose(y.numpy(), np.asarray(jy), atol=MIXER_ATOL)
        check(c, jc)


def test_prefill_and_decode_logits_match_jax(rng, perturbed):
    """Right-padded ragged batch on perturbed converted weights: last-valid
    prefill logits (the Mamba state runs over the padding, as in the
    reference) and three decode steps within ATOL."""
    cfg, jcfg, jparams, model = perturbed
    toks, kv_len = _ragged(rng, cfg, s=37)
    assert _stack_margin(cfg, model, toks) > MARGIN
    jl, jc = jax_api.prefill(jcfg, jparams, {"tokens": jnp.asarray(toks)},
                             cache_len=48, kv_len=jnp.asarray(kv_len))
    tl, tc = api.prefill(cfg, model, {"tokens": torch.from_numpy(toks).long()},
                         cache_len=48, kv_len=torch.from_numpy(kv_len))
    assert tl.shape == (3, cfg.padded_vocab)
    assert [set(c) for c in tc] == [{"k", "v"} if s.mixer == "attn"
                                    else {"conv", "ssm"}
                                    for s in cfg.layer_plan()]
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=ATOL)
    for step in range(3):
        nxt = np.array(jax_greedy(jl, jcfg.vocab_size))
        assert np.array_equal(greedy(tl, cfg.vocab_size).numpy(), nxt)
        jl, jc = jax_api.decode_step(jcfg, jparams, jnp.asarray(nxt)[:, None],
                                     jc, jnp.asarray(kv_len + step))
        tl, tc = api.decode_step(cfg, model,
                                 torch.from_numpy(nxt)[:, None].long(), tc,
                                 torch.from_numpy(kv_len + step))
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=ATOL)


def test_decode_matches_the_reference_forward():
    """The port's prefill and four greedy decode steps through its cache
    reproduce the reference's teacher-forced ``lm_forward`` on the whole
    sequence (the port's analogue of the reference's decode-vs-forward
    case for jamba: capacity factor 8, so that no token is dropped)."""
    cfg, jcfg = _cfgs(capacity_factor=8.0)
    jparams, model = _weights(cfg, jcfg, perturb_seed=4)
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
                               atol=ATOL, rtol=ATOL)


def _requests(cls, cfg):
    return [cls(rid=rid, tokens=list(t), input_len=len(t), slo=slo,
                arrival=arr, true_output_len=out)
            for rid, t, out, slo, arr in _plain(cfg)]


@pytest.mark.parametrize("mode", ["padded", "continuous"])
def test_engine_matches_jax(init_weights, mode):
    """The padded engine (``run_batch``, one batch of 4 and one of 3) and
    the continuous one (4 slots over 7 requests) give JAX's
    ``InferenceEngine`` outputs token for token, on the weights the
    reference's serve CLI draws."""
    cfg, jcfg, jparams, model = init_weights
    kw = dict(max_batch=4, cache_len=64, max_new_tokens=8)
    eng = InferenceEngine(cfg, model, EngineConfig(**kw))
    jeng = JaxInferenceEngine(jcfg, jparams, JaxEngineConfig(**kw))
    reqs, jreqs = _requests(Request, cfg), _requests(JaxRequest, cfg)
    if mode == "continuous":
        got, want = eng.run_continuous(reqs), jeng.run_continuous(jreqs)
        assert got.outputs == want.outputs and got.steps == want.steps
        return
    for lo, hi in ((0, 4), (4, 7)):
        tl = {r.rid: r.true_output_len for r in reqs[lo:hi]}
        got = eng.run_batch(Batch(requests=reqs[lo:hi]), true_lens=tl)
        want = jeng.run_batch(JaxBatch(requests=jreqs[lo:hi]), true_lens=tl)
        assert got.outputs == want.outputs and got.outputs
        assert got.steps == want.steps


def _jax_cli(capsys, monkeypatch, *flags):
    """(digest, monitor line, plan) printed by the reference's serve CLI."""
    monkeypatch.setattr("sys.argv", ["serve", "--arch", ARCH, *flags])
    jax_serve.main()
    printed = capsys.readouterr().out
    return (re.search(r"outputs_digest=(\w+)", printed).group(1),
            re.search(r"^monitor: (.*)$", printed, re.M).group(1),
            re.search(r"plan for production mesh: (\w+)", printed).group(1))


@pytest.mark.parametrize("mode", ["padded", "continuous"])
def test_serve_path_matches_jax(capsys, monkeypatch, init_weights, mode):
    """The reference's serve CLI with ``--arch jamba-1.5-large-398b``
    (reduced, its own f32 init; ``--continuous`` too) and the port's serve
    path on the same weights and fitted predictor print the same outputs
    digest and monitor metrics; both name ``ep16_tp16`` as the
    production-mesh plan, and the port's CLI serves on the CPU."""
    cfg, _, _, model = init_weights
    flags = ["--continuous"] if mode == "continuous" else []
    digest, monitor, jplan = _jax_cli(capsys, monkeypatch, *flags)
    out = serve.serve(cfg, model, serve.make_requests(cfg, 12, 16),
                      _jax_predictor(cfg.vocab_size),
                      continuous=mode == "continuous")
    assert out["digest"] == digest
    assert str(out["monitor"].metrics()) == monitor
    assert jplan == "ep16_tp16"
    mine = serve.main(["--arch", ARCH, "--device", "cpu", "--requests", "3",
                       "--max-new", "4", *flags])
    assert len(mine["outputs"]) == 3
    assert f"plan for production mesh: {jplan})" in capsys.readouterr().out


def test_paged_and_prefix_continuation_raise_as_in_the_reference(
        monkeypatch, init_weights):
    """``--paged`` raises the reference's ``ValueError`` (the Mamba state is
    recurrent, not a KV cache) in both CLIs, and a prefix-continuation
    prefill raises ``NotImplementedError`` in the Mamba block, as in the
    reference."""
    cfg, jcfg, _, model = init_weights
    assert api.paged_compatible(cfg) == jax_api.paged_compatible(jcfg) == \
        (False, "mamba state is recurrent, not a KV cache")
    msg = re.escape(f"{cfg.name} cannot serve paged: mamba state is recurrent")
    with pytest.raises(ValueError, match=msg):
        serve.main(["--arch", ARCH, "--device", "cpu", "--paged",
                    "--requests", "2"])
    monkeypatch.setattr("sys.argv", ["serve", "--arch", ARCH, "--paged",
                                     "--requests", "2"])
    with pytest.raises(ValueError, match=msg):
        jax_serve.main()
    spec = cfg.layer_plan()[0]
    with pytest.raises(NotImplementedError, match="mamba state is recurrent"):
        transformer.block_apply(cfg, spec, model.blocks[0],
                                torch.zeros(1, 4, cfg.d_model), positions=None,
                                cache={"conv": None}, kv_len=None,
                                mode="prefill", cache_len=8)


def _t(a):
    """A JAX bf16 array as a torch bf16 tensor (through f32: exact)."""
    return torch.from_numpy(np.array(a.astype(jnp.float32))).bfloat16()


def _bf16_stack(cfg, jcfg, jparams, model, x, kv_len, caches, mode):
    """Both stacks' parts on the JAX stack's own bf16 values: in each layer
    the port's norms, mixer (with its own cache) and MLP or MoE take JAX's
    input to the same part.  Returns (the largest error of a part's output
    as a share of its tolerance, BF16_TOL x its largest value; JAX's last
    hidden state; the port's and JAX's new caches)."""
    worst, new = 0.0, ([], [])
    pos = None if mode == "decode" else \
        np.broadcast_to(np.arange(x.shape[1]), x.shape[:2]).copy()
    tkl, jkl = torch.from_numpy(kv_len), jnp.asarray(kv_len)

    def close(got, want):
        want = np.asarray(want.astype(jnp.float32))
        assert got.dtype == torch.bfloat16
        return _bf16_close(got.float().numpy(), want) \
            / (BF16_TOL * np.abs(want).max())

    for i, (spec, jspec) in enumerate(zip(cfg.layer_plan(), jcfg.layer_plan())):
        p, jp = model.blocks[i], _layer(jparams, i)
        c, jc = (caches[0][i], caches[1][i]["mixer"]) if caches else (None, None)
        h = jax_common.apply_norm(jcfg, jp["norm1"], x)
        worst = max(worst, close(transformer.apply_norm(cfg, p.norm1, _t(x)), h))
        if spec.mixer == "attn" and mode == "decode":
            mx, c = attention.attn_decode(cfg, spec, p.mixer, _t(h), c, tkl)
            jmx, jc = jax_attention.attn_decode(jcfg, jspec, jp["mixer"], h, jc,
                                                jkl, plan=None)
        elif spec.mixer == "attn":
            mx, c = attention.attn_prefill(cfg, spec, p.mixer, _t(h),
                                           positions=torch.from_numpy(pos),
                                           cache_len=32, kv_len=tkl)
            jmx, jc = jax_attention.attn_prefill(
                jcfg, jspec, jp["mixer"], h, positions=jnp.asarray(pos),
                plan=None, cache_len=32, kv_len=jkl)
        elif mode == "decode":
            mx, c = mamba.mamba_decode(cfg, p.mixer, _t(h), c)
            jmx, jc = jax_mamba.mamba_decode(jcfg, jp["mixer"], h, jc)
        else:
            mx, c = mamba.mamba_prefill(cfg, p.mixer, _t(h), cache_len=32,
                                        kv_len=tkl)
            jmx, jc = jax_mamba.mamba_prefill(jcfg, jp["mixer"], h,
                                              cache_len=32, kv_len=jkl)
        worst = max(worst, close(mx, jmx))
        x = x + jmx
        h2 = jax_common.apply_norm(jcfg, jp["norm2"], x)
        worst = max(worst, close(transformer.apply_norm(cfg, p.norm2, _t(x)),
                                 h2))
        if spec.mlp == "moe":
            my, _ = moe.moe_apply(cfg, p.mlp, _t(h2))
            jmy, _ = jax_moe.moe_apply(jcfg, jp["mlp"], h2)
        else:
            my, jmy = mlp.mlp_apply(cfg, p.mlp, _t(h2)), \
                jax_mlp.mlp_apply(jcfg, jp["mlp"], h2)
        worst = max(worst, close(my, jmy))
        x = x + jmy
        new[0].append(c)
        new[1].append({"mixer": jc})
    return worst, x, new


def test_bf16_logits_match_jax(rng):
    """The reduced model in bf16 on the reference's own bf16 draw, part by
    part: each norm, mixer (with its own cache) and MLP or MoE of the port
    takes the JAX stack's bf16 input to the same part, and its output, the
    prefill logits of the last valid rows (fp32 from the bf16 head), three
    decode steps' logits and the caches are held to BF16_TOL x their
    largest value against JAX's; the conv tails in bf16, the Mamba states
    in f32, as in the reference.

    Part by part, not the two stacks free-running: the reduced routers are
    near-uniform (4 experts), so bf16 router logits tie or lie within an
    ulp, and a difference of one ulp in a MoE's input (the mixers round in
    other orders) can give a token other experts in the two stacks; the
    Mamba state then carries that token's difference into every later
    position of its row (the free-running error is printed, not held)."""
    cfg, jcfg = _cfgs()
    jparams, model = _bf16_weights_jamba(cfg, jcfg)
    toks, kv_len = _ragged(rng, cfg, s=23)
    jl, jc = jax_api.prefill(jcfg, jparams, {"tokens": jnp.asarray(toks)},
                             cache_len=32, kv_len=jnp.asarray(kv_len))
    tl, tc = api.prefill(cfg, model, {"tokens": torch.from_numpy(toks).long()},
                         cache_len=32, kv_len=torch.from_numpy(kv_len))
    assert tl.dtype == torch.float32 and jl.dtype == jnp.float32
    assert {c["conv"].dtype for c in tc if "conv" in c} == {torch.bfloat16}
    assert {c["ssm"].dtype for c in tc if "ssm" in c} == {torch.float32}
    assert tc[4]["k"].dtype == torch.bfloat16
    free = float(np.abs(tl.numpy() - np.asarray(jl)).max())
    print(f"bf16 free-running stacks: prefill logits max abs err {free:.3e} "
          f"(max |logit| {float(np.abs(np.asarray(jl)).max()):.3f}); smallest "
          f"router margin {_stack_margin(cfg, model, toks):.3e}")

    def heads(x, kl=None):
        """(The port's, JAX's) final norm and head on JAX's hidden state x,
        at each row's last valid position."""
        h = transformer.apply_norm(cfg, model.final_norm, _t(x))
        rows = transformer.last_valid(h, None if kl is None
                                      else torch.from_numpy(kl))
        jh = jax_common.apply_norm(jcfg, jparams["final_norm"], x)
        jrows = jh[:, -1] if kl is None else \
            jh[jnp.arange(jh.shape[0]), jnp.asarray(kl) - 1]
        return (transformer.lm_head(cfg, model, rows).numpy(),
                jax_transformer.lm_head(jcfg, jparams, jrows))

    x = jax_transformer.embed_tokens(jcfg, jparams, jnp.asarray(toks))
    worst, x, caches = _bf16_stack(cfg, jcfg, jparams, model, x, kv_len, None,
                                   "prefill")
    got, jl = heads(x, kv_len)
    assert jl.dtype == jnp.float32
    errs = [_bf16_close(got, np.asarray(jl))]
    for step in range(3):
        nxt = np.array(jax_greedy(jl, jcfg.vocab_size))
        x = jax_transformer.embed_tokens(jcfg, jparams, jnp.asarray(nxt)[:, None])
        w, x, caches = _bf16_stack(cfg, jcfg, jparams, model, x,
                                   kv_len + step, caches, "decode")
        worst = max(worst, w)
        got, jl = heads(x)
        errs.append(_bf16_close(got, np.asarray(jl)))
    for c, jcache in zip(*caches):
        for key, val in c.items():
            _bf16_close(val.float().numpy(),
                        np.asarray(jcache["mixer"][key].astype(jnp.float32)))
    print(f"bf16 part by part: logits max abs err prefill {errs[0]:.3e}, "
          f"decode {max(errs[1:]):.3e}; the largest part's error "
          f"{worst:.3f} of its tolerance")
