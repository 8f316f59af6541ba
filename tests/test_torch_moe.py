"""The port's qwen2-moe-a2.7b (60 routed experts, top-4, 4 shared experts,
capacity-dropping dispatch) against the JAX package on the CPU, on
converted weights (f32; the attention kernels run their plain versions):
the config and its layer plan and parameter counts, the MoE block alone
(outputs, aux metrics and the experts each token picks) with and without
drops, at one token and at a verify window's shape, prefill and decode
logits on a padded ragged batch, the padded and ``--continuous`` serve
paths' digests and monitor lines against the JAX CLI's, and the paged
engine token for token against the JAX ``PagedEngine``.

A near-tie between a token's k-th and (k+1)-th router probability could
flip an expert between two implementations, so every MoE comparison
asserts the smallest such margin of its inputs beside it (MARGIN)."""
import dataclasses
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import SHAPES as JAX_SHAPES
from repro.configs import get_config as jax_get_config
from repro.core import deployer as jax_deployer
from repro.core.types import Request as JaxRequest
from repro.launch import serve as jax_serve
from repro.models import api as jax_api
from repro.models import moe as jax_moe
from repro.serving import PagedEngine as JaxPagedEngine
from repro.serving import PagedEngineConfig as JaxPagedEngineConfig
from repro.serving.sampling import greedy as jax_greedy
from repro_torch.configs import SHAPES, get_config
from repro_torch.core import deployer
from repro_torch.core.types import Request
from repro_torch.launch import serve
from repro_torch.models import api, moe
from repro_torch.params import from_jax_params
from repro_torch.serving import PagedEngine, PagedEngineConfig
from repro_torch.serving.sampling import greedy
from test_torch_dense_archs import (CLOCKED, _jax_predictor, _plain, _ragged,
                                    _templates, _weights)

ARCH = "qwen2-moe-a2.7b"
MOE_ATOL = 1e-5                  # the MoE block's outputs and aux, f32
ATOL = 1e-4                      # logits after the whole stack, f32
MARGIN = 1e-6                    # a flip needs the probabilities ~1e-7 apart


def _cfgs(layout="reduced"):
    """(port cfg, JAX cfg): the reduced config (4 experts, top-2, 1 shared),
    or ("published") a narrow one with the published routing: 60 experts,
    top-4, 4 shared ones, d_model 64, experts of 32 units."""
    cfg, jcfg = get_config(ARCH).reduced(), jax_get_config(ARCH).reduced()
    if layout == "published":
        cfg, jcfg = (dataclasses.replace(c, moe=dataclasses.replace(
            c.moe, n_experts=60, top_k=4, n_shared_experts=4, d_expert=32,
            d_shared=32)) for c in (cfg, jcfg))
    return cfg, jcfg


@pytest.fixture(scope="module")
def init_weights():
    cfg, jcfg = _cfgs()
    return (cfg, jcfg, *_weights(cfg, jcfg))


def _same_fields(a, b):
    """Dataclass fields of a port config equal to the JAX one's, nested
    configs (``moe``) field by field."""
    for f in dataclasses.fields(a):
        x, y = getattr(a, f.name), getattr(b, f.name)
        if dataclasses.is_dataclass(x):
            assert dataclasses.asdict(x) == dataclasses.asdict(y), f.name
        else:
            assert x == y, f.name


@pytest.mark.parametrize("reduced", [True, False])
def test_config_matches_jax(reduced):
    cfg, jcfg = get_config(ARCH), jax_get_config(ARCH)
    if reduced:
        cfg, jcfg = cfg.reduced(), jcfg.reduced()
    _same_fields(cfg, jcfg)
    assert cfg.moe.d_shared_eff == jcfg.moe.d_shared_eff
    assert [(s.mixer, s.attn, s.mlp) for s in cfg.layer_plan()] == \
        [(s.mixer, s.attn, s.mlp) for s in jcfg.layer_plan()]
    assert all(s.mlp == "moe" for s in cfg.layer_plan())
    for active in (False, True):
        assert cfg.param_count(active) == jcfg.param_count(active_only=active)
    for b, s in ((1, 16), (4, 1088), (128, 32_768)):
        assert cfg.kv_cache_bytes(b, s) == jcfg.kv_cache_bytes(b, s)
    if reduced:
        assert (cfg.moe.n_experts, cfg.moe.top_k, cfg.moe.n_shared_experts,
                cfg.n_layers) == (4, 2, 1, 2)
    else:
        # 14.31 G parameters (2.69 G active): 57.25 GB of f32 weights
        assert round(cfg.param_count() / 1e7) == 1431
        assert round(cfg.param_count(active_only=True) / 1e7) == 269
        assert cfg.moe.capacity_factor == 1.25


def test_init_params_shapes_and_seeding(init_weights):
    cfg, _, jparams, _ = init_weights
    fresh = api.init_params(cfg, seed=3, device="cpu").state_dict()
    conv = from_jax_params(jparams)
    assert {k: tuple(v.shape) for k, v in fresh.items()} == \
        {k: tuple(v.shape) for k, v in conv.items()}
    m, d = cfg.moe, cfg.d_model
    assert tuple(fresh["blocks.1.mlp.up"].shape) == (m.n_experts, d, m.d_expert)
    assert tuple(fresh["blocks.0.mlp.down"].shape) == (m.n_experts, m.d_expert, d)
    assert tuple(fresh["blocks.0.mlp.router.w"].shape) == (d, m.n_experts)
    assert "blocks.0.mlp.shared_0.gate.w" in fresh
    again = api.init_params(cfg, seed=3, device="cpu").state_dict()
    assert all(torch.equal(fresh[k], again[k]) for k in fresh)
    # the reference's accounting leaves the routers out
    assert sum(v.numel() for k, v in fresh.items() if not k.endswith(".b")) \
        == cfg.param_count() + cfg.n_layers * d * m.n_experts
    # the reference's scales: router 0.02, up d^-0.5, down f^-0.5
    for name, std in (("router.w", 0.02), ("up", d ** -0.5),
                      ("down", m.d_expert ** -0.5)):
        assert fresh[f"blocks.0.mlp.{name}"].std().item() == \
            pytest.approx(std, rel=0.1)


# name -> (layout, x shape, offset of the tokens' shared direction): the
# shared direction skews the router, so capacity binds ("drops"); at most 8
# tokens capacity is every token ("no_drop", "t1"); a verify window of 4
# sequences x 5 positions
MOE_CASES = {
    "no_drop": ("reduced", (2, 4), 0.0),
    "drops": ("reduced", (3, 11), 2.0),
    "t1": ("reduced", (1, 1), 0.0),
    "verify_window": ("reduced", (4, 5), 2.0),
    "published_drops": ("published", (2, 40), 2.0),
}


@pytest.mark.parametrize("case", list(MOE_CASES))
def test_moe_apply_matches_jax(case):
    """``moe_apply`` of layer 0 against the reference's on the same numpy
    input: output and ``lb_loss`` / ``drop_frac`` within MOE_ATOL, and the
    same top-k experts for every token (through ``moe.route``), with the
    router margin above MARGIN."""
    layout, (b, s), shift = MOE_CASES[case]
    cfg, jcfg = _cfgs(layout)
    jparams, model = _weights(cfg, jcfg, perturb_seed=2)
    rng = np.random.default_rng(7)
    x = rng.standard_normal((b, s, cfg.d_model)).astype(np.float32) \
        + shift * rng.standard_normal(cfg.d_model).astype(np.float32)
    jp = jax.tree.map(lambda a: a[0], jparams["blocks"]["l0"]["mlp"])
    jy, jaux = jax_moe.moe_apply(jcfg, jp, jnp.asarray(x))
    p = model.blocks[0].mlp
    y, aux = moe.moe_apply(cfg, p, torch.from_numpy(x))
    margin = moe.router_margin(cfg, p, torch.from_numpy(x))
    assert margin > MARGIN, margin
    np.testing.assert_allclose(y.numpy(), np.asarray(jy), atol=MOE_ATOL)
    for key in ("lb_loss", "drop_frac"):
        assert aux[key].item() == pytest.approx(float(jaux[key]), abs=MOE_ATOL)
    xf = x.reshape(-1, cfg.d_model)
    jprobs = jax.nn.softmax((xf @ jp["router"]["w"]).astype(jnp.float32), -1)
    _, jids = jax.lax.top_k(jprobs, cfg.moe.top_k)
    _, _, ids = moe.route(cfg, p, torch.from_numpy(xf))
    assert np.array_equal(ids.numpy(), np.asarray(jids))
    if case in ("no_drop", "t1"):
        assert moe.expert_capacity(cfg, b * s) == b * s
        assert aux["drop_frac"].item() == 0.0
    if case in ("drops", "published_drops"):
        assert aux["drop_frac"].item() > 0.0


def _stack_margin(cfg, model, toks):
    """The smallest router margin over every MoE layer's input of a prefill
    of ``toks`` (recorded through ``moe.moe_apply``)."""
    seen, apply = [], moe.moe_apply

    def record(cfg_, p, x, **kw):
        seen.append(moe.router_margin(cfg_, p, x))
        return apply(cfg_, p, x, **kw)
    moe.moe_apply = record
    try:
        api.prefill(cfg, model, {"tokens": torch.from_numpy(toks).long()},
                    cache_len=24)
    finally:
        moe.moe_apply = apply
    return min(seen)


@pytest.mark.parametrize("arch", ["qwen2-moe-a2.7b", "jamba-1.5-large-398b"])
def test_router_ties_rank_the_lower_expert_first(arch):
    """Two experts whose router columns are equal get equal probabilities
    for every token; ``moe.route`` then ranks the lower expert id first,
    as the reference's ``lax.top_k`` does (top-4 of 4 experts and top-2,
    each with a tie at the top and one across the cut)."""
    cfg = get_config(arch).reduced()
    model = api.init_params(cfg, seed=0, device="cpu")
    p = next(b.mlp for b, sp in zip(model.blocks, cfg.layer_plan())
             if sp.mlp == "moe")
    x = torch.randn(64, cfg.d_model, generator=torch.Generator().manual_seed(2))
    for a, b in ((0, 3), (2, 1)):
        with torch.no_grad():
            p.router.w[:, b] = p.router.w[:, a]
        probs, gates, ids = moe.route(cfg, p, x)
        assert torch.equal(probs[:, a], probs[:, b])
        _, jids = jax.lax.top_k(jnp.asarray(probs.numpy()), cfg.moe.top_k)
        assert np.array_equal(ids.numpy(), np.asarray(jids))
        assert torch.allclose(gates.sum(-1), torch.ones(64))


@pytest.mark.parametrize("layout", ["reduced", "published"])
def test_prefill_and_decode_logits_match_jax(rng, layout):
    """Right-padded ragged batch on perturbed converted weights: last-valid
    prefill logits (the padding's tokens take expert slots, as in the
    reference) and three decode steps within ATOL."""
    cfg, jcfg = _cfgs(layout)
    jparams, model = _weights(cfg, jcfg, perturb_seed=1)
    toks, kv_len = _ragged(rng, cfg)
    assert _stack_margin(cfg, model, toks) > MARGIN
    jl, jc = jax_api.prefill(jcfg, jparams, {"tokens": jnp.asarray(toks)},
                             cache_len=24, kv_len=jnp.asarray(kv_len))
    tl, tc = api.prefill(cfg, model, {"tokens": torch.from_numpy(toks).long()},
                         cache_len=24, kv_len=torch.from_numpy(kv_len))
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=ATOL)
    for step in range(3):
        nxt = np.array(jax_greedy(jl, jcfg.vocab_size))
        assert np.array_equal(greedy(tl, cfg.vocab_size).numpy(), nxt)
        jl, jc = jax_api.decode_step(jcfg, jparams, jnp.asarray(nxt)[:, None],
                                     jc, jnp.asarray(kv_len + step))
        tl, tc = api.decode_step(cfg, model, torch.from_numpy(nxt)[:, None].long(),
                                 tc, torch.from_numpy(kv_len + step))
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=ATOL)


def _jax_cli(capsys, monkeypatch, flags):
    monkeypatch.setattr("sys.argv", ["serve", "--arch", ARCH] + flags)
    jax_serve.main()
    printed = capsys.readouterr().out
    return (re.search(r"outputs_digest=(\w+)", printed).group(1),
            re.search(r"^monitor: (.*)$", printed, re.M).group(1),
            re.search(r"plan for production mesh: (\w+)", printed).group(1))


@pytest.mark.parametrize("mode", ["padded", "continuous"])
def test_serve_path_matches_jax(capsys, monkeypatch, init_weights, mode):
    """The reference's serve CLI with ``--arch qwen2-moe-a2.7b`` (reduced,
    its own init; ``--continuous`` too) and the port's serve path on the
    same weights and fitted predictor print the same outputs digest and
    monitor metrics; the port's CLI names the same production-mesh plan
    (no ep16 plan: 60 experts do not split 16 ways)."""
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
    assert not jplan.startswith("ep16")


def _spec(cfg, n=4, seed=13):
    """Prompts that repeat themselves, so n-gram drafts get accepted."""
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n):
        base = rng.integers(0, cfg.vocab_size, 5).tolist()
        out.append((i, base * 3, 10, 10.0, float(i)))
    return out


@pytest.mark.parametrize("flags", ["plain", "prefix", "speculate"])
def test_paged_engine_matches_jax(init_weights, flags):
    """Token-identical outputs and equal counters (all but the clocked
    ones) against the JAX PagedEngine, whose prefills see one prompt (or
    chunk) at a time, so its MoE capacity differs from the padded
    engine's: the plain flag set, the prefix cache on template-sharing
    prompts, and 4 n-gram drafts verified in one window of B x 5 tokens."""
    cfg, jcfg, jparams, model = init_weights
    specs, kw = {"plain": (_plain(cfg), {}),
                 "prefix": (_templates(cfg), dict(prefix_cache=True)),
                 "speculate": (_spec(cfg), dict(spec_tokens=4))}[flags]
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
    if flags == "speculate":         # verify windows ran (seeded weights:
        assert res.drafted_tokens > 0    # the drafts are rarely accepted)


def test_paged_serve_runs_and_candidate_plans_gate_ep16():
    """``serve --paged`` serves qwen2-moe (every mixer is full GQA
    attention, as the reference's ``paged_compatible`` says), and
    ``candidate_plans`` offers the expert-parallel ep16 plans only to an
    MoE arch whose experts split 16 ways: none to qwen2-moe's 60, and
    ``ep16_tp16`` to a 64-expert variant, as the reference does."""
    assert api.paged_compatible(get_config(ARCH)) == (True, "")
    out = serve.main(["--arch", ARCH, "--device", "cpu", "--paged",
                      "--requests", "4", "--max-new", "4"])
    assert len(out["outputs"]) == 4
    cfg, jcfg = get_config(ARCH), jax_get_config(ARCH)
    names = [c.name for c in deployer.candidate_plans(
        cfg, SHAPES["decode_32k"], multi_pod=False)]
    assert not any("ep16" in n for n in names)
    e64, je64 = (dataclasses.replace(c, moe=dataclasses.replace(
        c.moe, n_experts=64)) for c in (cfg, jcfg))
    got = deployer.candidate_plans(e64, SHAPES["decode_32k"], multi_pod=False)
    want = jax_deployer.candidate_plans(je64, JAX_SHAPES["decode_32k"],
                                        multi_pod=False)
    assert [c.name for c in got] == [c.name for c in want]
    assert "ep16_tp16" in [c.name for c in got]
    ep = next(c for c in got if c.name == "ep16_tp16")
    assert (ep.plan.ep_axis, ep.desc.ep) == ("data", 16)
