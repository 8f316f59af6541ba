"""The port's llama4-maverick-400b-a17b (dense and MoE layers in turn, 128
routed experts top-1 and one shared expert) against the JAX package on the
CPU, on converted weights (the attention kernels run their plain versions):
the config, its group period and parameter counts, the weights in f32 and
in bf16, the top-1 MoE block, prefill and decode logits, the padded,
continuous and paged engines token for token, and the serve path's digest
and plan, at the reduced size (4 over 1 heads) and at a group-5 variant (10
over 2 heads, the published 40 over 8); then the reduced model in bf16, the
reference's deployment dtype, against JAX's bf16 default ``init_params``.

A near-tie between a token's top and second router probability could flip
its expert between two implementations, so every f32 MoE comparison
asserts the smallest such margin of its inputs beside it (MARGIN).  In
bf16 both routers round their logits' matmul to bf16 before the fp32
softmax, and the stack's rounding differs by an ulp here and there, so a
flip needs a margin near the rounding of the logits (~1e-3); the bf16
tests print the margin, assert the block's experts equal on equal inputs,
and hold the logits to the tolerance whatever the margin."""
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
from repro.models import moe as jax_moe
from repro.models import transformer as jax_transformer
from repro.serving import EngineConfig as JaxEngineConfig
from repro.serving import InferenceEngine as JaxInferenceEngine
from repro.serving import PagedEngine as JaxPagedEngine
from repro.serving import PagedEngineConfig as JaxPagedEngineConfig
from repro.serving.sampling import greedy as jax_greedy
from repro_torch.configs import get_config, group_period
from repro_torch.core.types import Batch, Request
from repro_torch.launch import serve
from repro_torch.models import api, moe
from repro_torch.params import from_jax_params
from repro_torch.serving import (EngineConfig, InferenceEngine, PagedEngine,
                                 PagedEngineConfig)
from repro_torch.serving.sampling import greedy
from test_torch_dense_archs import (CLOCKED, _jax_predictor, _plain, _ragged,
                                    _weights)
from test_torch_moe import _spec, _stack_margin

ARCH = "llama4-maverick-400b-a17b"
ATOL = 1e-4                      # logits after the whole stack, f32
MOE_ATOL = 1e-5                  # the MoE block's outputs, f32
MARGIN = 1e-6                    # f32: a flip needs the probabilities ~1e-7 apart
# bf16 against bf16: both round every matmul's output to bf16 (8 bits of
# mantissa), in different orders (the SiLU, the residual adds), so two
# values of the same size may differ by a few of their ulps (2^-7 of them);
# outputs are held to BF16_TOL x their largest magnitude, as chip_smoke.py
# holds every bf16 kernel, with the 3e-2 of the reference's own bf16
# kernel tests (tests/test_kernels_flash.py)
BF16_TOL = 3e-2


def _bf16_close(got: np.ndarray, want: np.ndarray) -> float:
    """max |got - want| <= BF16_TOL x max |want|; returns the error."""
    err = float(np.abs(got - want).max())
    assert err <= BF16_TOL * float(np.abs(want).max()), (err, want.max())
    return err


def _cfgs(layout="reduced"):
    """(port cfg, JAX cfg): the reduced config (2 layers, d_model 64, 4
    over 1 heads of 16, 4 experts top-1, 1 shared), or ("group5") the same
    with 10 over 2 heads, the published group of 40 over 8."""
    cfg, jcfg = get_config(ARCH).reduced(), jax_get_config(ARCH).reduced()
    if layout == "group5":
        cfg, jcfg = (dataclasses.replace(c, n_heads=10, n_kv_heads=2)
                     for c in (cfg, jcfg))
    return cfg, jcfg


@pytest.fixture(scope="module", params=["reduced", "group5"])
def layout(request):
    return request.param


@pytest.fixture(scope="module")
def init_weights(layout):
    """(cfg, JAX cfg, JAX params as the reference's serve CLI draws them,
    f32; port model carrying them)."""
    cfg, jcfg = _cfgs(layout)
    return (cfg, jcfg, *_weights(cfg, jcfg))


def _bf16_weights(cfg, jcfg):
    """(JAX params in bf16, as ``init_params`` draws them by default, the
    port model carrying them in bf16).  numpy has no bf16: the tree is
    upcast to f32 on its way (exact) and cast back (exact)."""
    jparams = jax_api.init_params(jcfg, jax.random.PRNGKey(0))
    assert {a.dtype for a in jax.tree.leaves(jparams)} == {jnp.dtype("bfloat16")}
    tree = jax.tree.map(lambda a: np.asarray(a.astype(jnp.float32)), jparams)
    model = api.init_params(cfg, seed=0, dtype=torch.bfloat16, device="cpu")
    model.load_state_dict(from_jax_params(tree))
    return jparams, model


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
    assert [s.mlp for s in cfg.layer_plan()] == \
        ["dense", "moe"] * (cfg.n_layers // 2)
    assert group_period(cfg) == jax_transformer.group_period(jcfg) == 2
    for active in (False, True):
        assert cfg.param_count(active) == jcfg.param_count(active_only=active)
    for b, s in ((1, 16), (4, 1088), (128, 32_768)):
        assert cfg.kv_cache_bytes(b, s) == jcfg.kv_cache_bytes(b, s)
    if reduced:
        assert (cfg.n_layers, cfg.d_model, cfg.n_heads, cfg.n_kv_heads,
                cfg.head_dim_eff) == (2, 64, 4, 1, 16)
        assert (cfg.moe.n_experts, cfg.moe.top_k, cfg.moe.n_shared_experts,
                cfg.moe.d_expert, cfg.moe.d_shared_eff) == (4, 1, 1, 96, 96)
    else:
        # 397.68 G parameters (14.15 G active); one group period with the
        # embeddings 18.555 G: 74.2 GB in f32, 37.1 GB in bf16
        assert round(cfg.param_count() / 1e7) == 39768
        assert round(cfg.param_count(active_only=True) / 1e7) == 1415
        two = dataclasses.replace(cfg, n_layers=2)
        assert round(two.param_count() / 1e6) == 18555
        assert two.param_count() == dataclasses.replace(
            jcfg, n_layers=2).param_count()
        assert cfg.padded_vocab == 202_240
        assert (cfg.n_heads // cfg.n_kv_heads, cfg.head_dim_eff) == (5, 128)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
def test_weights_load_from_jax(dtype):
    """``from_jax_params`` loads a reduced llama4 tree (dense layer 0, MoE
    layer 1) in f32 and, from the reference's bf16 default draw, in bf16:
    every leaf's shape and value."""
    cfg, jcfg = _cfgs()
    if dtype == torch.float32:
        jparams, model = _weights(cfg, jcfg)
        want = from_jax_params(jparams)
    else:
        jparams, model = _bf16_weights(cfg, jcfg)
        want = from_jax_params(jax.tree.map(
            lambda a: np.asarray(a.astype(jnp.float32)), jparams))
    got = model.state_dict()
    assert set(got) == set(want)
    for k, v in want.items():
        assert got[k].dtype == dtype, k
        assert torch.equal(got[k].float(), v), k
    m, d = cfg.moe, cfg.d_model
    assert "blocks.0.mlp.up.w" in got and "blocks.1.mlp.router.w" in got
    assert tuple(got["blocks.1.mlp.up"].shape) == (m.n_experts, d, m.d_expert)
    assert "blocks.1.mlp.shared_0.gate.w" in got
    fresh = api.init_params(cfg, seed=3, dtype=dtype, device="cpu")
    assert {p.dtype for p in fresh.parameters()} == {dtype}
    # the reference's accounting leaves the routers out
    assert sum(v.numel() for v in got.values()) == \
        cfg.param_count() + d * m.n_experts


def test_top1_gate_and_capacity():
    """Top-1 over 128 experts: the renormalised gate is 1.0 for every
    token; capacity is 40 at the long prefill's 4 x 1024 tokens, and 4
    (every token) at a 4-sequence decode step, as the reference computes
    it."""
    full = get_config(ARCH)
    assert moe.expert_capacity(full, 4 * 1024) == 40
    assert moe.expert_capacity(full, 4) == 4
    jm = full.moe
    for t in (4, 4096):
        want = min(max(8, int(t * jm.top_k / jm.n_experts
                              * jm.capacity_factor)), t)
        assert moe.expert_capacity(full, t) == want
    cfg, _ = _cfgs()
    model = api.init_params(cfg, seed=0, device="cpu")
    xf = torch.randn(37, cfg.d_model, generator=torch.Generator().manual_seed(0))
    probs, gates, ids = moe.route(cfg, model.blocks[1].mlp, xf)
    assert gates.shape == (37, 1) and torch.equal(gates, torch.ones_like(gates))
    assert torch.equal(ids[:, 0], probs.argmax(-1))


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("shape", [(2, 4), (3, 11), (1, 1)])
def test_moe_apply_matches_jax(shape, dtype):
    """``moe_apply`` of the MoE layer (layer 1) against the reference's on
    the same input, in f32 (MOE_ATOL; a margin above MARGIN) and in bf16
    (BF16_TOL x the largest output; the router in fp32 from bf16 logits,
    the [E, C, d] buffer, the expert and shared products in bf16, the
    result in x's dtype): the same drop fraction and the same expert for
    every token."""
    cfg, jcfg = _cfgs()
    b, s = shape
    bf16 = dtype == "bf16"
    jparams, model = _bf16_weights(cfg, jcfg) if bf16 else \
        _weights(cfg, jcfg, perturb_seed=2)
    rng = np.random.default_rng(7)
    x = (rng.standard_normal((b, s, cfg.d_model)) + 2.0 * rng.standard_normal(
        cfg.d_model)).astype(np.float32)
    jp = jax.tree.map(lambda a: a[0], jparams["blocks"]["l1"]["mlp"])
    tdt, jdt = (torch.bfloat16, jnp.bfloat16) if bf16 else \
        (torch.float32, jnp.float32)
    jy, jaux = jax_moe.moe_apply(jcfg, jp, jnp.asarray(x).astype(jdt))
    p = model.blocks[1].mlp
    tx = torch.from_numpy(x).to(tdt)
    y, aux = moe.moe_apply(cfg, p, tx)
    assert y.dtype == tdt and jy.dtype == jdt
    margin = moe.router_margin(cfg, p, tx)
    print(f"router margin ({dtype}): {margin:.3e}")
    assert margin > (0.0 if bf16 else MARGIN), margin
    want = np.asarray(jy.astype(jnp.float32))
    if bf16:
        _bf16_close(y.float().numpy(), want)
    else:
        np.testing.assert_allclose(y.numpy(), want, atol=MOE_ATOL)
    assert aux["drop_frac"].item() == pytest.approx(float(jaux["drop_frac"]),
                                                    abs=MOE_ATOL)
    xf = tx.reshape(-1, cfg.d_model)
    jprobs = jax.nn.softmax(
        (jnp.asarray(x).astype(jdt).reshape(-1, cfg.d_model)
         @ jp["router"]["w"]).astype(jnp.float32), -1)
    _, jids = jax.lax.top_k(jprobs, 1)
    assert np.array_equal(moe.route(cfg, p, xf)[2].numpy(), np.asarray(jids))


def test_prefill_and_decode_logits_match_jax(rng, layout):
    """Right-padded ragged batch on perturbed converted weights (f32):
    last-valid prefill logits and three decode steps within ATOL, through a
    dense layer and a top-1 MoE layer at group 4 or 5."""
    cfg, jcfg = _cfgs(layout)
    jparams, model = _weights(cfg, jcfg, perturb_seed=1)
    toks, kv_len = _ragged(rng, cfg)
    assert _stack_margin(cfg, model, toks) > MARGIN
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


@pytest.mark.parametrize("flags", ["plain", "speculate"])
def test_paged_engine_matches_jax(init_weights, flags):
    """Token-identical outputs and equal counters (all but the clocked
    ones) against the JAX ``PagedEngine``: the plain flag set, and 4 n-gram
    drafts verified in one window of B x 5 tokens (K1's window entry)."""
    cfg, jcfg, jparams, model = init_weights
    specs, extra = {"plain": (_plain(cfg), {}),
                    "speculate": (_spec(cfg), dict(spec_tokens=4))}[flags]
    kw = dict(max_batch=4, block_size=8, n_blocks=64, max_seq_len=64,
              max_new_tokens=12, **extra)
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
    if flags == "speculate":
        assert res.drafted_tokens > 0


def _jax_cli(capsys, monkeypatch):
    """(digest, monitor line, plan) printed by the reference's serve CLI."""
    monkeypatch.setattr("sys.argv", ["serve", "--arch", ARCH])
    jax_serve.main()
    printed = capsys.readouterr().out
    return (re.search(r"outputs_digest=(\w+)", printed).group(1),
            re.search(r"^monitor: (.*)$", printed, re.M).group(1),
            re.search(r"plan for production mesh: (\w+)", printed).group(1))


def test_serve_path_matches_jax(capsys, monkeypatch):
    """The reference's serve CLI with ``--arch llama4-maverick-400b-a17b``
    (reduced, its own f32 init) and the port's serve path on the same
    weights and fitted predictor print the same outputs digest and monitor
    metrics; both name ``ep16_tp16`` as the production-mesh plan."""
    cfg, jcfg = _cfgs()
    _, model = _weights(cfg, jcfg)
    digest, monitor, jplan = _jax_cli(capsys, monkeypatch)
    out = serve.serve(cfg, model, serve.make_requests(cfg, 12, 16),
                      _jax_predictor(cfg.vocab_size))
    assert out["digest"] == digest
    assert str(out["monitor"].metrics()) == monitor
    assert jplan == "ep16_tp16"
    mine = serve.main(["--arch", ARCH, "--device", "cpu", "--requests", "3",
                       "--max-new", "4", "--paged"])
    assert len(mine["outputs"]) == 3
    assert f"plan for production mesh: {jplan})" in capsys.readouterr().out


def test_bf16_logits_match_jax(rng, layout):
    """The reduced model in bf16 on the reference's own bf16 draw: prefill
    logits (fp32 from the bf16 head) and three decode steps against JAX's
    within BF16_TOL x the largest logit, the caches in bf16; the smallest
    router margin of its MoE inputs is printed."""
    cfg, jcfg = _cfgs(layout)
    jparams, model = _bf16_weights(cfg, jcfg)
    toks, kv_len = _ragged(rng, cfg)
    print(f"bf16 router margin ({layout}): "
          f"{_stack_margin(cfg, model, toks):.3e}")
    jl, jc = jax_api.prefill(jcfg, jparams, {"tokens": jnp.asarray(toks)},
                             cache_len=24, kv_len=jnp.asarray(kv_len))
    tl, tc = api.prefill(cfg, model, {"tokens": torch.from_numpy(toks).long()},
                         cache_len=24, kv_len=torch.from_numpy(kv_len))
    assert tl.dtype == torch.float32 and jl.dtype == jnp.float32
    assert {c[n].dtype for c in tc for n in ("k", "v")} == {torch.bfloat16}
    errs = [_bf16_close(tl.numpy(), np.asarray(jl))]
    for step in range(3):
        # JAX's greedy tokens drive both, so a near-tied argmax cannot
        # make the two streams part
        nxt = np.array(jax_greedy(jl, jcfg.vocab_size))
        jl, jc = jax_api.decode_step(jcfg, jparams, jnp.asarray(nxt)[:, None],
                                     jc, jnp.asarray(kv_len + step))
        tl, tc = api.decode_step(cfg, model, torch.from_numpy(nxt)[:, None].long(),
                                 tc, torch.from_numpy(kv_len + step))
        errs.append(_bf16_close(tl.numpy(), np.asarray(jl)))
    print(f"bf16 logits max abs err ({layout}): prefill {errs[0]:.3e}, "
          f"decode {max(errs[1:]):.3e}")


def test_bf16_serve_paths_run():
    """bf16 weights through ``serve.serve`` padded, continuous and paged (a
    pool sized at 2 bytes a value, its pools in bf16): 12 requests
    answered each, every token in the vocab."""
    cfg, jcfg = _cfgs()
    _, model = _bf16_weights(cfg, jcfg)
    reqs = serve.make_requests(cfg, 12, 16)
    pcfg = serve.paged_config(cfg, reqs, 16, 2e5, dtype_bytes=2)
    assert pcfg.n_blocks == PagedEngineConfig.from_memory_budget(
        cfg, 4e5, block_size=8).n_blocks
    seen, init = [], api.init_paged_pools

    def spy(*a, **kw):
        pools = init(*a, **kw)
        seen.append({p["k"].dtype for p in pools})
        return pools
    api.init_paged_pools = spy
    try:
        for kw in ({}, dict(continuous=True), dict(paged=pcfg)):
            out = serve.serve(cfg, model, serve.make_requests(cfg, 12, 16),
                              serve.fit_predictor(cfg.vocab_size, "cpu"), **kw)
            assert len(out["outputs"]) == 12
            assert all(0 <= t < cfg.vocab_size for v in out["outputs"].values()
                       for t in v)
    finally:
        api.init_paged_pools = init
    assert seen == [{torch.bfloat16}]
