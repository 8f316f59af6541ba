"""The port's LLM deployer and cost model against the JAX package (host
code, no device arrays): HELR and its variants give the same device maps on
the reference's topologies and on seeded random ones (the hierarchical path
and an infeasible one included), ``step_cost`` the same cost terms, and
``candidate_plans`` / ``helr_mesh`` the same plans when both are priced at
the reference's TPU-v5e constants.  Two tests show the port's deliberate
departures: a ``MeshPlan`` prices its step time at the hardware it was
searched with, where the reference's prices at TPU v5e whatever it was
given; and a collective goes at the rate of the link class its group
crosses, where the reference prices every one at its ICI rate."""
import dataclasses

import numpy as np
import pytest

from repro.configs import SHAPES as JAX_SHAPES
from repro.configs import HWSpec as JaxHWSpec
from repro.configs import TPU_V5E as JAX_TPU_V5E
from repro.configs import get_config as jax_get_config
from repro.core import deployer as jax_deployer
from repro.core.types import DeviceNode as JaxDeviceNode
from repro.perf import cost_model as jax_cost_model
from repro_torch.configs import (H100, SHAPES, HWSpec, cell_is_runnable,
                                 get_config)
from repro_torch.core import deployer
from repro_torch.core.types import DeviceMap, DeviceNode
from repro_torch.perf import cost_model
from repro_torch.sharding import ShardingPlan

ARCHS = ["smollm-135m", "rwkv6-3b", "chatglm2-6b", "qwen2-1.5b", "gemma2-27b",
         "minicpm3-4b", "qwen2-moe-a2.7b", "qwen2-vl-7b", "whisper-medium",
         "llama4-maverick-400b-a17b", "jamba-1.5-large-398b"]
REL = 1e-12

# The reference's TPU-v5e constants as the port's HWSpec.  The reference
# prices every collective at its ICI rate, as though the whole mesh (two
# pods included) were one link domain; a domain larger than any mesh does
# the same here.  TPU v5e has no separate fp32 or TF32 rate.
TPU_V5E = HWSpec(JAX_TPU_V5E.name, peak_flops=JAX_TPU_V5E.peak_flops,
                 peak_flops_fp32=0.0, peak_flops_tf32=0.0,
                 hbm_bw=JAX_TPU_V5E.hbm_bw, hbm_bytes=JAX_TPU_V5E.hbm_bytes,
                 ici_bw=JAX_TPU_V5E.ici_bw, dcn_bw=JAX_TPU_V5E.dcn_bw,
                 link_domain=2**31)


def _same_map(got: DeviceMap, want) -> None:
    assert got.path == want.path
    assert got.layers == want.layers
    if want.est_latency == float("inf"):
        assert got.est_latency == float("inf")
    else:
        assert got.est_latency == pytest.approx(want.est_latency, rel=REL)
    assert got.est_util == pytest.approx(want.est_util, rel=REL)
    assert got.as_ranges(sum(want.layers.values())) == \
        want.as_ranges(sum(want.layers.values()))


def _line(n, near=1e-4):
    return [[0.0 if i == j else near * (1 + abs(i - j)) for j in range(n)]
            for i in range(n)]


def _islands(n, size=8):
    return [[0.0 if i == j else (1e-5 if i // size == j // size else 1e-3)
             for j in range(n)] for i in range(n)]


def _random(seed, n):
    rng = np.random.default_rng(seed)
    mem = rng.uniform(4e9, 32e9, n)
    perf = rng.uniform(5e12, 40e12, n)
    lat = rng.uniform(1e-5, 1e-3, (n, n))
    lat = (lat + lat.T) / 2
    np.fill_diagonal(lat, 0.0)
    return [(float(m), float(p)) for m, p in zip(mem, perf)], lat.tolist(), \
        float(rng.uniform(8e9, 60e9)), int(rng.integers(8, 48))


# name -> ([(memory, performance)], latency, model_mem, n_layers): the
# topologies of the reference's test_deployer.py, seeded random ones, one
# above EXACT_DP_MAX (the hierarchical path) and infeasible ones
TOPOLOGIES = {
    "memory_fits": ([(8e9, 30e12)] * 2, [[0, 1e-4], [1e-4, 0]], 10e9, 28),
    "infeasible": ([(8e9, 30e12)] * 2, [[0, 1e-4], [1e-4, 0]], 30e9, 28),
    "he_vs_lr": ([(10e9, 40e12), (10e9, 40e12), (20e9, 8e12)],
                 [[0, 5e-2, 1e-4], [5e-2, 0, 1e-4], [1e-4, 1e-4, 0]], 16e9, 32),
    "bgs": ([(8e9, 10e12), (8e9, 40e12)], [[0, 1e-4], [1e-4, 0]], 12e9, 24),
    "hierarchical_64": ([(4e9, 20e12)] * 64, _islands(64), 64e9, 128),
    "hierarchical_ragged_23": ([(6e9, 10e12 + 1e12 * i) for i in range(23)],
                               _line(23), 40e9, 60),
    "infeasible_20": ([(1e9, 10e12)] * 20, _line(20), 64e9, 28),
    "chatglm2_on_h100s": ([(80 * 2**30, 165e12)] * 4, _line(4, 2e-6),
                          6.2e9 * 4, 28),
    **{f"random_{seed}": _random(seed, n)
       for seed, n in ((0, 2), (1, 3), (2, 5), (3, 7), (4, 9), (5, 12))},
}


@pytest.mark.parametrize("name", sorted(TOPOLOGIES))
@pytest.mark.parametrize("policy", sorted(deployer.DEPLOYERS))
def test_device_maps_match_jax(name, policy):
    spec, lat, mem, n_layers = TOPOLOGIES[name]
    nodes = [DeviceNode(i, m, p) for i, (m, p) in enumerate(spec)]
    jnodes = [JaxDeviceNode(i, m, p) for i, (m, p) in enumerate(spec)]
    got = deployer.DEPLOYERS[policy](mem, n_layers, nodes, lat)
    want = jax_deployer.DEPLOYERS[policy](mem, n_layers, jnodes, lat)
    _same_map(got, want)
    if name.startswith("infeasible") and policy != "default":
        assert not got.path
    if name.startswith("hierarchical"):
        assert len(nodes) > deployer.EXACT_DP_MAX


def test_helr_weights_match_jax():
    spec, lat, mem, n_layers = _random(7, 6)
    nodes = [DeviceNode(i, m, p) for i, (m, p) in enumerate(spec)]
    jnodes = [JaxDeviceNode(i, m, p) for i, (m, p) in enumerate(spec)]
    for a1, a2, p, reserve in ((0.0, 1.0, 8.0, 0.2), (10.0, 1.0, 1.0, 0.0),
                               (2.5, 0.5, 32.0, 0.5)):
        cfg = deployer.HELRConfig(a1=a1, a2=a2, p=p, kv_reserve=reserve)
        jcfg = jax_deployer.HELRConfig(a1=a1, a2=a2, p=p, kv_reserve=reserve)
        assert deployer._caps(nodes, mem, n_layers, cfg) == \
            jax_deployer._caps(jnodes, mem, n_layers, jcfg)
        _same_map(deployer.helr(mem, n_layers, nodes, lat, cfg),
                  jax_deployer.helr(mem, n_layers, jnodes, lat, jcfg))


def _cells():
    for arch in ARCHS:
        for shape in SHAPES:
            if cell_is_runnable(get_config(arch), SHAPES[shape])[0]:
                yield arch, shape


def _terms(ct, ref=None):
    """The cost terms by the reference's field names (the port's
    ``coll_bytes`` is the sum of its ``coll_parts``)."""
    return {f.name: getattr(ct, f.name)
            for f in dataclasses.fields(ref if ref is not None else ct)}


def _port_fields(jdesc):
    """The reference desc's fields that the port's ParallelismDesc keeps;
    those it drops (sequence-sharded attention, unsharded residuals, a
    causal discount) must be at the values the port folds in."""
    kept = {f.name for f in dataclasses.fields(cost_model.ParallelismDesc)}
    fields = dataclasses.asdict(jdesc)
    assert {k: v for k, v in fields.items() if k not in kept} == \
        {"attn_mode": "tp", "seq_parallel_resid": True,
         "causal_discount": 1.0}
    return {k: v for k, v in fields.items() if k in kept}


def _descs(arch, shape):
    """Every ParallelismDesc the reference's candidate_plans makes for the
    cell (single and multi pod), plus the single-chip desc, and each of
    them with the hillclimb's options: the absorbed MLA decode and an int8
    KV cache."""
    cfg, sh = jax_get_config(arch), JAX_SHAPES[shape]
    descs = [jax_cost_model.ParallelismDesc()]
    for multi_pod in (False, True):
        descs += [c.desc for c in jax_deployer.candidate_plans(
            cfg, sh, multi_pod=multi_pod)]
    return descs + [dataclasses.replace(d, **opt) for d in descs
                    for opt in ({"mla_absorbed": True}, {"kv_bytes_per": 1})]


@pytest.mark.parametrize("arch,shape", list(_cells()))
def test_step_cost_matches_jax(arch, shape):
    cfg, jcfg = get_config(arch), jax_get_config(arch)
    assert cfg.param_count() == jcfg.param_count()
    descs = _descs(arch, shape)
    assert len(descs) > 2
    for jdesc in descs:
        desc = cost_model.ParallelismDesc(**_port_fields(jdesc))
        got = cost_model.step_cost(cfg, SHAPES[shape], desc)
        want = jax_cost_model.step_cost(jcfg, JAX_SHAPES[shape], jdesc)
        assert _terms(got, want) == _terms(want), jdesc
        assert got.hbm_resident == want.hbm_resident
        assert got.times(TPU_V5E) == want.times()
        assert got.bottleneck(TPU_V5E) == want.bottleneck()
        assert cost_model.weight_bytes(cfg, desc) == \
            jax_cost_model.weight_bytes(jcfg, jdesc)
        assert cost_model.optimizer_bytes(cfg, desc) == \
            jax_cost_model.optimizer_bytes(jcfg, jdesc)


@pytest.mark.parametrize("arch", ARCHS)
def test_kv_cache_bytes_match_jax(arch):
    """The cost model's cache bytes at the deployer's shapes and two others
    equal the reference's; a hybrid's carry its Mamba state, which does not
    grow with the sequence (jamba: 63 Mamba layers of 16,384 x (16 + 4)
    values a row, beside the K/V of its 9 attention layers)."""
    cfg, jcfg = get_config(arch), jax_get_config(arch)
    for b, s in [(sh.global_batch, sh.seq_len) for sh in SHAPES.values()] \
            + [(1, 16), (4, 1088)]:
        assert cfg.kv_cache_bytes(b, s) == jcfg.kv_cache_bytes(b, s)
    if cfg.mamba is None:
        return
    state = cfg.kv_cache_bytes(1, 0)
    assert state == 2 * 63 * 16_384 * (16 + 4)
    assert cfg.kv_cache_bytes(1, 1000) - state == 2 * 9 * 1000 * 2 * 8 * 128


def _plan_fields(plan):
    return {f.name: getattr(plan, f.name) for f in dataclasses.fields(plan)}


@pytest.mark.parametrize("arch,shape", list(_cells()))
def test_mesh_plans_match_jax_at_tpu_v5e(arch, shape):
    """Names, plans, descs, fits, hbm_used and step_time of every candidate
    and the pick, both packages priced at the reference's TPU-v5e
    constants (the reference's step_time always is)."""
    cfg, jcfg = get_config(arch), jax_get_config(arch)
    for multi_pod in (False, True):
        got = deployer.candidate_plans(cfg, SHAPES[shape], multi_pod=multi_pod,
                                       hw=TPU_V5E)
        want = jax_deployer.candidate_plans(jcfg, JAX_SHAPES[shape],
                                            multi_pod=multi_pod)
        assert [c.name for c in got] == [c.name for c in want]
        for a, b in zip(got, want):
            assert (a.fits, a.hbm_used, a.step_time) == \
                (b.fits, b.hbm_used, b.step_time)
            assert _plan_fields(a.plan) == _plan_fields(b.plan)
            assert dataclasses.asdict(a.desc) == _port_fields(b.desc)
            assert a.hw == TPU_V5E
        pick = deployer.helr_mesh(cfg, SHAPES[shape], multi_pod=multi_pod,
                                  hw=TPU_V5E)
        jpick = jax_deployer.helr_mesh(jcfg, JAX_SHAPES[shape],
                                       multi_pod=multi_pod)
        assert (pick.name, pick.fits, pick.hbm_used, pick.step_time) == \
            (jpick.name, jpick.fits, jpick.hbm_used, jpick.step_time)
        assert isinstance(pick.plan, ShardingPlan)


def test_collectives_priced_at_the_link_class_they_cross():
    """Deliberate departure from the reference: a collective whose group
    spans more than ``link_domain`` chips goes at ``dcn_bw``.  On H100s a
    group of 8 stays on one board's NVLink, one of 16 crosses InfiniBand."""
    assert (H100.ici_bw, H100.dcn_bw, H100.link_domain) == (450e9, 50e9, 8)
    cfg = get_config("chatglm2-6b")
    decode, train = SHAPES["decode_32k"], SHAPES["train_4k"]
    for tp, rate in ((8, H100.ici_bw), (16, H100.dcn_bw)):
        ct = cost_model.step_cost(cfg, decode, cost_model.ParallelismDesc(
            n_chips=tp, tp=tp, seq_shard_decode=tp))
        assert [g for g, _ in ct.coll_parts] == [tp, tp]
        assert ct.times(H100)["collective_s"] == \
            pytest.approx(ct.coll_bytes / rate, rel=REL)
        assert ct.times(TPU_V5E)["collective_s"] == \
            ct.coll_bytes / TPU_V5E.ici_bw
    # tp within a board, dp across boards: each part at its own rate
    ct = cost_model.step_cost(cfg, train, cost_model.ParallelismDesc(
        n_chips=256, tp=8, dp=32, fsdp=True))
    (g_tp, b_tp), (g_dp, b_grad), (_, b_gather) = ct.coll_parts
    assert (g_tp, g_dp) == (8, 32)
    assert ct.times(H100)["collective_s"] == pytest.approx(
        b_tp / H100.ici_bw + (b_grad + b_gather) / H100.dcn_bw, rel=REL)
    assert ct.coll_bytes == b_tp + b_grad + b_gather


@pytest.mark.parametrize("arch", ARCHS)
def test_step_time_prices_at_the_given_hw(arch):
    """Deliberate departure from the reference: with the H100 spec the
    port's step_time is the sum of the cost terms' times at H100, where the
    reference's (given the same constants) is the sum at TPU v5e, its
    ``CostTerms.times`` default."""
    jh100 = JaxHWSpec(H100.name, peak_flops=H100.peak_flops,
                      hbm_bw=H100.hbm_bw, hbm_bytes=H100.hbm_bytes,
                      ici_bw=H100.ici_bw, dcn_bw=H100.dcn_bw)
    shape = SHAPES["decode_32k"]
    mine = deployer.helr_mesh(get_config(arch), shape)
    assert mine.hw == H100
    assert mine.step_time == sum(mine.cost.times(H100).values())
    assert mine.step_time != sum(mine.cost.times(TPU_V5E).values())
    # and at a hardware other than the default, the plan keeps its own
    v5e = deployer.helr_mesh(get_config(arch), shape, hw=TPU_V5E)
    assert v5e.hw == TPU_V5E
    assert v5e.step_time == sum(v5e.cost.times(TPU_V5E).values())
    assert v5e.step_time != sum(v5e.cost.times(H100).values())
    ref = jax_deployer.helr_mesh(jax_get_config(arch),
                                 JAX_SHAPES["decode_32k"], hw=jh100)
    assert ref.step_time == sum(ref.cost.times(JAX_TPU_V5E).values())
    assert ref.step_time != sum(ref.cost.times(jh100).values())
    # both searched with the H100 constants: the same candidates and costs
    assert ref.name == mine.name
    assert _terms(mine.cost, ref.cost) == _terms(ref.cost)


@pytest.mark.parametrize("kw", [{}, dict(n_chips=256, tp=16, dp=16,
                                          seq_shard_decode=16)],
                         ids=["one_chip", "tp16"])
def test_mla_decode_cost_matches_jax(kw):
    """minicpm3-4b's decode cost with the latent expanded every step, as
    every plan has it, on one chip and under the tp16 plan: the same terms
    as the reference's; the expansion's operations and its K/V traffic are
    in them."""
    cfg, jcfg = get_config("minicpm3-4b"), jax_get_config("minicpm3-4b")
    shape = "decode_32k"
    got = cost_model.step_cost(cfg, SHAPES[shape],
                               cost_model.ParallelismDesc(**kw))
    want = jax_cost_model.step_cost(
        jcfg, JAX_SHAPES[shape],
        jax_cost_model.ParallelismDesc(mla_absorbed=False, **kw))
    assert _terms(got, want) == _terms(want)
    assert got.times(TPU_V5E) == want.times()
    absorbed = jax_cost_model.step_cost(
        jcfg, JAX_SHAPES[shape],
        jax_cost_model.ParallelismDesc(mla_absorbed=True, **kw))
    assert absorbed.flops < got.flops and absorbed.hbm_bytes < got.hbm_bytes
    assert absorbed.kv_bytes_chip == got.kv_bytes_chip


LLAMA4 = "llama4-maverick-400b-a17b"
# a long-context decode at batch 1 (the reference's longctx plans): the
# port's SHAPES have none for a full-attention arch (long_500k is skipped)
LONGCTX_B1 = dict(name="decode_32k_b1", seq_len=32_768, global_batch=1,
                  kind="decode")


@pytest.mark.parametrize("shape", ["train_4k", "prefill_32k", "decode_32k",
                                   "decode_32k_b1"])
def test_ep16_plans_match_jax_at_tpu_v5e(shape):
    """llama4-maverick's 128 experts split 16 ways, so ``candidate_plans``
    offers the reference's expert-parallel plans (``ep16_tp16`` and its
    ``_fsdp`` / ``_mbN`` variants when training, ``longctx_ep16`` at batch
    1), in the reference's order, with its plans, descs, fits and step
    times at TPU v5e."""
    if shape == "decode_32k_b1":
        sh = dataclasses.replace(SHAPES["decode_32k"], **LONGCTX_B1)
        jsh = dataclasses.replace(JAX_SHAPES["decode_32k"], **LONGCTX_B1)
    else:
        sh, jsh = SHAPES[shape], JAX_SHAPES[shape]
    cfg, jcfg = get_config(LLAMA4), jax_get_config(LLAMA4)
    for multi_pod in (False, True):
        got = deployer.candidate_plans(cfg, sh, multi_pod=multi_pod,
                                       hw=TPU_V5E)
        want = jax_deployer.candidate_plans(jcfg, jsh, multi_pod=multi_pod)
        names = [c.name for c in got]
        assert names == [c.name for c in want]
        ep = [c for c in got if "ep16" in c.name]
        assert ep and all((c.plan.ep_axis, c.desc.ep) == ("data", 16)
                          for c in ep)
        if shape == "decode_32k_b1":
            assert names == ["longctx_ep16", "longctx_seqshard"]
        if shape == "train_4k":
            assert {"ep16_tp16_fsdp_mb8", "ep16_tp16_mb4"} <= set(names)
        for a, b in zip(got, want):
            assert (a.fits, a.hbm_used, a.step_time) == \
                (b.fits, b.hbm_used, b.step_time)
            assert _plan_fields(a.plan) == _plan_fields(b.plan)
            assert dataclasses.asdict(a.desc) == _port_fields(b.desc)
            assert _terms(a.cost, b.cost) == _terms(b.cost)
        pick = deployer.helr_mesh(cfg, sh, multi_pod=multi_pod, hw=TPU_V5E)
        jpick = jax_deployer.helr_mesh(jcfg, jsh, multi_pod=multi_pod)
        assert (pick.name, pick.step_time) == (jpick.name, jpick.step_time)


def test_ep_weights_and_all_to_all():
    """Under ep16 × tp16 the routed banks shard 256 ways and the rest 16;
    a training step's expert all-to-all (dispatch and combine of every MoE
    layer) is a collective of the 16-chip expert group, so on H100s it
    crosses InfiniBand, as every 16-wide group does."""
    cfg = get_config(LLAMA4)
    desc = cost_model.ParallelismDesc(n_chips=256, tp=16, dp=16, ep=16)
    plain = cost_model.ParallelismDesc(n_chips=256, tp=16, dp=16)
    n_moe = sum(1 for s in cfg.layer_plan() if s.mlp == "moe")
    banks = 2.0 * n_moe * cfg.moe.n_experts * cfg._mlp_params(cfg.moe.d_expert)
    total = 2.0 * cfg.param_count()
    assert cost_model.weight_bytes(cfg, desc) == pytest.approx(
        (total - banks) / 16 + banks / 256, rel=REL)
    assert cost_model.weight_bytes(cfg, plain) == total / 16
    train = SHAPES["train_4k"]
    ct = cost_model.step_cost(cfg, train, desc)
    base = cost_model.step_cost(cfg, train, plain)
    assert len(ct.coll_parts) == len(base.coll_parts) + 1
    group, nbytes = ct.coll_parts[-1]
    tokens_local = train.global_batch * train.seq_len / 16
    assert group == 16
    assert nbytes == pytest.approx(
        2.0 * tokens_local * cfg.d_model * 2.0 * cfg.moe.top_k * n_moe, rel=REL)
    assert ct.times(H100)["collective_s"] - base.times(H100)["collective_s"] \
        == pytest.approx(nbytes / H100.dcn_bw, rel=1e-9)
    # serving steps have no all-to-all term in the reference's model
    for shape in ("prefill_32k", "decode_32k"):
        assert [g for g, _ in cost_model.step_cost(
            cfg, SHAPES[shape], desc).coll_parts] == \
            [g for g, _ in cost_model.step_cost(
                cfg, SHAPES[shape], plain).coll_parts]
