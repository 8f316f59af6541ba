"""The port's dry run and hillclimb (``repro_torch.launch.dryrun`` and
``hillclimb``: rank r's program on meta tensors over a fake process group)
against the reference's ``lower_cell``, which one JAX subprocess
(``tests/torch_dryrun_jax.py``) runs on 4 placeholder devices of an
``Auto`` mesh, -O0.

- ``pick_plan``'s names and fields, and the record's ``analytic`` terms,
  equal the reference's at TPU v5e for every cell, both meshes and both
  plan kinds;
- at reduced size on {data: 2, model: 2} the port's parameter,
  optimizer-state and cache bytes a rank equal the reference's compiled
  argument bytes less its batch inputs' shards, exactly;
- at full width on both production meshes, the three hillclimb cells and
  llama4-maverick x train_4k and jamba x decode_32k: the port's bytes a
  rank equal the shard arithmetic of the reference's specs;
- the kernel wrappers' meta rules (K2 with and without grad, K3, K4: the
  plain versions' CPU shapes and dtypes; K3 and K4 raise under grad; no
  launch), and a build on meta against a CPU build;
- the collectives of one step on 4 fake meta ranks against 4 real gloo CPU
  ranks (``tests/torch_dryrun_port.py``): chatglm2-6b and whisper-medium,
  decode and train, rwkv6-3b decode (its train cells are skipped: K4 has
  no backward on the card), under tp_dp;
- ``int8_cache_decode`` on the CPU against the reference's decode step
  composed with the same arithmetic, bf16;
- the dry run's and the hillclimb's command lines exit 0 and write their
  records.

The JAX oracle, the gloo ranks and the two command lines start together
in the background when the file's first test runs.
"""
import dataclasses
import json
import os
import subprocess
import sys
import time
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import TPU_V5E as JAX_TPU_V5E
from repro.configs import get_config as jax_get_config
from repro.models import api as jax_api
from repro_torch.configs import SHAPES, get_config, list_archs
from repro_torch.configs.base import HWSpec, ShapeConfig
from repro_torch.core.deployer import candidate_plans
from repro_torch.distributed.ranks import run_ranks
from repro_torch.kernels.decode_attention.ops import decode_attention
from repro_torch.kernels.decode_attention.ref import decode_attention_reference
from repro_torch.kernels.flash_attention.ops import flash_attention
from repro_torch.kernels.flash_attention.ref import flash_attention_reference
from repro_torch.kernels.paged_attention.ops import paged_decode_attention
from repro_torch.kernels.wkv6.ops import wkv6
from repro_torch.kernels.wkv6.ref import wkv6_chunked
from repro_torch.launch import dryrun as dr
from repro_torch.launch import hillclimb
from repro_torch.models import api
from repro_torch.params import from_jax_params, shard_params, stacked_leaves
from repro_torch.perf.cost_model import ParallelismDesc
from repro_torch.sharding.mesh import Mesh, set_mesh
from repro_torch.training import OptConfig, init_opt_state

import torch_dryrun_port
from test_torch_kernels import DECODE_CASES, FLASH_CASES, _flash_kw
from test_torch_wkv6 import CASES as WKV6_CASES

ROOT = Path(__file__).resolve().parents[1]
TESTS = Path(__file__).resolve().parent
# the reference's TPU-v5e constants as the port's HWSpec (as in
# test_torch_deployer.py: one link domain larger than any mesh)
TPU_V5E = HWSpec(JAX_TPU_V5E.name, peak_flops=JAX_TPU_V5E.peak_flops,
                 peak_flops_fp32=0.0, peak_flops_tf32=0.0,
                 hbm_bw=JAX_TPU_V5E.hbm_bw, hbm_bytes=JAX_TPU_V5E.hbm_bytes,
                 ici_bw=JAX_TPU_V5E.ici_bw, dcn_bw=JAX_TPU_V5E.dcn_bw,
                 link_domain=2**31)
MESH4 = {"data": 2, "model": 2}
BF16_TOL = 3e-2     # bf16 logits, x the largest (tests/test_torch_llama4.py)

# reduced cells (arch, kind, seq, batch, absorbed MLA): a decode batch of
# 16 takes the tp16_dp16 plan, one of 4 the long-context plan
REDUCED = {
    "smollm_train": ("smollm-135m", "train", 64, 4, False),
    "smollm_prefill": ("smollm-135m", "prefill", 64, 4, False),
    "smollm_decode": ("smollm-135m", "decode", 64, 16, False),
    "qwen2_moe_train": ("qwen2-moe-a2.7b", "train", 64, 4, False),
    "rwkv6_prefill": ("rwkv6-3b", "prefill", 64, 4, False),
    "jamba_decode": ("jamba-1.5-large-398b", "decode", 64, 16, False),
    "whisper_prefill": ("whisper-medium", "prefill", 64, 4, False),
    "minicpm3_decode_absorbed": ("minicpm3-4b", "decode", 64, 16, True),
}
# full-width cells (arch, shape, plan name or None for the baseline,
# absorbed MLA, int8 cache, meshes: False single pod, True two): the
# hillclimb's steps, and llama4-maverick's train and jamba's decode cells
BOTH = (False, True)
FULL = {
    "minicpm3_decode": ("minicpm3-4b", "decode_32k", None, False, False, BOTH),
    "minicpm3_decode_absorbed": ("minicpm3-4b", "decode_32k", None, True,
                                 False, BOTH),
    "smollm_train": ("smollm-135m", "train_4k", None, False, False, BOTH),
    # 256 sequences split over 256 ranks, not over 512
    "smollm_train_dp256": ("smollm-135m", "train_4k", "dp256", False, False,
                           (False,)),
    "gemma2_decode": ("gemma2-27b", "decode_32k", None, False, False, BOTH),
    "gemma2_decode_int8": ("gemma2-27b", "decode_32k", None, False, True,
                           BOTH),
    "llama4_train": ("llama4-maverick-400b-a17b", "train_4k", None, False,
                     False, BOTH),
    "jamba_decode": ("jamba-1.5-large-398b", "decode_32k", None, False, False,
                     BOTH),
}
_TP_DP = dict(batch_axes=["data"], model_axis="model", seq_axes=["model"],
              mla_absorbed=False)
_TP_DP_TRAIN = dict(batch_axes=["data"], model_axis="model", seq_parallel=True,
                    mla_absorbed=False, remat=True)
GLOO = {
    "chatglm2_decode": dict(arch="chatglm2-6b", kind="decode", seq=64,
                            batch=4, plan=_TP_DP),
    "chatglm2_train": dict(arch="chatglm2-6b", kind="train", seq=32, batch=4,
                           plan=_TP_DP_TRAIN),
    "rwkv6_decode": dict(arch="rwkv6-3b", kind="decode", seq=64, batch=4,
                         plan=_TP_DP),
    "whisper_decode": dict(arch="whisper-medium", kind="decode", seq=64,
                           batch=4, plan=_TP_DP),
    "whisper_train": dict(arch="whisper-medium", kind="train", seq=32,
                          batch=4, plan=_TP_DP_TRAIN),
}


def _full_cases():
    for name, (arch, shape, plan, absorbed, int8, meshes) in FULL.items():
        for multi_pod in meshes:
            yield f"{name}-{'2x16x16' if multi_pod else '16x16'}", dict(
                arch=arch, shape=shape, multi_pod=multi_pod, plan=plan,
                mla_absorbed=absorbed, int8_cache=int8)


def _spec() -> dict:
    return {"reduced": [dict(arch=a, kind=k, seq=s, batch=b, mla_absorbed=m)
                        for a, k, s, b, m in REDUCED.values()],
            "full": [c for _, c in _full_cases()],
            "archs": list_archs(include_extra=True)}


class _Background:
    """The file's subprocesses and its gloo ranks, started together."""

    def __init__(self, tmp: Path):
        self.tmp = tmp
        env = dict(os.environ, PYTHONPATH=os.pathsep.join(
            [str(ROOT / "src"), os.environ.get("PYTHONPATH", "")]))
        (tmp / "spec.json").write_text(json.dumps(_spec()))
        (tmp / "gloo.json").write_text(json.dumps(GLOO))
        self.t0 = time.time()
        self.procs = {
            "jax": subprocess.Popen(
                [sys.executable, str(TESTS / "torch_dryrun_jax.py"),
                 str(tmp / "spec.json"), str(tmp / "jax.json")],
                env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True),
            "dryrun": subprocess.Popen(
                [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch",
                 "smollm-135m", "--shape", "decode_32k"], cwd=ROOT, env=env,
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True),
            "hillclimb": subprocess.Popen(
                [sys.executable, "-m", "repro_torch.launch.hillclimb"],
                cwd=ROOT, env=env, stdout=subprocess.PIPE,
                stderr=subprocess.STDOUT, text=True)}
        self.out: dict = {}

    def result(self, name: str, timeout: float = 600.0) -> str:
        """The subprocess's output; it must have exited 0."""
        if name not in self.out:
            out, _ = self.procs[name].communicate(timeout=timeout)
            self.out[name] = out
            assert self.procs[name].returncode == 0, out[-3000:]
        return self.out[name]

    def close(self) -> None:
        for p in self.procs.values():
            if p.poll() is None:
                p.kill()
                p.communicate()


@pytest.fixture(scope="module")
def background(tmp_path_factory):
    bg = _Background(tmp_path_factory.mktemp("dryrun"))
    yield bg
    bg.close()


@pytest.fixture(scope="module")
def oracle(background):
    background.result("jax")
    return json.loads((background.tmp / "jax.json").read_text())


@pytest.fixture(scope="module")
def gloo(background):
    """Each case's collectives on 4 gloo CPU ranks."""
    tmp = background.tmp
    run_ranks(torch_dryrun_port.collective_probe,
              (str(tmp / "gloo.json"), str(tmp)), world=4, timeout=120.0,
              join_timeout=300.0)
    return [json.loads((tmp / f"rank{r}.json").read_text()) for r in range(4)]


# ------------------------------------------------------------ kernel rules

def _meta(*xs):
    return [x.to("meta") for x in xs]


def _launches():
    return (flash_attention.launches, decode_attention.launches,
            wkv6.launches)


@pytest.mark.parametrize("case", FLASH_CASES)
def test_flash_attention_meta_rule(case, background):
    """K2 on meta at the CPU parity cases' shapes: the plain version's
    shape and dtype, with and without grad, its gradient's shapes too
    (``flash_attention_grad`` on meta); counted in ``meta_calls``, no
    launch."""
    gen = torch.Generator().manual_seed(0)
    b, sq, skv, h, kv, d, dv = case[:7]
    q = torch.randn(b, sq, h, d, generator=gen)
    k = torch.randn(b, skv, kv, d, generator=gen)
    v = torch.randn(b, skv, kv, dv, generator=gen)
    kw = _flash_kw(case)
    before = _launches()
    want = flash_attention_reference(q, k, v, **kw)
    calls = flash_attention.meta_calls
    got = flash_attention(*_meta(q, k, v), **kw)
    assert (got.shape, got.dtype, got.device.type) == (want.shape,
                                                       want.dtype, "meta")
    assert flash_attention.meta_calls == calls + 1
    leaves = [t.requires_grad_(True) for t in _meta(q, k, v)]
    grad_calls = flash_attention.meta_backward_calls
    out = flash_attention(*leaves, **kw)
    grads = torch.autograd.grad(out, leaves, torch.empty_like(out))
    assert flash_attention.meta_backward_calls == grad_calls + 1
    for g, x in zip(grads, (q, k, v)):
        assert (g.shape, g.dtype, g.device.type) == (x.shape, x.dtype, "meta")
    assert _launches() == before


@pytest.mark.parametrize("case", DECODE_CASES)
def test_decode_attention_meta_rule(case, background):
    """K3 on meta at the CPU parity cases' shapes: the plain version's
    shape and dtype; raises under grad, as on the card."""
    gen = torch.Generator().manual_seed(1)
    b, s, h, kv, d, dv, softcap, window = case
    q = torch.randn(b, h, d, generator=gen)
    k = torch.randn(b, s, kv, d, generator=gen)
    v = torch.randn(b, s, kv, dv, generator=gen)
    kv_len = torch.randint(1, s + 1, (b,), generator=gen, dtype=torch.int32)
    kw = dict(softcap=softcap, window=window)
    want = decode_attention_reference(q, k, v, kv_len, **kw)
    calls, before = decode_attention.meta_calls, _launches()
    got = decode_attention(*_meta(q, k, v, kv_len), **kw)
    assert (got.shape, got.dtype, got.device.type) == (want.shape, want.dtype,
                                                       "meta")
    assert decode_attention.meta_calls == calls + 1
    mq, mk, mv, ml = _meta(q, k, v, kv_len)
    with pytest.raises(RuntimeError, match="no gradient"):
        decode_attention(mq.requires_grad_(True), mk, mv, ml, **kw)
    assert _launches() == before


@pytest.mark.parametrize("case", WKV6_CASES)
def test_wkv6_meta_rule(case, background):
    """K4 on meta at the CPU parity cases' shapes, with an initial state:
    out and final state of the plain version's shapes and dtypes; raises
    under grad, as on the card."""
    gen = torch.Generator().manual_seed(2)
    b, t, h, d, dv, chunk = case
    r, k, w = (torch.randn(b, t, h, d, generator=gen) for _ in range(3))
    w = torch.sigmoid(w)
    v = torch.randn(b, t, h, dv, generator=gen)
    u = torch.randn(h, d, generator=gen)
    s0 = torch.randn(b, h, d, dv, generator=gen)
    want = wkv6_chunked(r, k, v, w, u, s0, chunk=chunk)
    calls, before = wkv6.meta_calls, _launches()
    got = wkv6(*_meta(r, k, v, w, u, s0), chunk=chunk)
    for g, x in zip(got, want):
        assert (g.shape, g.dtype, g.device.type) == (x.shape, x.dtype, "meta")
    assert wkv6.meta_calls == calls + 1
    mr, mk, mv, mw, mu = _meta(r, k, v, w, u)
    with pytest.raises(RuntimeError, match="no gradient"):
        wkv6(mr.requires_grad_(True), mk, mv, mw, mu, chunk=chunk)
    assert _launches() == before


def test_paged_attention_has_no_meta_rule(background):
    """K1 is not on the dry run's path: it raises on meta."""
    q = torch.empty(2, 4, 16, device="meta")
    pool = torch.empty(8, 4, 2, 16, device="meta")
    with pytest.raises(ValueError, match="no kernel for device"):
        paged_decode_attention(q, pool, pool,
                               torch.zeros(2, 2, dtype=torch.int32,
                                           device="meta"),
                               torch.ones(2, dtype=torch.int32, device="meta"))


@pytest.mark.parametrize("arch", list_archs(include_extra=True))
def test_meta_build_matches_cpu_build(arch, background):
    """``init_params(device="meta")`` draws nothing and gives every
    parameter of a CPU build, with its shape and dtype."""
    cfg = get_config(arch).reduced()
    cpu = api.init_params(cfg, dtype=torch.bfloat16, device="cpu")
    meta = api.init_params(cfg, dtype=torch.bfloat16, device="meta")
    want = {k: (p.shape, p.dtype) for k, p in cpu.named_parameters()}
    assert {k: (p.shape, p.dtype) for k, p in meta.named_parameters()} == want
    assert {p.device.type for p in meta.parameters()} == {"meta"}


def test_skips(background):
    """The dry run's skips: ``cell_is_runnable``'s, and RWKV-6 training."""
    assert dr.skip_reason(get_config("smollm-135m"), SHAPES["long_500k"])
    assert "K4" in dr.skip_reason(get_config("rwkv6-3b"), SHAPES["train_4k"])
    assert dr.skip_reason(get_config("rwkv6-3b"), SHAPES["long_500k"]) == ""
    assert dr.skip_reason(get_config("jamba-1.5-large-398b"),
                          SHAPES["train_4k"]) == ""


# --------------------------------------------------- collectives vs gloo

@pytest.mark.parametrize("case", list(GLOO))
def test_collectives_match_gloo_ranks(case, gloo):
    """Calls and bytes by kind and by axes of one step on 4 fake meta
    ranks equal those of 4 gloo CPU ranks, rank by rank (f32)."""
    cfg, shape, plan = torch_dryrun_port.case_config(GLOO[case])
    mp = dr.plan_of("tp_dp", plan, cfg, shape,
                    ParallelismDesc(optimizer="adamw"))
    for rank in range(4):
        got = dr.run_rank(cfg, shape, mp, MESH4, rank,
                          dtype=torch.float32)["collectives"]
        assert got == gloo[rank][case], rank
        assert sum(got["calls"].values()) > 0


# ------------------------------------------------------------- int8 cache

def test_int8_cache_decode_matches_reference(background):
    """``int8_cache_decode`` at reduced gemma2-27b in bf16 (the reference's
    bf16 draw) against the reference's decode step composed with the same
    dequantise (x 0.05 in bf16) and requantise (round(x / 0.05) clipped to
    +-127): logits within BF16_TOL of the largest, the int8 cache within
    one quantisation step."""
    cfg, jcfg = get_config("gemma2-27b").reduced(), \
        jax_get_config("gemma2-27b").reduced()
    jparams = jax_api.init_params(jcfg, jax.random.PRNGKey(0))
    model = api.init_params(cfg, dtype=torch.bfloat16, device="cpu")
    model.load_state_dict(from_jax_params(jax.tree.map(
        lambda a: np.asarray(a.astype(jnp.float32)), jparams)))
    b, s = 2, 24
    rng = np.random.default_rng(0)
    toks = rng.integers(1, cfg.vocab_size, (b, 10)).astype(np.int32)
    kv_len = np.array([10, 7], dtype=np.int32)
    _, jcache = jax_api.prefill(jcfg, jparams, {"tokens": jnp.asarray(toks)},
                                cache_len=s, kv_len=jnp.asarray(kv_len))

    def quant(x):
        return jnp.clip(jnp.round(x / 0.05), -127, 127).astype(jnp.int8) \
            if x.dtype == jnp.bfloat16 else x
    jq = jax.tree.map(quant, jcache)
    nxt = rng.integers(1, cfg.vocab_size, (b, 1)).astype(np.int32)
    deq = jax.tree.map(lambda x: x.astype(jnp.bfloat16) * jnp.bfloat16(0.05)
                       if x.dtype == jnp.int8 else x, jq)
    jl, jnew = jax_api.decode_step(jcfg, jparams, jnp.asarray(nxt), deq,
                                   jnp.asarray(kv_len))
    jnew = jax.tree.map(quant, jnew)
    # the reference's cache: group leaves [n_groups, ...] under l{i}.mixer
    period = len(jq)
    cache = []
    for layer in range(cfg.n_layers):
        entry = jq[f"l{layer % period}"]["mixer"]
        cache.append({k: torch.from_numpy(np.array(v[layer // period]))
                      for k, v in entry.items()})
    got, new = hillclimb.int8_cache_decode(
        cfg, model, torch.from_numpy(nxt), cache, torch.from_numpy(kv_len))
    want = np.asarray(jl.astype(jnp.float32))
    err = float(np.abs(got.float().numpy() - want).max())
    assert err <= BF16_TOL * float(np.abs(want).max()), err
    for layer in range(cfg.n_layers):
        ref = jnew[f"l{layer % period}"]["mixer"]
        for k, v in new[layer].items():
            assert v.dtype == torch.int8
            diff = np.abs(v.numpy().astype(np.int32)
                          - np.asarray(ref[k][layer // period]).astype(np.int32))
            assert diff.max() <= 1, (layer, k)


# ------------------------------------------------------ against the oracle

def _port_plan(row, hw=TPU_V5E):
    cfg, shape = get_config(row["arch"]), SHAPES[row["shape"]]
    return dr.pick_plan(cfg, shape, multi_pod=row["multi_pod"],
                        which=row["which"], hw=hw)


@pytest.mark.parametrize("arch", list_archs(include_extra=True))
def test_pick_plan_and_analytic_match_reference(arch, oracle):
    """Every runnable cell of ``arch``, both meshes, both plan kinds: the
    plan's name, the plan's and the desc's fields, and the record's
    ``analytic`` terms at TPU v5e equal the reference's."""
    rows = [r for r in oracle["plans"] if r["arch"] == arch]
    assert len(rows) >= 12
    for row in rows:
        mp = _port_plan(row)
        assert mp.name == row["name"], row["shape"]
        for got, want in ((dataclasses.asdict(mp.plan), row["plan"]),
                          (dataclasses.asdict(mp.desc), row["desc"])):
            for k, v in got.items():
                assert (list(v) if isinstance(v, tuple) else v) == want[k], k
        cfg, shape = get_config(arch), SHAPES[row["shape"]]
        assert dr.analytic_terms(cfg, shape, mp.desc, TPU_V5E) == \
            row["analytic"], (row["shape"], row["multi_pod"], row["which"])


def _reduced(name):
    arch, kind, seq, batch, absorbed = REDUCED[name]
    cfg = get_config(arch).reduced()
    shape = ShapeConfig(f"dry_{kind}", seq, batch, kind)
    mp = dr.pick_plan(cfg, shape, multi_pod=False, which="baseline",
                      hw=TPU_V5E)
    if absorbed:
        mp = dataclasses.replace(
            mp, plan=dataclasses.replace(mp.plan, mla_absorbed=True),
            desc=dataclasses.replace(mp.desc, mla_absorbed=True))
    return cfg, shape, mp


@pytest.mark.parametrize("name", list(REDUCED))
def test_reduced_bytes_match_reference(name, oracle):
    """The port's parameter, optimizer-state and (decode) cache bytes on
    rank 0 and rank 3 of {data: 2, model: 2} equal the reference's
    compiled argument bytes a device less its batch inputs' shards,
    exactly; the plan and the record's ``analytic`` equal the
    reference's."""
    want = oracle["reduced"][list(REDUCED).index(name)]
    cfg, shape, mp = _reduced(name)
    rec = dr.lower_cell(cfg, shape, multi_pod=False, hw=TPU_V5E,
                        mesh_plan=mp, mesh_shape=MESH4, verbose=False)
    assert rec["plan"] == want["plan"]
    assert rec["analytic"] == want["analytic"]
    assert [r["rank"] for r in rec["ranks"]] == [0, 3]
    for run in rec["ranks"]:
        m = run["memory"]
        held = m["params"] + m["opt_state"] + \
            (m["cache"] if shape.kind == "decode" else 0)
        assert held == want["argument_bytes"] - want["batch_bytes"], run["rank"]
        assert m["peak"] >= held + m["inputs"]


def _rank_bytes(cfg, shape, mp, mesh_shape, rank, int8: bool) -> dict:
    """Rank ``rank``'s bytes of parameters, optimizer state and cache of
    the cell, built and cut as the dry run builds them (no step)."""
    with dr.fake_group(rank, int(np.prod(list(mesh_shape.values())))), \
            set_mesh(Mesh(mesh_shape, device="meta")):
        model = api.init_params(cfg, dtype=torch.bfloat16, device="meta")
        shard_params(cfg, model, mp.plan)
        out = {"params": dr.tree_bytes(list(model.parameters()))}
        if shape.kind == "train":
            named = {k: p.detach() for k, p in model.named_parameters()}
            out["opt_state"] = dr.tree_bytes(init_opt_state(
                named, OptConfig(kind=mp.desc.optimizer),
                stacked_leaves(cfg, named)))
        if shape.kind == "decode":
            cache = api.input_specs(cfg, shape)["cache"]
            if int8:
                cache = dr.cast_cache(cache, torch.int8, torch.bfloat16)
            out["cache"] = dr.tree_bytes(
                dr.shard_cache(cfg, mp.plan, cache, mesh_shape))
    return out


@pytest.mark.parametrize("name,case", list(_full_cases()),
                         ids=[n for n, _ in _full_cases()])
def test_full_width_bytes_match_reference_specs(name, case, oracle):
    """At full width on the production mesh, rank 0's and the last rank's
    parameter, optimizer-state and cache bytes equal the shard arithmetic
    of the reference's ``param_specs``, ``opt_state_specs`` and
    ``cache_specs_tree``."""
    want = oracle["full"][[n for n, _ in _full_cases()].index(name)]
    cfg, shape = get_config(case["arch"]), SHAPES[case["shape"]]
    mp = dr.pick_plan(cfg, shape, multi_pod=case["multi_pod"],
                      which="baseline", hw=TPU_V5E)
    if case["plan"] is not None:
        mp = {c.name: c for c in candidate_plans(
            cfg, shape, multi_pod=case["multi_pod"],
            hw=TPU_V5E)}[case["plan"]]
    if case["mla_absorbed"]:
        mp = dataclasses.replace(
            mp, plan=dataclasses.replace(mp.plan, mla_absorbed=True))
    assert mp.name == want["plan"]
    mesh_shape = {"pod": 2, "data": 16, "model": 16} if case["multi_pod"] \
        else {"data": 16, "model": 16}
    last = int(np.prod(list(mesh_shape.values()))) - 1
    for rank in (0, last):
        got = _rank_bytes(cfg, shape, mp, mesh_shape, rank, case["int8_cache"])
        assert got == {k: v for k, v in want.items() if k != "plan"}, rank


# ---------------------------------------------------------- command lines

def test_dryrun_cli_writes_its_record(background):
    out = background.result("dryrun")
    path = dr.ART_DIR / "smollm-135m__decode_32k__16x16__baseline.json"
    rec = json.loads(path.read_text())
    assert path.stat().st_mtime >= background.t0
    assert rec["arch"] == "smollm-135m" and rec["plan"] == "tp16_dp16"
    assert [r["rank"] for r in rec["ranks"]] == [0, 255]
    assert set(rec["memory"]) == {"params", "opt_state", "cache", "inputs",
                                  "outputs", "peak"}
    assert "dry-run complete" in out


def test_hillclimb_cli_prints_the_three_climbs(background):
    out = background.result("hillclimb")
    for name, tags in (
            ("hillclimb_minicpm3_decode", ("baseline_expanded",
                                           "opt1_mla_absorbed")),
            ("hillclimb_smollm_train", ("baseline_tp16", "opt1_pure_dp256",
                                        "opt2_int8_gradsync(analytic)")),
            ("hillclimb_gemma2_decode", ("baseline_bf16kv", "opt1_int8_kv"))):
        assert f"== {name} ==" in out
        steps = json.loads((hillclimb.ART / f"{name}.json").read_text())
        assert [s["plan_kind"] for s in steps] == list(tags)
        for tag in tags:
            assert f"  {tag}" in out
    gemma = json.loads((hillclimb.ART / "hillclimb_gemma2_decode.json"
                        ).read_text())
    assert gemma[1]["memory"]["cache"] * 2 == gemma[0]["memory"]["cache"]
