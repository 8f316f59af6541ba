"""The port's sharded serve path on the recurrent blocks: rwkv6-3b (the
RWKV-6 time mix head-parallel, K4 on this rank's heads, the channel mix as
the MLP) and jamba-1.5-large-398b at capacity factor 8 (the Mamba mixer
channel-parallel beside its attention and MoE layers), on 4 gloo ranks
on the CPU (f32), under the plans ``candidate_plans`` builds on {data: 2,
model: 2} and {data: 1, model: 4}.  Prefill and decode-step logits are
held to the JAX package's sharded functions on an ``Auto`` mesh of 4
placeholder devices and to the port's unsharded functions (within ATOL);
the engine, padded and continuous, must give exactly the tokens of the
JAX sharded engine and of the port's unsharded one.  Each rank's log of
K4's wrapper calls shows the heads it ran, and every cache tensor carries
the reference's layout (``specs.cache_spec``: states whole over the model
axis), its gathered value equal to the unsharded port's cache."""
import json

import pytest

from torch_sharded_harness import (B, MESH14, MESH22, S, STEPS, max_err,
                                   plan_case, run_cases)

ATOL = 1e-4        # logits and caches, f32: the shards' summation order only
RWKV, JAMBA = "rwkv6-3b", "jamba-1.5-large-398b"
# (arch, mesh, plan, MoE capacity factor): rwkv6-3b's 4 reduced heads
# split 2 and 1 a rank (longctx_seqshard on model = 4) or not at all (dp);
# jamba's tp_dp on {data: 1, model: 4} puts the Mamba in_proj's x columns
# on ranks 0-1 and its z columns on ranks 2-3
LOGITS = [
    (RWKV, MESH22, "tp_dp", None), (RWKV, MESH22, "tp_dp_sp", None),
    (RWKV, MESH14, "longctx_seqshard", None), (RWKV, MESH22, "dp", None),
    (JAMBA, MESH22, "ep_tp", 8), (JAMBA, MESH22, "tp_dp_sp", 8),
    (JAMBA, MESH14, "tp_dp", 8),
]
CASES = [plan_case("logits", a, m, p, capacity=c, cache_check=True)
         for a, m, p, c in LOGITS] + [
    plan_case(kind, a, MESH22, p, capacity=c)
    for a, p, c in ((RWKV, "tp_dp", None), (JAMBA, "ep_tp", 8))
    for kind in ("engine", "continuous")]
LOGIT_IDS = [c["id"] for c in CASES if c["kind"] == "logits"]
ENGINE_IDS = [c["id"] for c in CASES if c["kind"] != "logits"]
RWKV_IDS = [c["id"] for c in CASES if c["kind"] == "logits"
            and c["arch"] == RWKV]


@pytest.fixture(scope="module")
def results(tmp_path_factory):
    return run_cases([dict(c) for c in CASES],
                     tmp_path_factory.mktemp("sharded_recurrent"))


@pytest.mark.parametrize("cid", LOGIT_IDS)
def test_logits_match_jax_sharded_and_port_unsharded(results, cid):
    keys = [k for k in results["jax"] if k.startswith(cid + "/")]
    assert len(keys) == 1 + STEPS               # prefill and the decode steps
    for key in keys:
        got = results["port"][key]
        assert got.shape == results["jax"][key].shape
        assert max_err(got, results["jax"][key]) < ATOL, key
        assert max_err(got, results["plain"][key]) < ATOL, key


@pytest.mark.parametrize("cid", ENGINE_IDS)
def test_engine_tokens_match_exactly(results, cid):
    got = results["port_tokens"][cid]
    assert got == results["jax_tokens"][cid]
    assert got == {str(k): v for k, v in results["plain_tokens"][cid].items()}
    case = results["cases"][cid]
    assert [len(got[str(i)]) for i in range(len(case["new"]))] == case["new"]


def _shards(case, axes) -> int:
    sizes = dict(zip(("data", "model"), case["mesh"]))
    n = 1
    for a in axes or ():
        n *= sizes[a]
    return n


@pytest.mark.parametrize("cid", RWKV_IDS)
def test_k4_runs_on_this_ranks_heads(results, cid):
    """Every rank calls K4's wrapper once a layer and prefill, on its batch
    shard's rows and all S positions, over 4 / (model-axis size) of the 4
    reduced heads: the model axis cuts the heads, a batch-only plan none;
    the decode steps never call it."""
    case = results["cases"][cid]
    plan = case["plan"]
    heads = 4 // _shards(case, [plan["model_axis"]] if plan.get("model_axis")
                         else [])
    rows = B // _shards(case, plan.get("batch_axes"))
    layers = 2
    for rank in range(4):
        calls = results["calls"][rank][cid].get("wkv6", [])
        assert calls == [{"b": rows, "t": S, "h": heads}] * layers, rank


@pytest.mark.parametrize("cid", LOGIT_IDS)
def test_caches_carry_the_reference_layout(results, cid):
    """After the prefill and after the last decode step, every cache
    tensor of every rank carries ``cache_spec``'s layout of its full
    shape (recurrent states and shifts sharded by their batch alone, so
    whole over the model axis), and each one gathered equals the
    unsharded port's within ATOL."""
    n_layers = 2 if results["cases"][cid]["arch"] == RWKV else 8
    for rank in range(4):
        recs = json.loads(json.dumps(results["calls"][rank][cid]["cache_specs"]))
        assert {(r[0], r[1]) for r in recs} == {
            (step, i) for step in (0, STEPS) for i in range(n_layers)}
        for step, layer, name, got, want in recs:
            assert got == want, (rank, step, layer, name)
    keys = [k for k in results["port"] if k.startswith(f"{cid}/cache")]
    names = {k.split("/")[-1] for k in keys}
    assert names >= ({"shift", "state", "cm_shift"}
                     if results["cases"][cid]["arch"] == RWKV
                     else {"conv", "ssm", "k", "v"})
    for key in keys:
        got, want = results["port"][key], results["plain"][key]
        assert got.shape == want.shape, key
        assert max_err(got, want) < ATOL, key
