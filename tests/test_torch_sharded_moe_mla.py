"""The port's sharded serve path on the MoE and MLA archs: qwen2-moe-a2.7b
(expert parallel over data with the all-to-all, TP over model, the
replicated batch of ``longctx_ep``), llama4-maverick (top-1 experts every
other layer) and minicpm3-4b (MLA: head-TP prefill, the latent cache
sequence-sharded, absorbed and expanded decode), on 4 gloo ranks on the
CPU (f32), under the plans ``candidate_plans`` builds on {data: 2,
model: 2} and {data: 1, model: 4}.

Under a plan with a batch axis the MoE block runs per batch shard, as the
reference's ``shard_map`` body does: capacity, drops and ``lb_loss`` are
the shard's, so the block is not the unsharded function.  Logits and
engines are therefore held to both references at capacity factor 8 (no
drops, as the reference's own sharded worker runs them), and the block
itself, at the default factor of 1.25, to the JAX sharded block: output,
``lb_loss`` and ``drop_frac`` (the pmean of the shards')."""
import numpy as np
import pytest

from torch_sharded_harness import MESH14, MESH22, max_err, plan_case, run_cases

ATOL = 1e-4          # logits, f32
MOE_ATOL = 1e-5      # the MoE block's output, f32
AUX_ATOL = 1e-6      # lb_loss, drop_frac
NO_DROPS = 8.0
MOE = "qwen2-moe-a2.7b"
LOGITS = [
    (MOE, MESH22, "ep_tp"), (MOE, MESH22, "longctx_ep"), (MOE, MESH14, "dp"),
    ("llama4-maverick-400b-a17b", MESH22, "ep_tp"),
]
MLA_LOGITS = [
    ("minicpm3-4b", MESH22, "worker"), ("minicpm3-4b", MESH22, "tp_dp"),
    ("minicpm3-4b", MESH14, "longctx_seqshard"),
]
BLOCKS = [(MESH22, "ep_tp"), (MESH22, "tp_dp"), (MESH22, "longctx_ep"),
          (MESH14, "dp")]
CASES = (
    [plan_case("logits", a, m, p, NO_DROPS) for a, m, p in LOGITS]
    + [plan_case("logits", a, m, p) for a, m, p in MLA_LOGITS]
    + [plan_case("logits", MOE, MESH22, "ep_tp")]          # default factor
    + [plan_case("engine", MOE, MESH22, "ep_tp", NO_DROPS),
       plan_case("continuous", MOE, MESH14, "tp_dp", NO_DROPS),
       plan_case("engine", "minicpm3-4b", MESH22, "worker")]
    + [plan_case("moe_block", MOE, m, p) for m, p in BLOCKS])
DEFAULT_MOE_LOGITS = plan_case("logits", MOE, MESH22, "ep_tp")["id"]
LOGIT_IDS = [c["id"] for c in CASES
             if c["kind"] == "logits" and c["id"] != DEFAULT_MOE_LOGITS]
ENGINE_IDS = [c["id"] for c in CASES if c["kind"] in ("engine", "continuous")]
BLOCK_IDS = [c["id"] for c in CASES if c["kind"] == "moe_block"]


@pytest.fixture(scope="module")
def results(tmp_path_factory):
    return run_cases([dict(c) for c in CASES],
                     tmp_path_factory.mktemp("sharded_moe_mla"))


def _logit_keys(results, cid):
    keys = [k for k in results["jax"] if k.startswith(cid + "/")]
    assert len(keys) == 4                      # prefill and 3 decode steps
    return keys


@pytest.mark.parametrize("cid", LOGIT_IDS)
def test_logits_match_jax_sharded_and_port_unsharded(results, cid):
    for key in _logit_keys(results, cid):
        got = results["port"][key]
        assert got.shape == results["jax"][key].shape
        assert max_err(got, results["jax"][key]) < ATOL, key
        assert max_err(got, results["plain"][key]) < ATOL, key


def test_moe_logits_at_default_capacity_match_jax_sharded(results):
    """At the default factor each data shard drops on its own tokens: the
    port follows the JAX sharded function, not the unsharded one."""
    for key in _logit_keys(results, DEFAULT_MOE_LOGITS):
        assert max_err(results["port"][key], results["jax"][key]) < ATOL, key


@pytest.mark.parametrize("cid", ENGINE_IDS)
def test_engine_tokens_match_exactly(results, cid):
    got = results["port_tokens"][cid]
    assert got == results["jax_tokens"][cid]
    assert got == {str(k): v for k, v in results["plain_tokens"][cid].items()}
    case = results["cases"][cid]
    assert [len(got[str(i)]) for i in range(len(case["new"]))] == case["new"]


@pytest.mark.parametrize("cid", BLOCK_IDS)
def test_moe_block_matches_jax_sharded_block(results, cid):
    port, ref = results["port"], results["jax"]
    assert max_err(port[f"{cid}/y"], ref[f"{cid}/y"]) < MOE_ATOL
    for name in ("lb_loss", "drop_frac"):
        assert max_err(port[f"{cid}/{name}"], ref[f"{cid}/{name}"]) < AUX_ATOL, name
    if not results["cases"][cid]["plan"]["batch_axes"]:
        # a replicated batch: the block is the unsharded function
        assert max_err(port[f"{cid}/y"], results["plain"][f"{cid}/y"]) < MOE_ATOL


def test_moe_blocks_drop_per_shard(results):
    """The default factor drops (token, expert) entries in these inputs,
    and per-shard capacity drops other entries than the unsharded block:
    the comparison above is not a vacuous one."""
    drops = [float(results["port"][f"{cid}/drop_frac"]) for cid in BLOCK_IDS]
    assert max(drops) > 0
    sharded = [cid for cid in BLOCK_IDS
               if results["cases"][cid]["plan"]["batch_axes"]]
    assert any(not np.allclose(results["port"][f"{cid}/y"],
                               results["plain"][f"{cid}/y"], atol=MOE_ATOL)
               for cid in sharded)


def test_mla_latent_cache_is_sequence_sharded(results):
    """minicpm3-4b under the worker's plan: its 4 heads divide model = 2,
    so the prefill is head-TP (2 heads a rank); its decode gathers the
    latent cache of the sequence axes and decodes absorbed, never through
    the decode kernel.  Under the expanded plan the decode kernel runs on
    this rank's heads over the whole, gathered, sequence."""
    absorbed = plan_case("logits", "minicpm3-4b", MESH22, "worker")["id"]
    expanded = plan_case("logits", "minicpm3-4b", MESH22, "tp_dp")["id"]
    for rank in range(4):
        calls = results["calls"][rank]
        assert [c["h"] for c in calls[absorbed]["flash_attention"]] == [2, 2]
        assert "decode_attention" not in calls[absorbed]
        dec = calls[expanded]["decode_attention"]
        assert [(d["h"], d["s"]) for d in dec] == [(2, 20)] * 6
