"""The port's sharded serve path on the dense archs: smollm-135m (one KV
head: the sequence-parallel prefill and the sequence-sharded decode),
chatglm2-6b with its full config's 2 KV heads (head-TP at model = 2,
sequence-parallel at model = 4), gemma2-27b (window rings, softcaps),
qwen2-1.5b and qwen2-vl-7b (M-RoPE), on 4 gloo ranks on the CPU (f32),
under the plans ``candidate_plans`` builds on {data: 2, model: 2} and
{data: 1, model: 4}.  Prefill and decode-step logits are held to the JAX
package's sharded functions on an ``Auto`` mesh of 4 placeholder devices
and to the port's unsharded functions (within ATOL); the engine, padded
and continuous, must give exactly the tokens of the JAX sharded engine
and of the port's unsharded one, ``dp``'s on a batch of 3 that its 4
batch shards do not divide (the port pads it with a one-token row).
Each rank's log of kernel-wrapper calls shows which path a plan took:
head-TP and sequence-parallel prefills reach flash attention's wrapper
(K2), head-TP decode the decode kernel's (K3), the sequence-sharded
decode the partial softmax."""
import pytest

from torch_sharded_harness import MESH14, MESH22, S, max_err, plan_case, run_cases

ATOL = 1e-4        # logits, f32: the shards' summation order only
# one case a path: on {data: 1, model: 4} tp_dp shards as
# longctx_seqshard does (its batch and sequence axes have the same sizes),
# and on a GQA model the worker's plan as tp_dp
LOGITS = [
    ("smollm-135m", MESH22, "tp_dp"), ("smollm-135m", MESH22, "tp_dp_sp"),
    ("smollm-135m", MESH14, "longctx_seqshard"),
    ("chatglm2-6b", MESH22, "tp_dp"), ("chatglm2-6b", MESH22, "tp_dp_sp"),
    ("chatglm2-6b", MESH14, "longctx_seqshard"),
    ("gemma2-27b", MESH22, "tp_dp"), ("gemma2-27b", MESH14, "longctx_seqshard"),
    ("qwen2-1.5b", MESH14, "dp"), ("qwen2-vl-7b", MESH22, "tp_dp_sp"),
]
CASES = [plan_case("logits", a, m, p) for a, m, p in LOGITS] + [
    plan_case("engine", "chatglm2-6b", MESH22, "tp_dp"),
    plan_case("engine", "chatglm2-6b", MESH14, "longctx_seqshard"),
    plan_case("engine", "smollm-135m", MESH22, "dp", n_prompts=3),
    plan_case("continuous", "chatglm2-6b", MESH22, "tp_dp")]
LOGIT_IDS = [c["id"] for c in CASES if c["kind"] == "logits"]
ENGINE_IDS = [c["id"] for c in CASES if c["kind"] != "logits"]


@pytest.fixture(scope="module")
def results(tmp_path_factory):
    return run_cases([dict(c) for c in CASES],
                     tmp_path_factory.mktemp("sharded_dense"))


@pytest.mark.parametrize("cid", LOGIT_IDS)
def test_logits_match_jax_sharded_and_port_unsharded(results, cid):
    keys = [k for k in results["jax"] if k.startswith(cid + "/")]
    assert len(keys) == 4                      # prefill and 3 decode steps
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


def _calls(results, cid, rank, name):
    return results["calls"][rank][cid].get(name, [])


def test_head_tp_reaches_both_kernel_wrappers(results):
    """chatglm2-6b on model = 2: 2 KV heads divide it, so every prefill
    layer runs flash attention on this rank's 2 over 1 heads and every
    decode step the decode kernel on them (no partial softmax)."""
    cid = plan_case("logits", "chatglm2-6b", MESH22, "tp_dp")["id"]
    layers = 2
    for rank in range(4):
        flash = _calls(results, cid, rank, "flash_attention")
        assert flash == [{"sq": S, "skv": S, "h": 2, "kv": 1, "q_offset": 0}] * layers
        dec = _calls(results, cid, rank, "decode_attention")
        assert len(dec) == 3 * layers and all(
            (d["h"], d["kv"]) == (2, 1) for d in dec)
        assert not _calls(results, cid, rank, "decode_attention_partial")


def test_seq_parallel_prefill_and_sharded_decode(results):
    """chatglm2-6b under longctx_seqshard on model = 4: 2 KV heads do not
    divide it, so rank r's prefill runs flash attention on its S/4 query
    rows over all S keys at q_offset r * S/4, all 4 heads; its decode
    computes the partial softmax over its quarter of the cache at offset
    r * 5 (cache of 20 over data x model = 4) and never the decode kernel."""
    cid = plan_case("logits", "chatglm2-6b", MESH14, "longctx_seqshard")["id"]
    layers = 2
    for rank in range(4):
        flash = _calls(results, cid, rank, "flash_attention")
        assert flash == [{"sq": S // 4, "skv": S, "h": 4, "kv": 2,
                          "q_offset": rank * S // 4}] * layers
        part = _calls(results, cid, rank, "decode_attention_partial")
        assert part == [{"h": 4, "s": 5, "pos_offset": rank * 5}] * (3 * layers)
        assert not _calls(results, cid, rank, "decode_attention")


def test_window_rings_stay_local_under_seq_axes(results):
    """gemma2-27b under longctx_seqshard: the window layer's ring (8 slots)
    is never sequence-sharded, so it decodes through the decode kernel's
    wrapper (the ring mapping); the global layer's cache of 20 is sharded
    and decodes by partial softmax."""
    cid = plan_case("logits", "gemma2-27b", MESH14, "longctx_seqshard")["id"]
    for rank in range(4):
        dec = _calls(results, cid, rank, "decode_attention")
        part = _calls(results, cid, rank, "decode_attention_partial")
        assert [d["s"] for d in dec] == [8] * 3
        assert [p["s"] for p in part] == [5] * 3
