"""The port's paged engine under a batch-only plan (``PagedEngine(plan=)``)
on 4 gloo ranks on the CPU (f32), held to the JAX package's paged engine
under the same plan on an ``Auto`` mesh of 4 placeholder devices, to the
JAX unsharded engine and to the port's unsharded one, on the same numpy
weights and requests (``torch_sharded_harness``): smollm-135m under ``dp``
plain, with n-gram speculation (K1's verify window), with the prefix cache
and 8-token chunks over a shared-prefix wave and a second wave that
extends the first's answers, under preemption, and at 3 slots (rows the 4
batch shards do not divide, so every rank runs them whole); chatglm2-6b
(2 KV heads) under ``dp`` with the prefix cache.  Token streams, counters,
trace events and admissions must be equal across the four engines, every
rank's pools equal to the unsharded port's, and each rank's log of kernel
wrapper calls shows K1 on its own rows once a layer per step.  Where a
plan has a model or sequence axis, or the model an MoE block under batch
axes, both packages' engines raise the same exception type."""
import numpy as np
import pytest

from torch_sharded_harness import MESH14, MESH22, plan_case, run_cases

POOL_RTOL = 1e-5        # x the pool's largest |value|
LAYERS = 2              # every reduced config here
DP = [("smollm-135m", MESH22, "plain"), ("smollm-135m", MESH14, "plain"),
      ("smollm-135m", MESH22, "spec"), ("smollm-135m", MESH14, "waves"),
      ("smollm-135m", MESH22, "preempt"), ("smollm-135m", MESH14, "b3"),
      ("smollm-135m", MESH22, "b3_spec"), ("chatglm2-6b", MESH22, "prefix")]
# (arch, mesh, plan, the exception both engines raise): the reference's
# first prefill fails in shard_map when its batch axes split the one row
# (the sequence-parallel attention of 1 KV head over model = 2, or an MoE
# block); otherwise its first decode step rejects the model axis
RAISES = [("smollm-135m", MESH22, "tp_dp", "ValueError"),
          ("smollm-135m", MESH14, "tp_dp", "NotImplementedError"),
          ("chatglm2-6b", MESH22, "tp_dp", "NotImplementedError"),
          ("smollm-135m", MESH14, "longctx_seqshard", "NotImplementedError"),
          ("qwen2-moe-a2.7b", MESH22, "dp", "ValueError"),
          ("qwen2-moe-a2.7b", MESH22, "ep_tp", "ValueError")]
CASES = [plan_case("paged", a, m, "dp", variant=v) for a, m, v in DP] + [
    plan_case("paged", a, m, p, variant="plain", raises=True, error=e)
    for a, m, p, e in RAISES]
DP_IDS = [c["id"] for c in CASES if not c.get("raises")]
RAISE_IDS = [c["id"] for c in CASES if c.get("raises")]


@pytest.fixture(scope="module")
def results(tmp_path_factory):
    return run_cases([dict(c) for c in CASES],
                     tmp_path_factory.mktemp("sharded_paged"))


def _runs(results, cid) -> dict:
    """The four engines' results: each port rank's, the JAX sharded and
    unsharded engines', the port's unsharded one."""
    runs = {f"port rank {r}": results["paged"][r]["run"][cid] for r in range(4)}
    runs["jax sharded"] = results["jax_tokens"][cid]["sharded"]
    runs["jax unsharded"] = results["jax_tokens"][cid]["unsharded"]
    runs["port unsharded"] = results["plain_tokens"][cid]
    return runs


@pytest.mark.parametrize("cid", DP_IDS)
def test_tokens_counters_and_schedule_match(results, cid):
    """Token streams, counters (all but the clocked ones), trace events and
    admissions equal across the four engines and the port's ranks."""
    runs = _runs(results, cid)
    want = runs.pop("jax sharded")
    assert "error" not in want
    for name, got in runs.items():
        for key in ("outputs", "counters", "events", "admits"):
            assert got[key] == want[key], (name, key)
    case = results["cases"][cid]
    assert len(want["outputs"]) == len(case["reqs"])
    assert [len(want["outputs"][str(r[0])]) for r in case["reqs"]] == \
        [r[2] for r in case["reqs"]]


@pytest.mark.parametrize("cid", DP_IDS)
def test_every_rank_pool_equals_the_unsharded_pool(results, cid):
    """Each rank's pools at the end of the run equal the unsharded port
    engine's on every block but the null one (the masked rows' scratch):
    the blocks every sequence wrote, on whichever rank it ran, and zeros
    where none did."""
    plain = {k: v for k, v in results["plain"].items() if k.startswith(cid + "/")}
    assert len(plain) == 2 * LAYERS
    for r in range(4):
        pools = results["paged"][r]["pools"]
        for key, want in plain.items():
            got = pools[key]
            assert got.shape == want.shape
            scale = np.abs(want[1:]).max()
            assert scale > 0
            err = np.abs(got[1:].astype(np.float64) - want[1:]).max()
            assert err <= POOL_RTOL * scale, (r, key, err, scale)


@pytest.mark.parametrize("cid", DP_IDS)
def test_k1_runs_each_rank_rows_once_a_layer_a_step(results, cid):
    """Rank r calls K1's wrapper once a layer per decode or verify step, on
    its own rows (max_batch / 4, or all of them when the 4 batch shards do
    not divide max_batch), over the whole pool; and K2's once a layer per
    prefill chunk, every prefill whole on every rank."""
    case = results["cases"][cid]
    pcfg = case["pcfg"]
    counters = results["jax_tokens"][cid]["sharded"]["counters"]
    b = pcfg["max_batch"]
    rows = b // 4 if b % 4 == 0 else b
    t = pcfg.get("spec_tokens", 0) + 1
    entry = "paged_window_attention" if t > 1 else "paged_decode_attention"
    other = "paged_decode_attention" if t > 1 else "paged_window_attention"
    for r in range(4):
        calls = results["calls"][r][cid]
        k1 = calls.get(entry, [])
        assert len(k1) == LAYERS * counters["steps"] > 0
        assert all(c == {"b": rows, "t": t, "h": 4, "blocks": pcfg["n_blocks"],
                         "tables": [rows, pcfg["max_seq_len"] // pcfg["block_size"]]}
                   for c in k1), (r, k1[:2])
        assert not calls.get(other)
        assert len(calls.get("flash_attention", [])) == \
            LAYERS * counters["prefill_chunks"]


def test_second_wave_hits_blocks_another_rank_decoded(results):
    """The second wave's prompts extend first-wave answers: at least one
    hit reaches past the first-wave prompt into blocks that decode steps
    wrote, and lands in a slot another rank runs (slot s is rank s's row
    at 4 slots over 4 batch shards)."""
    cid = plan_case("paged", "smollm-135m", MESH14, "dp", variant="waves")["id"]
    case = results["cases"][cid]
    run = results["paged"][0]["run"][cid]
    first = {r[0]: r for r in case["reqs"][:4]}
    slot_of, crossed = {}, []
    for rid, slot, hit in run["admits"]:
        if rid >= 4:
            src = _wave_source(case, rid)
            if hit > len(first[src][1]) and slot_of[src] != slot:
                crossed.append((rid, src, slot_of[src], slot, hit))
        slot_of[rid] = slot
    assert crossed, run["admits"]
    counters = run["counters"]
    assert counters["prefix_hits"] >= len(crossed)
    assert counters["prefix_hit_tokens"] >= sum(c[4] for c in crossed)


def _wave_source(case, rid) -> int:
    """The first-wave request whose prompt the second-wave ``rid``'s
    extends."""
    toks = {r[0]: r[1] for r in case["reqs"]}[rid]
    for src in range(4):
        p = case["reqs"][src][1]
        if toks[:len(p)] == p:
            return src
    raise AssertionError(rid)


@pytest.mark.parametrize("cid", RAISE_IDS)
def test_plans_raise_as_the_reference_engine(results, cid):
    """Both engines raise the same exception type, the port before it made
    any pool, with a message that names the axis or block."""
    case = results["cases"][cid]
    want = results["jax_tokens"][cid]["sharded"]["error"]
    assert want[0] == case["error"], want
    for r in range(4):
        got = results["paged"][r]["run"][cid]
        assert got["error"][0] == want[0], got["error"]
        assert not got["made_pools"]
        assert ("MoE" in got["error"][1] or "axis" in got["error"][1]
                or "axes" in got["error"][1]), got["error"]
