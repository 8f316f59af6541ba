"""The port's encoder-decoder under a sharding plan: whisper-medium
(reduced: 2 + 2 layers, 4 heads over 4 KV heads, 16 frames) on 4 gloo
ranks on the CPU (f32), under the plans ``candidate_plans`` builds on
{data: 2, model: 2} and {data: 1, model: 4}.  ``api.prefill`` and three
``api.decode_step`` calls are held to the JAX package's sharded functions
on an ``Auto`` mesh of 4 placeholder devices and to the port's unsharded
functions (within ATOL); every self and cross cache tensor carries
``cache_spec``'s layout (head-sharded under head-TP) and, gathered,
equals the unsharded port's.  Each rank's log of kernel-wrapper calls
shows the encoder's non-causal K2, the decoder's self and cross K2 at
prefill and its K3 over the self and cross caches at every step, on this
rank's heads.  ``api.loss_fn(plan=)`` (the loss, its nll and every
gradient leaf) and three ``make_train_step`` steps are held to the JAX
sharded functions and the unsharded port with the train tests'
tolerances.  The key biases' true gradient is zero (softmax is
shift-invariant over keys): both packages give rounding noise of ~1e-10
there, which GRAD_ATOL absorbs."""
import json

import pytest

from torch_sharded_harness import (B, KV_LEN, MESH14, MESH22, S, STEPS,
                                   TRAIN_STEPS, check_loss_and_grads,
                                   check_train_steps, max_err, plan_case,
                                   run_cases)

ATOL = 1e-4        # logits and caches, f32: the shards' summation order only
WHISPER = "whisper-medium"
LOGITS = [(MESH22, "tp_dp"), (MESH22, "tp_dp_sp"), (MESH22, "dp"),
          (MESH14, "longctx_seqshard"), (MESH14, "tp_dp")]
GRADS = ["tp_dp_train", "tp_dp_fsdp", "dp_train"]
CASES = ([plan_case("logits", WHISPER, m, p, cache_check=True)
          for m, p in LOGITS]
         + [plan_case("grad", WHISPER, MESH22, p) for p in GRADS]
         + [plan_case("step", WHISPER, MESH22, "tp_dp_fsdp", opt="adamw")])
LOGIT_IDS = [c["id"] for c in CASES if c["kind"] == "logits"]
GRAD_IDS = [c["id"] for c in CASES if c["kind"] == "grad"]
STEP_ID = next(c["id"] for c in CASES if c["kind"] == "step")
LAYERS = 2          # encoder and decoder layers each, reduced
FRAMES = 16         # the reduced config's cross_kv_len


@pytest.fixture(scope="module")
def results(tmp_path_factory):
    return run_cases([dict(c) for c in CASES],
                     tmp_path_factory.mktemp("sharded_encdec"))


@pytest.mark.parametrize("cid", LOGIT_IDS)
def test_logits_match_jax_sharded_and_port_unsharded(results, cid):
    keys = [k for k in results["jax"] if k.startswith(cid + "/")]
    assert len(keys) == 1 + STEPS               # prefill and the decode steps
    for key in keys:
        got = results["port"][key]
        assert got.shape == results["jax"][key].shape
        assert got.shape[0] == B
        assert max_err(got, results["jax"][key]) < ATOL, key
        assert max_err(got, results["plain"][key]) < ATOL, key


@pytest.mark.parametrize("cid", LOGIT_IDS)
def test_caches_carry_the_reference_layout(results, cid):
    """After the prefill and after the last step, every rank's self and
    cross K/V of every decoder layer carry ``cache_spec``'s layout of
    their full shape, and each gathered equals the unsharded port's."""
    names = {"self/k", "self/v", "cross/ck", "cross/cv"}
    for rank in range(4):
        recs = json.loads(json.dumps(results["calls"][rank][cid]["cache_specs"]))
        assert {(r[0], r[1], r[2]) for r in recs} == {
            (step, i, n) for step in (0, STEPS) for i in range(LAYERS)
            for n in names}
        for step, layer, name, got, want in recs:
            assert got == want, (rank, step, layer, name)
    keys = [k for k in results["port"] if k.startswith(f"{cid}/cache")]
    assert len(keys) == 2 * LAYERS * len(names)
    for key in keys:
        got, want = results["port"][key], results["plain"][key]
        assert got.shape == want.shape, key
        assert max_err(got, want) < ATOL, key


def _sizes(case):
    return dict(zip(("data", "model"), case["mesh"]))


@pytest.mark.parametrize("cid", LOGIT_IDS)
def test_k2_and_k3_run_on_this_ranks_heads(results, cid):
    """Each rank's prefill calls flash attention's wrapper (K2) once an
    encoder layer over its 16 frames and twice a decoder layer (self over
    the prompt, cross over the frames); each decode step calls the decode
    kernel's (K3) twice a decoder layer, over the cache_len self rows and
    the 16 cross rows.  The 4 KV heads divide every model axis here, so
    each call runs 4 / model heads, and neither the sequence-parallel
    residual nor the sequence axes change a call."""
    case = results["cases"][cid]
    plan, sizes = case["plan"], _sizes(case)
    heads = 4 // (sizes[plan["model_axis"]] if plan.get("model_axis") else 1)
    enc = {"sq": FRAMES, "skv": FRAMES, "h": heads, "kv": heads, "q_offset": 0}
    self_ = {"sq": S, "skv": S, "h": heads, "kv": heads, "q_offset": 0}
    cross = {"sq": S, "skv": FRAMES, "h": heads, "kv": heads, "q_offset": 0}
    decode = [{"h": heads, "kv": heads, "s": case["cache_len"]},
              {"h": heads, "kv": heads, "s": FRAMES}]
    for rank in range(4):
        calls = results["calls"][rank][cid]
        assert calls["flash_attention"] == [enc] * LAYERS + [self_, cross] * LAYERS
        assert calls["decode_attention"] == decode * LAYERS * STEPS
        assert "decode_attention_partial" not in calls


@pytest.mark.parametrize("cid", GRAD_IDS)
def test_loss_and_grads_match_jax_sharded_and_port_unsharded(results, cid):
    check_loss_and_grads(results, cid)


def test_train_steps_match_jax_sharded_and_port_unsharded(results):
    check_train_steps(results, STEP_ID)


def test_train_steps_run_k2_on_this_ranks_heads(results):
    """Each step's forward calls K2's wrapper once an encoder layer and
    twice a decoder layer, on 2 of the 4 heads (model = 2) and the whole
    sequence (the sequence-parallel residual is gathered before each
    attention); no remat in the encoder-decoder, as in the reference."""
    for rank in range(4):
        flash = results["calls"][rank][STEP_ID]["flash_attention"]
        assert len(flash) == 3 * LAYERS * TRAIN_STEPS
        assert {(c["h"], c["kv"]) for c in flash} == {(2, 2)}
