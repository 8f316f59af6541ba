"""The port's training under a sharding plan, on 4 gloo ranks on the CPU
(f32): ``api.loss_fn(plan=)`` and ``make_train_step(cfg, plan, tcfg)``
under the train plans ``candidate_plans`` builds (``tp16_dp16`` with and
without fsdp and micro-batches, ``ep16_tp16_fsdp``, pure ``dp``; remat
and a sequence-parallel residual) on {data: 2, model: 2} and {data: 1,
model: 4}.  The loss, its metrics and every gradient leaf (gathered to
full), three train steps (loss and grad_norm, Adafactor's moments after
the first), two optimizer updates on given gradients and
``dp_mean_compressed`` are held to the JAX package's
sharded functions on an ``Auto`` mesh of 4 placeholder devices (parameters
placed by ``param_specs``, optimizer state by ``opt_state_specs``) and to
the port's unsharded functions on the same weights.  A batch-sharded MoE
computes its capacity and ``lb_loss`` per shard, as the reference's
``shard_map`` body does: its unsharded yardstick is the mean of the
unsharded function over the batch shards (each with the same mask count).
Also here: prefill and decode under an fsdp plan, remat changing nothing
but running K2's forward twice, and each differentiable collective's
backward against its transpose."""
import json

import numpy as np
import pytest

from repro_torch.distributed.ranks import run_ranks

import torch_sharded_port
from torch_sharded_harness import (MESH14, MESH22, S, TRAIN_STEPS,
                                   assert_leaves, check_adafactor_moments,
                                   check_loss_and_grads, check_train_steps,
                                   max_err, plan_case, port_arrays, run_cases,
                                   state_of)

# the optimizer on given gradients: each leaf of the new parameters and
# the state within this x the leaf's largest magnitude
OPT_RTOL = 1e-6
# dp_mean_compressed: the int8 sums are exact; XLA rounds the dequantizing
# product in another order than torch
COMPRESS_RTOL = 1e-6
ATOL = 1e-4             # logits
MOE = "qwen2-moe-a2.7b"
GRADS = [
    ("smollm-135m", MESH22, "tp_dp_train"),
    ("chatglm2-6b", MESH22, "tp_dp_fsdp"),
    ("chatglm2-6b", MESH14, "tp_dp_train"),
    (MOE, MESH22, "ep_tp_fsdp"),
    ("minicpm3-4b", MESH22, "tp_dp_train"),
    ("gemma2-27b", MESH22, "tp_dp_train"),
    ("qwen2-1.5b", MESH22, "dp_train"),
]
STEPS = [("chatglm2-6b", "tp_dp_fsdp_mb2", "adamw"),
         (MOE, "ep_tp_fsdp", "adafactor")]
OPTS = [(MOE, MESH22, "ep_tp_fsdp", "adafactor"),
        ("chatglm2-6b", MESH14, "tp_dp_train", "adafactor"),
        ("chatglm2-6b", MESH22, "tp_dp_fsdp", "adamw")]
REMAT = plan_case("grad", *GRADS[0])["id"]
CASES = ([plan_case("grad", a, m, p) for a, m, p in GRADS]
         # the first case's inputs, without remat
         + [plan_case("grad", "smollm-135m", MESH22, "tp_dp_noremat",
                      inputs_from=REMAT)]
         + [plan_case("step", a, MESH22, p, opt=o) for a, p, o in STEPS]
         + [plan_case("opt", a, m, p, opt=o) for a, m, p, o in OPTS]
         + [plan_case("compress", "smollm-135m", MESH22, "tp_dp_train"),
            plan_case("logits", "chatglm2-6b", MESH22, "tp_dp_fsdp")])
GRAD_IDS = [c["id"] for c in CASES if c["kind"] == "grad"]
STEP_IDS = [c["id"] for c in CASES if c["kind"] == "step"]
OPT_IDS = [c["id"] for c in CASES if c["kind"] == "opt"]
NO_REMAT = GRAD_IDS[-1]


@pytest.fixture(scope="module")
def results(tmp_path_factory):
    return run_cases([dict(c) for c in CASES],
                     tmp_path_factory.mktemp("sharded_train"))


@pytest.mark.parametrize("cid", GRAD_IDS)
def test_loss_and_grads_match_jax_sharded_and_port_unsharded(results, cid):
    check_loss_and_grads(results, cid)


@pytest.mark.parametrize("cid", STEP_IDS)
def test_train_steps_match_jax_sharded_and_port_unsharded(results, cid):
    check_train_steps(results, cid)


def test_adafactor_moments_after_one_step(results):
    """qwen2-moe-a2.7b under ep_tp_fsdp: every stacked leaf's row and
    column factors after the first step, gathered (their means psum over
    the sharded dims)."""
    check_adafactor_moments(results, STEP_IDS[1])


@pytest.mark.parametrize("cid", OPT_IDS)
def test_sharded_optimizer_on_given_gradients(results, cid):
    """Two updates on the same gradients: the new parameters and the
    state of the port's sharded optimizer against the JAX package's
    sharded ``apply_updates`` and the port's unsharded one."""
    port, ref, plain = results["port"], results["jax"], results["plain"]
    parts = ("m", "v") if results["cases"][cid]["opt"] == "adamw" \
        else ("vr", "vc")
    for part, stacked in (("p", False), *((q, q in ("vr", "vc")) for q in parts)):
        got = state_of(port, cid, part, None)
        assert_leaves(got, state_of(ref, cid, part, stacked), OPT_RTOL, part)
        assert_leaves(got, state_of(plain, cid, part, None), OPT_RTOL, part)


def test_dp_mean_compressed_matches_the_reference(results):
    cid = plan_case("compress", "smollm-135m", MESH22, "tp_dp_train")["id"]
    got = port_arrays(results["port"], f"{cid}/mean")
    want = port_arrays(results["jax"], f"{cid}/mean")
    plain = port_arrays(results["plain"], f"{cid}/mean")
    assert set(got) == set(want) == set(plain) and got
    for name, v in want.items():
        np.testing.assert_array_equal(got[name], plain[name], err_msg=name)
        np.testing.assert_allclose(got[name], v, rtol=COMPRESS_RTOL, atol=0,
                                   err_msg=name)


def test_fsdp_plan_prefills_and_decodes(results):
    """chatglm2-6b under tp16_dp16_fsdp: each block's weights gathered over
    data before use, the embedding's and head's too."""
    cid = plan_case("logits", "chatglm2-6b", MESH22, "tp_dp_fsdp")["id"]
    keys = [k for k in results["jax"] if k.startswith(cid + "/")]
    assert len(keys) == 4                      # prefill and 3 decode steps
    for key in keys:
        got = results["port"][key]
        assert max_err(got, results["jax"][key]) < ATOL, key
        assert max_err(got, results["plain"][key]) < ATOL, key


def test_remat_changes_no_loss_or_gradient(results):
    port = results["port"]
    for name in ("loss", "nll"):
        assert port[f"{REMAT}/{name}"] == port[f"{NO_REMAT}/{name}"]
    got, want = (port_arrays(port, f"{c}/grad") for c in (REMAT, NO_REMAT))
    assert set(got) == set(want)
    for name in want:
        np.testing.assert_array_equal(got[name], want[name], err_msg=name)


def _flash(results, cid, rank):
    return results["calls"][rank][cid].get("flash_attention", [])


def test_remat_runs_the_attention_forward_twice(results):
    """Each rank calls flash attention's wrapper (K2 on the card) once a
    layer in the forward and once more in the backward's recompute under
    remat, once without; every micro-batch and step alike.  smollm-135m's
    one KV head does not divide model = 2: this rank's S/2 query rows."""
    layers = 2
    for rank in range(4):
        remat = _flash(results, REMAT, rank)
        assert len(remat) == 2 * layers
        assert all(c["sq"] == S // 2 for c in remat)
        assert len(_flash(results, NO_REMAT, rank)) == layers
        step = _flash(results, STEP_IDS[0], rank)
        assert len(step) == layers * 2 * TRAIN_STEPS * 2   # micro-batches 2
        assert all((c["h"], c["kv"]) == (2, 1) for c in step)


def test_collectives_backward_is_their_transpose(tmp_path):
    """psum, all_gather, local_chunk, reduce_scatter and all_to_all over
    one axis and over both, on 4 ranks (no JAX): under ``no_grad`` equal
    bit for bit to plain ``torch.distributed`` calls; the backward of a
    cotangent equal to the transpose applied to it, and the adjoint
    identity over the ranks."""
    run_ranks(torch_sharded_port.collective_probe, (str(tmp_path),), world=4,
              timeout=60.0, join_timeout=120.0)
    seen = [json.loads((tmp_path / f"probe{r}.json").read_text())
            for r in range(4)]
    assert len(seen[0]) == 5 * 6      # 2x2: 3 axes; 1x4: 2 axes; 6 probes
    for rank in range(4):
        for key, rec in seen[rank].items():
            assert rec["forward_equal"], (rank, key)
            assert rec["backward_err"] == 0.0, (rank, key)
            lhs, rhs = rec["adjoint"]
            assert abs(lhs - rhs) <= 1e-12 * max(abs(lhs), 1.0), (rank, key)
