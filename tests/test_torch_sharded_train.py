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
from repro_torch.params import from_jax_params, from_jax_tree

import torch_sharded_port
from torch_sharded_harness import (MESH14, MESH22, S, TRAIN_STEPS,
                                   jax_tree_of, max_err, plan_case,
                                   port_arrays, run_cases)

LOSS_RTOL = 1e-5        # loss, nll, lb_loss
GRAD_TOL = 1e-4         # each gradient leaf, x its largest magnitude
GRAD_ATOL = 1e-8
NORM_RTOL = 1e-4        # grad_norm
# the optimizer on given gradients: each leaf of the new parameters and
# the state within this x the leaf's largest magnitude
OPT_RTOL = 1e-6
# dp_mean_compressed: the int8 sums are exact; XLA rounds the dequantizing
# product in another order than torch
COMPRESS_RTOL = 1e-6
# Adafactor's moments after a train step, each leaf within this x its
# largest value against the JAX package and against the unsharded port.
# They are means of squared gradients that differ at float order (summed
# over ranks in another order), so the optimizer's 1e-6 on given gradients
# is out of reach: the largest gaps measured on this case are 1.75e-6
# (JAX), 1.85e-6 (unsharded port) and, between the two unsharded
# functions, 1.96e-6
STEP_MOMENT_TOL = 1e-5
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


def _rel(a, b) -> float:
    return abs(float(a) - float(b)) / abs(float(b))


def _assert_leaves(got: dict, want: dict, tol: float, what: str):
    """Each leaf within ``tol`` x its largest magnitude."""
    assert set(got) == set(want) and len(got) > 10, what
    for key, v in want.items():
        err = max_err(got[key], v)
        assert err <= tol * np.abs(v).max(), (what, key, err)


def _assert_grads(got: dict, want: dict, what: str):
    assert set(got) == set(want), what
    for name, ref in want.items():
        tol = GRAD_TOL * np.abs(ref).max() + GRAD_ATOL
        err = max_err(got[name], ref)
        assert err <= tol, (what, name, err, tol)


@pytest.mark.parametrize("cid", GRAD_IDS)
def test_loss_and_grads_match_jax_sharded_and_port_unsharded(results, cid):
    port, ref, plain = results["port"], results["jax"], results["plain"]
    for name in ("loss", "nll", "lb_loss"):
        for other in (ref, plain):
            if float(other[f"{cid}/{name}"]) == 0.0:      # a dense lb_loss
                assert float(port[f"{cid}/{name}"]) == 0.0
            else:
                assert _rel(port[f"{cid}/{name}"], other[f"{cid}/{name}"]) \
                    <= LOSS_RTOL, (name, other is ref)
    got = port_arrays(port, f"{cid}/grad")
    want = {k: v.numpy() for k, v in
            from_jax_params(jax_tree_of(ref, f"{cid}/grad")).items()}
    _assert_grads(got, want, "jax sharded")
    _assert_grads(got, port_arrays(plain, f"{cid}/grad"), "port unsharded")
    if results["cases"][cid]["arch"] == MOE:
        assert float(port[f"{cid}/lb_loss"]) > 0


@pytest.mark.parametrize("cid", STEP_IDS)
def test_train_steps_match_jax_sharded_and_port_unsharded(results, cid):
    port, ref, plain = results["port"], results["jax"], results["plain"]
    losses = []
    for i in range(TRAIN_STEPS):
        for other in (ref, plain):
            assert _rel(port[f"{cid}/loss{i}"], other[f"{cid}/loss{i}"]) \
                <= LOSS_RTOL, (i, other is ref)
            assert _rel(port[f"{cid}/grad_norm{i}"],
                        other[f"{cid}/grad_norm{i}"]) <= NORM_RTOL, (i, other is ref)
        losses.append(float(port[f"{cid}/loss{i}"]))
    assert len(set(losses)) == TRAIN_STEPS      # three batches, three losses


def _state(arrays, cid, part, stacked):
    got = port_arrays(arrays, f"{cid}/{part}")
    return got if stacked is None else {
        k: v.numpy() for k, v in (from_jax_tree if stacked else
                                  from_jax_params)(jax_tree_of(arrays, f"{cid}/{part}")).items()}


def test_adafactor_moments_after_one_step(results):
    """qwen2-moe-a2.7b under ep_tp_fsdp: every stacked leaf's row and
    column factors after the first step, gathered (their means psum over
    the sharded dims)."""
    cid = STEP_IDS[1]
    port, ref, plain = results["port"], results["jax"], results["plain"]
    for part in ("vr", "vc"):
        got = _state(port, cid, part, None)
        _assert_leaves(got, _state(ref, cid, part, True), STEP_MOMENT_TOL, part)
        _assert_leaves(got, _state(plain, cid, part, None), STEP_MOMENT_TOL,
                       part)


@pytest.mark.parametrize("cid", OPT_IDS)
def test_sharded_optimizer_on_given_gradients(results, cid):
    """Two updates on the same gradients: the new parameters and the
    state of the port's sharded optimizer against the JAX package's
    sharded ``apply_updates`` and the port's unsharded one."""
    port, ref, plain = results["port"], results["jax"], results["plain"]
    parts = ("m", "v") if results["cases"][cid]["opt"] == "adamw" \
        else ("vr", "vc")
    for part, stacked in (("p", False), *((q, q in ("vr", "vc")) for q in parts)):
        got = _state(port, cid, part, None)
        _assert_leaves(got, _state(ref, cid, part, stacked), OPT_RTOL, part)
        _assert_leaves(got, _state(plain, cid, part, None), OPT_RTOL, part)


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
