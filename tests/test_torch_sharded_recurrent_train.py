"""Training Mamba and RWKV-6 models under a sharding plan, on 4 gloo
ranks on the CPU (f32): rwkv6-3b (the time mix head-parallel, K4's plain
version under autograd) and jamba-1.5-large-398b at capacity factor 8
(the Mamba mixer channel-parallel beside its attention and MoE layers),
under the train plans ``candidate_plans`` builds on {data: 2, model: 2}
and {data: 1, model: 4}.  ``api.loss_fn(plan=)`` (the loss, its metrics
and every gradient leaf, gathered) and three ``make_train_step`` steps
are held to the JAX package's sharded functions on an ``Auto`` mesh of 4
placeholder devices and to the port's unsharded functions, with the
train tests' tolerances; a batch-sharded MoE's unsharded yardstick is the
mean over the batch shards.  The replicated leaves a rank cuts locally
(RWKV's ``r``, ``g``, decay lora, ``u`` and head norm; Mamba's per-channel
leaves) get their whole gradient from the train step's psum, and Mamba's
in_proj gather backwards through its transpose.  Remat replays each
block's gathers and psums in the same order on every rank and changes
no bit of the loss or the gradients."""
import numpy as np
import pytest

from torch_sharded_harness import (B, MESH14, MESH22, S,
                                   STEP_MOMENT_TOL, check_adafactor_moments,
                                   check_loss_and_grads, check_train_steps,
                                   plan_case, port_arrays, run_cases)

RWKV, JAMBA = "rwkv6-3b", "jamba-1.5-large-398b"
GRADS = [
    (RWKV, MESH22, "tp_dp_train", None), (RWKV, MESH22, "dp_train", None),
    (RWKV, MESH22, "tp_dp_fsdp", None), (RWKV, MESH14, "tp_dp_noremat", None),
    (JAMBA, MESH22, "tp_dp_train", 8), (JAMBA, MESH22, "ep_tp_fsdp", 8),
]
JAMBA_REMAT = plan_case("grad", JAMBA, MESH22, "tp_dp_train", capacity=8)["id"]
STEPS = [(RWKV, "tp_dp_train", None, "adamw"),
         (JAMBA, "ep_tp_fsdp", 8, "adafactor")]
CASES = ([plan_case("grad", a, m, p, capacity=c) for a, m, p, c in GRADS]
         # jamba's tp_dp_train inputs, without remat
         + [plan_case("grad", JAMBA, MESH22, "tp_dp_noremat", capacity=8,
                      inputs_from=JAMBA_REMAT, port_only=True)]
         # jamba's step shares the ep_tp_fsdp grad case's compile in the
         # oracle (``shared_grad``)
         + [plan_case("step", a, MESH22, p, capacity=c, opt=o,
                      shared_grad=a == JAMBA)
            for a, p, c, o in STEPS])
GRAD_IDS = [c["id"] for c in CASES if c["kind"] == "grad"
            and not c.get("port_only")]
STEP_IDS = [c["id"] for c in CASES if c["kind"] == "step"]
JAMBA_NO_REMAT = CASES[len(GRADS)]["id"]
# Mamba's per-channel leaves (dt_bias, a_log, d_skip, the conv, the
# projections): their gradients carry ~5-9e-6 of their largest value in
# float-order noise between any two of the four functions (the port and
# the reference, sharded and not; the reference runs an associative scan),
# which the squares in Adafactor's moments double.  The largest moment
# gaps measured on this case: port sharded against JAX sharded 1.22e-5,
# against the port unsharded 3.75e-5; JAX sharded against the port
# unsharded 2.70e-5 (vc of blocks.1.mixer.dt_bias).  STEP_MOMENT_TOL
# (1e-5) holds every other leaf; these are held to MAMBA_MOMENT_TOL, about
# twice the gap between the two references.
MAMBA_MOMENT_TOL = 5e-5
MAMBA_LEAVES = {"in_proj", "conv_w", "conv_b", "bcdt_proj", "dt_bias",
                "a_log", "d_skip", "out_proj"}


def _moment_tol(name: str) -> float:
    part = name.split(".")
    mamba = len(part) > 3 and part[2] == "mixer" and part[3] in MAMBA_LEAVES
    return MAMBA_MOMENT_TOL if mamba else STEP_MOMENT_TOL
RWKV_GRAD_IDS = [c["id"] for c in CASES if c["kind"] == "grad"
                 and c["arch"] == RWKV]


@pytest.fixture(scope="module")
def results(tmp_path_factory):
    return run_cases([dict(c) for c in CASES],
                     tmp_path_factory.mktemp("sharded_recurrent_train"))


@pytest.mark.parametrize("cid", GRAD_IDS)
def test_loss_and_grads_match_jax_sharded_and_port_unsharded(results, cid):
    check_loss_and_grads(results, cid)


@pytest.mark.parametrize("cid", STEP_IDS)
def test_train_steps_match_jax_sharded_and_port_unsharded(results, cid):
    check_train_steps(results, cid)


def test_adafactor_moments_after_one_step(results):
    """jamba-1.5-large-398b under ep_tp_fsdp: every stacked leaf's row and
    column factors after the first step, gathered (Mamba's within
    MAMBA_MOMENT_TOL, every other leaf within STEP_MOMENT_TOL:
    ``_moment_tol``)."""
    check_adafactor_moments(results, STEP_IDS[1], _moment_tol)


def test_mamba_remat_changes_no_loss_or_gradient(results):
    """jamba under tp_dp_train with and without remat, on one batch: the
    recomputed forward replays in_proj's column gather and the B, C, dt
    psum, so the loss and every gradient are equal bit for bit."""
    port = results["port"]
    for name in ("loss", "nll", "lb_loss"):
        assert port[f"{JAMBA_REMAT}/{name}"] == port[f"{JAMBA_NO_REMAT}/{name}"]
    got, want = (port_arrays(port, f"{c}/grad")
                 for c in (JAMBA_REMAT, JAMBA_NO_REMAT))
    assert set(got) == set(want)
    for name in want:
        np.testing.assert_array_equal(got[name], want[name], err_msg=name)


@pytest.mark.parametrize("cid", RWKV_GRAD_IDS)
def test_k4_runs_on_this_ranks_heads_under_grad(results, cid):
    """Each rank calls K4's wrapper (its plain version here, under
    autograd) on its batch shard's rows and all S positions, over 4 /
    (model-axis size) of the 4 reduced heads: once a layer, and once more
    in the backward's recompute under remat."""
    case = results["cases"][cid]
    sizes = dict(zip(("data", "model"), case["mesh"]))
    plan = case["plan"]
    heads = 4 // (sizes[plan["model_axis"]] if plan.get("model_axis") else 1)
    rows = B
    for a in plan.get("batch_axes", []):
        rows //= sizes[a]
    layers = 2 * (2 if plan.get("remat") else 1)
    for rank in range(4):
        calls = results["calls"][rank][cid].get("wkv6", [])
        assert calls == [{"b": rows, "t": S, "h": heads}] * layers, rank
