"""Harness of the sharded tests (``test_torch_sharded_*.py``): the port's
multi-device serve and train paths on 4 gloo ranks on the CPU, held to the
JAX package's sharded functions on an ``Auto`` mesh of 4 placeholder
devices and to the port's unsharded functions, on the same numpy weights
and inputs.

``run_cases(cases, tmp)`` draws each arch's weights once with the JAX
package's initialiser (f32, numpy), writes them, the inputs and the spec
to ``tmp``, starts the JAX oracle subprocess (``torch_sharded_jax.py``)
and, while it runs, the 4 port ranks (``torch_sharded_port.rank_main``)
and then the unsharded port on every case in this process; every wait is
bounded.  It returns the three sets of results and each rank's log of
kernel-wrapper calls.

Plans are built as the deployer's ``candidate_plans`` builds them, on the
meshes {data: 2, model: 2} and {data: 1, model: 4}.  The train cases
(``grad``: the loss and every gradient; ``step``: three train steps;
``opt``: two optimizer updates on given gradients; ``compress``:
``dp_mean_compressed`` over data) take the train form of
each plan (``remat``, ``seq_parallel``, no sequence axes).  A case marked
``port_only`` runs on the port's ranks and unsharded alone, not in the
oracle (the port against itself, e.g. with and without remat).  A step
case marked ``shared_grad`` runs in the oracle as the reference's train
step in two programs, the gradients compiled once for it and a grad case
of the same model and plan (``torch_sharded_jax.shared_grad_step``).  A ``paged``
case serves one request set through ``PagedEngine`` (its ``variant``:
``PAGED_VARIANTS``), or shows where a plan makes it raise.
"""
import dataclasses
import json
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import torch

from repro.configs import get_config as jax_get_config
from repro.data.workload import (SharedPrefixConfig, WorkloadConfig,
                                 gen_requests, gen_shared_prefix_requests)
from repro.models import api as jax_api
from repro_torch.distributed.ranks import run_ranks
from repro_torch.params import from_jax_params, from_jax_tree, to_jax_tree

import torch_sharded_port as port

HERE = Path(__file__).resolve().parent
SRC = HERE.parent / "src"
MESH22, MESH14 = (2, 2), (1, 4)
# the plans of ``candidate_plans`` on a (data, model) mesh, by name
PLANS = {
    # tp16_dp16, decode form: KV sequence over model
    "tp_dp": dict(batch_axes=["data"], model_axis="model",
                  seq_axes=["model"], mla_absorbed=False),
    # tp16_dp16, prefill form: sequence-parallel residual
    "tp_dp_sp": dict(batch_axes=["data"], model_axis="model",
                     seq_parallel=True, mla_absorbed=False),
    "ep_tp": dict(batch_axes=["data"], model_axis="model", ep_axis="data",
                  seq_axes=["model"], mla_absorbed=False),
    "longctx_seqshard": dict(batch_axes=[], model_axis="model",
                             mla_absorbed=False, seq_axes=["data", "model"]),
    "longctx_ep": dict(batch_axes=[], model_axis="model", mla_absorbed=False,
                       ep_axis="data", seq_axes=["model"]),
    "dp": dict(batch_axes=["data", "model"]),
    # tests/sharded_numerics_worker.py's plan (absorbed MLA decode)
    "worker": dict(batch_axes=["data"], model_axis="model",
                   seq_axes=["model"]),
    # the train forms: tp16_dp16[_fsdp][_mbN], ep16_tp16_fsdp, dp
    "tp_dp_train": dict(batch_axes=["data"], model_axis="model",
                        seq_parallel=True, mla_absorbed=False, remat=True),
    "tp_dp_noremat": dict(batch_axes=["data"], model_axis="model",
                          seq_parallel=True, mla_absorbed=False),
    "tp_dp_fsdp": dict(batch_axes=["data"], model_axis="model",
                       fsdp_axes=["data"], seq_parallel=True,
                       mla_absorbed=False, remat=True),
    "tp_dp_fsdp_mb2": dict(batch_axes=["data"], model_axis="model",
                           fsdp_axes=["data"], seq_parallel=True,
                           mla_absorbed=False, remat=True, microbatches=2),
    "ep_tp_fsdp": dict(batch_axes=["data"], model_axis="model",
                       ep_axis="data", fsdp_axes=["data"], seq_parallel=True,
                       mla_absorbed=False, remat=True),
    "dp_train": dict(batch_axes=["data", "model"], remat=True),
}
# chatglm2-6b with its full config's 2 KV heads: model = 2 takes head-TP
OVERRIDES = {"chatglm2-6b": {"n_kv_heads": 2}}
B, S, CACHE_LEN, STEPS = 4, 16, 20, 3
KV_LEN = [16, 9, 13, 5]
ENGINE_CACHE = 32
PROMPT_LENS = [5, 16, 9, 12, 7, 14]
NEW = [6, 4, 5, 6, 3, 5]
TIMEOUT = 240.0
TRAIN_STEPS = 3
# the paged cases' engine config (tests/test_torch_paged_engine.py's) and,
# per variant, the changes to it
PAGED_PCFG = dict(max_batch=4, block_size=8, n_blocks=64, max_seq_len=64,
                  max_new_tokens=12)
PAGED_VARIANTS = {
    "plain": {},
    "spec": dict(spec_tokens=4),
    "b3": dict(max_batch=3),
    "b3_spec": dict(max_batch=3, spec_tokens=4),
    "preempt": dict(n_blocks=10, max_seq_len=32, max_new_tokens=8,
                    preempt=True),
    "waves": dict(prefix_cache=True, chunk_tokens=8),
    "prefix": dict(prefix_cache=True),
}
WAVE_NEW = 4          # new tokens at the end of each second-wave prompt
# the first-wave request each second-wave one extends
WAVE_ORDER = [3, 2, 1, 0]


def plan_case(kind, arch, mesh, plan, capacity=None, **extra):
    over = OVERRIDES.get(arch, {})
    cid = f"{kind}-{arch}-{plan}-{mesh[0]}x{mesh[1]}"
    if capacity is not None:
        cid += f"-cf{capacity:g}"
    if extra.get("n_prompts"):
        cid += f"-b{extra['n_prompts']}"
    if extra.get("opt"):
        cid += f"-{extra['opt']}"
    if extra.get("variant"):
        cid += f"-{extra['variant']}"
    return dict(id=cid, kind=kind, arch=arch, over=over, mesh=list(mesh),
                plan=PLANS[plan], plan_name=plan, capacity=capacity, **extra)


def _jax_cfg(case):
    cfg = dataclasses.replace(jax_get_config(case["arch"]).reduced(),
                              **case["over"])
    if case.get("capacity") is not None:
        cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
            cfg.moe, capacity_factor=case["capacity"]))
    return cfg


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}/"))
        else:
            out[f"{prefix}{k}"] = np.asarray(v)
    return out


def _frames(cfg, rng) -> dict:
    """An encoder-decoder's seeded frames [B, F, d] (x 0.02, as the
    reference's smoke tests draw them); nothing for another family."""
    if not cfg.is_encdec:
        return {}
    return {"frames": (rng.standard_normal((B, cfg.cross_kv_len, cfg.d_model))
                       * 0.02).astype(np.float32)}


def _train_batch(cfg, rng, n_shards: int) -> dict:
    """tokens, their next tokens as labels, and a mask whose count is the
    same in each of ``n_shards`` equal row blocks (then a batch-sharded MoE
    loss is the mean of the unsharded loss over the blocks); an
    encoder-decoder's frames besides."""
    toks = rng.integers(2, cfg.vocab_size, (B, S)).astype(np.int32)
    mask = (rng.random((B // n_shards, S)) > 0.2).astype(np.float32)
    mask = np.concatenate([np.roll(mask, i, 1) for i in range(n_shards)])
    return {"tokens": toks, "labels": np.roll(toks, -1, 1), "mask": mask,
            **_frames(cfg, rng)}


def _shards(case) -> int:
    """The batch shards of a case's plan on its mesh."""
    sizes = dict(zip(("data", "model"), case["mesh"]))
    return int(np.prod([sizes[a] for a in case["plan"].get("batch_axes", [])]))


def _request_rows(cfg, variant: str) -> list:
    """A variant's requests as [rid, tokens, true_output_len, slo,
    arrival] rows."""
    rng = np.random.default_rng(3)
    if variant in ("plain", "b3"):
        # tests/test_paged_engine.py's _reqs: 10-token prompts, 1-8 new
        reqs = gen_requests(WorkloadConfig(n_requests=7, seed=5,
                                           vocab=cfg.vocab_size))
        return [[r.rid, [t % cfg.vocab_size for t in r.tokens[:10]],
                 r.true_output_len % 8 + 1, r.slo, r.arrival] for r in reqs]
    if variant in ("spec", "b3_spec"):
        # repeated 6-token patterns: the n-gram drafter's drafts are taken
        rows = []
        for i in range(6):
            pat = rng.integers(1, cfg.vocab_size, 6).tolist()
            rows.append([i, (pat * 4)[:20], int(rng.integers(4, 12)), 60.0, 0.0])
        return rows
    if variant == "preempt":
        # three slack residents hold the blocks; tighter requests wait on
        # them with a slot free, and evict the slackest
        lens = [16, 16, 16, 8, 8, 8]
        outs = [8, 8, 8, 2, 4, 4]
        slos = [1000.0, 999.0, 998.0, 900.0, 0.001, 0.002]
        return [[i, rng.integers(1, cfg.vocab_size, n).tolist(), o, s, 0.0]
                for i, (n, o, s) in enumerate(zip(lens, outs, slos))]
    if variant == "waves":
        reqs = gen_shared_prefix_requests(SharedPrefixConfig(
            n_requests=4, n_templates=2, prefix_len=16, suffix_mean=2.0,
            vocab=cfg.vocab_size, seed=0))
        return [[r.rid, [t % cfg.vocab_size for t in r.tokens[:32]],
                 3 + r.true_output_len % 6, r.slo, r.arrival] for r in reqs]
    # "prefix": two 24-token templates with 8-token suffixes
    tmpl = [rng.integers(0, cfg.vocab_size, 24).tolist() for _ in range(2)]
    return [[i, tmpl[i % 2] + rng.integers(0, cfg.vocab_size, 8).tolist(),
             int(rng.integers(2, 8)), 10.0, float(i)] for i in range(6)]


def _paged_inputs(case, cfg) -> None:
    """A paged case's requests and engine config.  The ``waves`` variant
    queues a second wave behind the first in the same run: second-wave
    request j extends first-wave request ``WAVE_ORDER[j]`` with the tokens
    the port's unsharded engine generated for it there (the first wave
    alone), then WAVE_NEW new tokens, so its prefix hit reaches blocks that
    decode steps wrote."""
    case["pcfg"] = {**PAGED_PCFG, **PAGED_VARIANTS[case.get("variant", "plain")]}
    rows = _request_rows(cfg, case.get("variant", "plain"))
    if case.get("variant") == "waves":
        cfg_p, model = port.load_model(case)
        first = port.paged_serve(case, cfg_p, model, None, rows)["outputs"]
        rng = np.random.default_rng(4)
        n = len(rows)
        for j, i in enumerate(WAVE_ORDER):
            rid, toks, out, slo, arr = rows[i]
            rows.append([n + j, toks + first[str(rid)]
                         + rng.integers(0, cfg.vocab_size, WAVE_NEW).tolist(),
                         out, slo, arr])
    case["reqs"] = rows


def _inputs(case, cfg, rng, inputs):
    cid = case["id"]
    if case["kind"] == "logits":
        inputs[f"{cid}/tokens"] = rng.integers(2, cfg.vocab_size, (B, S)).astype(np.int32)
        inputs[f"{cid}/kv_len"] = np.array(KV_LEN, np.int32)
        inputs[f"{cid}/steps"] = rng.integers(
            2, cfg.vocab_size, (STEPS, B, 1)).astype(np.int32)
        for k, v in _frames(cfg, rng).items():
            inputs[f"{cid}/{k}"] = v
        case["cache_len"] = CACHE_LEN
    elif case["kind"] in ("engine", "continuous"):
        n = case.get("n_prompts") or (4 if case["kind"] == "engine"
                                      else len(PROMPT_LENS))
        case["prompts"] = [rng.integers(2, cfg.vocab_size, ln).tolist()
                           for ln in PROMPT_LENS[:n]]
        case["new"] = NEW[:n]
        case["max_batch"] = 4
        case["cache_len"] = ENGINE_CACHE
    elif case["kind"] == "paged":
        _paged_inputs(case, cfg)
    elif case.get("inputs_from"):
        src = case["inputs_from"] + "/"
        for key in [k for k in inputs if k.startswith(src)]:
            inputs[cid + "/" + key[len(src):]] = inputs[key]
        case["per_shard"] = _shards(case) if cfg.moe is not None else 1
        case["steps"] = 1
    elif case["kind"] in ("grad", "step"):
        # a batch-sharded MoE is the mean of the unsharded function over
        # the batch shards, not the function of the whole batch
        case["per_shard"] = _shards(case) if cfg.moe is not None else 1
        case["steps"] = TRAIN_STEPS if case["kind"] == "step" else 1
        for i in range(case["steps"]):
            for k, v in _train_batch(cfg, rng, case["per_shard"]).items():
                inputs[f"{cid}/{i}/{k}"] = v
    elif case["kind"] == "opt":
        # two updates, each on gradients drawn here: the optimizer on
        # identical inputs, in the port's names and the reference's tree
        cfg_p, model = port.load_model(case)
        for i in range(2):
            grads = {n: (rng.standard_normal(tuple(t.shape)) * 1e-2)
                     .astype(np.float32) for n, t in model.state_dict().items()}
            for name, g in grads.items():
                inputs[f"{cid}/{i}/g/{name}"] = g
            for path, g in _flat(to_jax_tree(cfg_p, grads)).items():
                inputs[f"{cid}/{i}/jg/{path}"] = g
    elif case["kind"] == "compress":
        # each data rank's own gradient: the unsharded port's on its rows
        cfg_p, model = port.load_model(case)
        model.requires_grad_(True)
        batch = _train_batch(cfg, rng, 1)
        n = case["mesh"][0]
        for i in range(n):
            rows = {k: torch.as_tensor(v[i * B // n:(i + 1) * B // n])
                    for k, v in batch.items()}
            _, _, grads = port.value_and_grad(cfg_p, None, model, rows)
            for name, g in grads.items():
                inputs[f"{cid}/g{i}/{name}"] = g.numpy()
    else:
        inputs[f"{cid}/x"] = rng.standard_normal(
            (B, S, cfg.d_model)).astype(np.float32)


def run_cases(cases, tmp) -> dict:
    tmp = Path(tmp)
    rng = np.random.default_rng(0)
    inputs, weights = {}, {}
    for case in cases:
        cfg = _jax_cfg(case)
        wkey = f"{case['arch']}-{json.dumps(case['over'], sort_keys=True)}"
        if wkey not in weights:
            weights[wkey] = tmp / f"w{len(weights)}.npz"
            params = jax_api.init_params(cfg, jax.random.PRNGKey(0), jnp.float32)
            np.savez(weights[wkey], **_flat(params))
        case["weights"] = str(weights[wkey])
        _inputs(case, cfg, rng, inputs)
    np.savez(tmp / "inputs.npz", **inputs)
    spec = tmp / "spec.json"
    spec.write_text(json.dumps({"cases": cases, "inputs": str(tmp / "inputs.npz")}))

    env = dict(os.environ, PYTHONPATH=str(SRC), JAX_PLATFORMS="cpu")
    env.pop("XLA_FLAGS", None)
    # the oracle (compiles, one core) beside the 4 ranks, then beside the
    # unsharded port (one torch thread, as each rank): the file loads at
    # most ~5 cores of the 6-worker test run at once
    plain_arrays, plain_tokens = {}, {}
    with open(tmp / "jax.log", "w") as log:
        oracle = subprocess.Popen(
            [sys.executable, str(HERE / "torch_sharded_jax.py"), str(spec),
             str(tmp)], stdout=log, stderr=subprocess.STDOUT, env=env)
        try:
            run_ranks(port.rank_main, (str(spec), str(tmp)), world=4,
                      timeout=60.0, join_timeout=TIMEOUT)
            threads = torch.get_num_threads()
            torch.set_num_threads(1)
            try:
                for case in cases:
                    cfg, model = port.load_model(case)
                    port.run_case(case, cfg, model, None, inputs,
                                  plain_arrays, plain_tokens)
            finally:
                torch.set_num_threads(threads)
            rc = oracle.wait(timeout=TIMEOUT)
        finally:
            if oracle.poll() is None:
                oracle.kill()
                oracle.wait()
    if rc != 0:
        raise RuntimeError("JAX oracle failed:\n" + (tmp / "jax.log").read_text()[-3000:])
    with np.load(tmp / "jax.npz") as f:
        jax_arrays = {k: f[k] for k in f.files}
    with np.load(tmp / "port.npz") as f:
        port_arrays = {k: f[k] for k in f.files}
    paged = {}
    if any(c["kind"] == "paged" for c in cases):
        for r in range(4):
            with np.load(tmp / f"pools{r}.npz") as f:
                pools = {k: f[k] for k in f.files}
            paged[r] = {"run": json.loads((tmp / f"paged{r}.json").read_text()),
                        "pools": pools}
    return {
        "paged": paged,
        "cases": {c["id"]: c for c in cases},
        "jax": jax_arrays, "jax_tokens": json.loads((tmp / "jax.json").read_text()),
        "port": port_arrays, "port_tokens": json.loads((tmp / "port.json").read_text()),
        "plain": plain_arrays, "plain_tokens": plain_tokens,
        "calls": [json.loads((tmp / f"calls{r}.json").read_text()) for r in range(4)],
    }


def jax_tree_of(arrays: dict, prefix: str) -> dict:
    """The nested tree of the arrays keyed ``prefix/a/b/...``."""
    tree = {}
    for key, val in arrays.items():
        if key.startswith(prefix + "/"):
            node = tree
            *parents, leaf = key[len(prefix) + 1:].split("/")
            for part in parents:
                node = node.setdefault(part, {})
            node[leaf] = val
    return tree


def port_arrays(arrays: dict, prefix: str) -> dict:
    """The arrays keyed ``prefix/NAME``, by NAME."""
    return {k[len(prefix) + 1:]: v for k, v in arrays.items()
            if k.startswith(prefix + "/")}


def max_err(a, b) -> float:
    return float(np.abs(np.asarray(a, np.float64) - np.asarray(b, np.float64)).max())


# The train cases' tolerances (``check_loss_and_grads``,
# ``check_train_steps``, ``check_adafactor_moments``)
LOSS_RTOL = 1e-5        # loss, nll, lb_loss
GRAD_TOL = 1e-4         # each gradient leaf, x its largest magnitude
GRAD_ATOL = 1e-8
NORM_RTOL = 1e-4        # grad_norm
# Adafactor's moments after a train step, each leaf within this x its
# largest value against the JAX package and against the unsharded port.
# They are means of squared gradients that differ at float order (summed
# over ranks in another order), so the optimizer's 1e-6 on given gradients
# is out of reach: the largest gaps measured on qwen2-moe-a2.7b under
# ep_tp_fsdp are 1.75e-6 (JAX), 1.85e-6 (unsharded port) and, between the
# two unsharded functions, 1.96e-6
STEP_MOMENT_TOL = 1e-5


def rel_err(a, b) -> float:
    return abs(float(a) - float(b)) / abs(float(b))


def assert_leaves(got: dict, want: dict, tol, what: str):
    """Each leaf within ``tol`` (a number, or a function of the leaf's
    name) x its largest magnitude."""
    assert set(got) == set(want) and len(got) > 10, what
    for key, v in want.items():
        err = max_err(got[key], v)
        t = tol(key) if callable(tol) else tol
        assert err <= t * np.abs(v).max(), (what, key, err)


def assert_grads(got: dict, want: dict, what: str):
    assert set(got) == set(want), what
    for name, ref in want.items():
        tol = GRAD_TOL * np.abs(ref).max() + GRAD_ATOL
        err = max_err(got[name], ref)
        assert err <= tol, (what, name, err, tol)


def state_of(arrays, cid, part, stacked):
    """A case's ``part`` leaves by port name: the port's as they are
    (``stacked`` None), the reference's tree converted (stacked leaves
    when ``stacked``)."""
    got = port_arrays(arrays, f"{cid}/{part}")
    return got if stacked is None else {
        k: v.numpy() for k, v in (from_jax_tree if stacked else
                                  from_jax_params)(jax_tree_of(arrays, f"{cid}/{part}")).items()}


def check_loss_and_grads(results, cid):
    """A ``grad`` case: the loss and each metric the functions return
    (an MoE's lb_loss, positive) and every gradient leaf, against the JAX
    sharded function and the port's unsharded one."""
    port, ref, plain = results["port"], results["jax"], results["plain"]
    names = [n for n in ("loss", "nll", "lb_loss") if f"{cid}/{n}" in ref]
    assert names[:2] == ["loss", "nll"]
    for name in ("loss", "nll", "lb_loss"):
        assert (f"{cid}/{name}" in port) == (name in names), name
    for name in names:
        for other in (ref, plain):
            if float(other[f"{cid}/{name}"]) == 0.0:      # a dense lb_loss
                assert float(port[f"{cid}/{name}"]) == 0.0
            else:
                assert rel_err(port[f"{cid}/{name}"], other[f"{cid}/{name}"]) \
                    <= LOSS_RTOL, (name, other is ref)
    got = port_arrays(port, f"{cid}/grad")
    want = {k: v.numpy() for k, v in
            from_jax_params(jax_tree_of(ref, f"{cid}/grad")).items()}
    assert_grads(got, want, "jax sharded")
    assert_grads(got, port_arrays(plain, f"{cid}/grad"), "port unsharded")
    if _jax_cfg(results["cases"][cid]).moe is not None:
        assert float(port[f"{cid}/lb_loss"]) > 0


def check_train_steps(results, cid):
    """A ``step`` case: each step's loss and grad_norm against the JAX
    sharded train step and the port's unsharded one; each step's batch
    gives its own loss."""
    port, ref, plain = results["port"], results["jax"], results["plain"]
    losses = []
    for i in range(TRAIN_STEPS):
        for other in (ref, plain):
            assert rel_err(port[f"{cid}/loss{i}"], other[f"{cid}/loss{i}"]) \
                <= LOSS_RTOL, (i, other is ref)
            assert rel_err(port[f"{cid}/grad_norm{i}"],
                           other[f"{cid}/grad_norm{i}"]) <= NORM_RTOL, (i, other is ref)
        losses.append(float(port[f"{cid}/loss{i}"]))
    assert len(set(losses)) == TRAIN_STEPS      # three batches, three losses


def check_adafactor_moments(results, cid, tol=STEP_MOMENT_TOL):
    """An Adafactor ``step`` case: every stacked leaf's row and column
    factors after the first step, gathered (their means psum over the
    sharded dims), within ``tol`` (``assert_leaves``)."""
    port, ref, plain = results["port"], results["jax"], results["plain"]
    for part in ("vr", "vc"):
        got = state_of(port, cid, part, None)
        assert_leaves(got, state_of(ref, cid, part, True), tol, part)
        assert_leaves(got, state_of(plain, cid, part, None), tol, part)
