"""Harness of the sharded serve tests (``test_torch_sharded_*.py``): the
port's multi-device serve path on 4 gloo ranks on the CPU, held to the JAX
package's sharded functions on an ``Auto`` mesh of 4 placeholder devices
and to the port's unsharded functions, on the same numpy weights and
inputs.

``run_cases(cases, tmp)`` draws each arch's weights once with the JAX
package's initialiser (f32, numpy), writes them, the inputs and the spec
to ``tmp``, runs the 4 port ranks (``torch_sharded_port.rank_main``),
then the JAX oracle subprocess (``torch_sharded_jax.py``) and, while it
runs, the unsharded port on every case in this process; every wait is
bounded.  It returns the three sets of results and each rank's log of
kernel-wrapper calls.

Plans are built as the deployer's ``candidate_plans`` builds them, on the
meshes {data: 2, model: 2} and {data: 1, model: 4}.
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
from repro.models import api as jax_api
from repro_torch.distributed.ranks import run_ranks

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
}
# chatglm2-6b with its full config's 2 KV heads: model = 2 takes head-TP
OVERRIDES = {"chatglm2-6b": {"n_kv_heads": 2}}
B, S, CACHE_LEN, STEPS = 4, 16, 20, 3
KV_LEN = [16, 9, 13, 5]
ENGINE_CACHE = 32
PROMPT_LENS = [5, 16, 9, 12, 7, 14]
NEW = [6, 4, 5, 6, 3, 5]
TIMEOUT = 240.0


def plan_case(kind, arch, mesh, plan, capacity=None, **extra):
    over = OVERRIDES.get(arch, {})
    cid = f"{kind}-{arch}-{plan}-{mesh[0]}x{mesh[1]}"
    if capacity is not None:
        cid += f"-cf{capacity:g}"
    if extra.get("n_prompts"):
        cid += f"-b{extra['n_prompts']}"
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


def _inputs(case, cfg, rng, inputs):
    cid = case["id"]
    if case["kind"] == "logits":
        inputs[f"{cid}/tokens"] = rng.integers(2, cfg.vocab_size, (B, S)).astype(np.int32)
        inputs[f"{cid}/kv_len"] = np.array(KV_LEN, np.int32)
        inputs[f"{cid}/steps"] = rng.integers(
            2, cfg.vocab_size, (STEPS, B, 1)).astype(np.int32)
        case["cache_len"] = CACHE_LEN
    elif case["kind"] in ("engine", "continuous"):
        n = case.get("n_prompts") or (4 if case["kind"] == "engine"
                                      else len(PROMPT_LENS))
        case["prompts"] = [rng.integers(2, cfg.vocab_size, ln).tolist()
                           for ln in PROMPT_LENS[:n]]
        case["new"] = NEW[:n]
        case["max_batch"] = 4
        case["cache_len"] = ENGINE_CACHE
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
    # the ranks first, then the oracle beside the unsharded port (one
    # torch thread, as each rank): the file never loads more than ~4 cores
    # of the 6-worker test run at once
    run_ranks(port.rank_main, (str(spec), str(tmp)), world=4, timeout=60.0,
              join_timeout=TIMEOUT)
    plain_arrays, plain_tokens = {}, {}
    with open(tmp / "jax.log", "w") as log:
        oracle = subprocess.Popen(
            [sys.executable, str(HERE / "torch_sharded_jax.py"), str(spec),
             str(tmp)], stdout=log, stderr=subprocess.STDOUT, env=env)
        try:
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
    return {
        "cases": {c["id"]: c for c in cases},
        "jax": jax_arrays, "jax_tokens": json.loads((tmp / "jax.json").read_text()),
        "port": port_arrays, "port_tokens": json.loads((tmp / "port.json").read_text()),
        "plain": plain_arrays, "plain_tokens": plain_tokens,
        "calls": [json.loads((tmp / f"calls{r}.json").read_text()) for r in range(4)],
    }


def max_err(a, b) -> float:
    return float(np.abs(np.asarray(a, np.float64) - np.asarray(b, np.float64)).max())
