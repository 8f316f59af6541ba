"""The JAX package's sharded functions on 4 placeholder CPU devices: the
oracle of the port's multi-device serve path (``torch_sharded_harness``).

    python torch_sharded_jax.py SPEC.json OUT_DIR

Runs every case of SPEC (logits, engine, continuous, moe_block) under a
mesh of ``Auto`` axes, the layout the reference's sharded code expects
(``jax.make_mesh`` defaults to ``Explicit`` axes in JAX 0.9, under which
the embedding gather and ``with_sharding_constraint`` fail), with the
parameters placed by ``param_specs``.  Weights and inputs come from the
harness's numpy files; results go to OUT_DIR/jax.npz and jax.json.
"""
import os

# LLVM at -O0: the cases are tiny, so compiling, not running, is their cost
os.environ["XLA_FLAGS"] = ("--xla_force_host_platform_device_count=4 "
                           "--xla_backend_optimization_level=0")
os.environ.setdefault("JAX_PLATFORMS", "cpu")

import dataclasses  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
from jax.sharding import AxisType, NamedSharding  # noqa: E402
from jax.sharding import PartitionSpec as P  # noqa: E402

from repro.configs import get_config  # noqa: E402
from repro.core.types import Batch, Request  # noqa: E402
from repro.models import api, moe  # noqa: E402
from repro.serving.engine import EngineConfig, InferenceEngine  # noqa: E402
from repro.sharding.compat import set_mesh  # noqa: E402
from repro.sharding.plan import ShardingPlan  # noqa: E402
from repro.sharding.specs import param_specs  # noqa: E402


def config(case):
    cfg = dataclasses.replace(get_config(case["arch"]).reduced(), **case["over"])
    if case.get("capacity") is not None:
        cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
            cfg.moe, capacity_factor=case["capacity"]))
    return cfg


def load_tree(path):
    tree = {}
    with np.load(path) as f:
        for key in f.files:
            node = tree
            *parents, leaf = key.split("/")
            for part in parents:
                node = node.setdefault(part, {})
            node[leaf] = f[key]
    return tree


def requests(case):
    return [Request(rid=i, tokens=p, input_len=len(p), slo=1e9, arrival=0.0,
                    true_output_len=n)
            for i, (p, n) in enumerate(zip(case["prompts"], case["new"]))]


def run(case, mesh, inputs, out_arrays, out_json):
    cfg = config(case)
    plan = ShardingPlan(**{k: tuple(v) if isinstance(v, list) else v
                           for k, v in case["plan"].items()})
    # numpy leaves: device_put slices them on the host (a device array
    # would be resliced by a compiled program for every layout)
    params = load_tree(case["weights"])
    mshape = dict(zip(mesh.axis_names, mesh.devices.shape))
    specs = param_specs(cfg, plan, params, mshape)
    params = jax.tree.map(lambda a, s: jax.device_put(a, NamedSharding(mesh, s)),
                          params, specs, is_leaf=lambda s: isinstance(s, P))
    cid = case["id"]
    if case["kind"] == "logits":
        toks = jnp.asarray(inputs[f"{cid}/tokens"])
        kv_len = jnp.asarray(inputs[f"{cid}/kv_len"])
        steps = inputs[f"{cid}/steps"]
        lg, cache = jax.jit(lambda p, t, kl: api.prefill(
            cfg, p, {"tokens": t}, plan=plan, cache_len=case["cache_len"],
            kv_len=kl))(params, toks, kv_len)
        out_arrays[f"{cid}/prefill"] = np.asarray(lg)
        dec = jax.jit(lambda p, t, c, kl: api.decode_step(cfg, p, t, c, kl,
                                                          plan=plan))
        for i, t in enumerate(steps):
            lg, cache = dec(params, jnp.asarray(t), cache, kv_len + i)
            out_arrays[f"{cid}/decode{i}"] = np.asarray(lg)
    elif case["kind"] in ("engine", "continuous"):
        eng = InferenceEngine(cfg, params, EngineConfig(
            max_batch=case["max_batch"], cache_len=case["cache_len"],
            max_new_tokens=max(case["new"])), plan=plan)
        reqs = requests(case)
        if case["kind"] == "engine":
            res = eng.run_batch(Batch(requests=reqs),
                                true_lens={r.rid: r.true_output_len for r in reqs})
        else:
            res = eng.run_continuous(reqs)
        out_json[cid] = {str(k): v for k, v in res.outputs.items()}
    else:   # moe_block: layer 0's MoE block on the case's activations
        x = jnp.asarray(inputs[f"{cid}/x"])
        p = jax.tree.map(lambda a: a[0], params["blocks"]["l0"]["mlp"])
        y, aux = jax.jit(lambda p_, x_: moe.moe_apply(cfg, p_, x_, plan=plan))(p, x)
        out_arrays[f"{cid}/y"] = np.asarray(y)
        out_arrays[f"{cid}/lb_loss"] = np.asarray(aux["lb_loss"])
        out_arrays[f"{cid}/drop_frac"] = np.asarray(aux["drop_frac"])


def main(spec_path, out_dir):
    spec = json.loads(open(spec_path).read())
    out_arrays, out_json = {}, {}
    with np.load(spec["inputs"]) as f:
        inputs = {k: f[k] for k in f.files}
    meshes = {}
    for case in spec["cases"]:
        shape = tuple(case["mesh"])
        if shape not in meshes:
            meshes[shape] = jax.make_mesh(shape, ("data", "model"),
                                          axis_types=(AxisType.Auto,) * 2)
        with set_mesh(meshes[shape]):
            run(case, meshes[shape], inputs, out_arrays, out_json)
    np.savez(os.path.join(out_dir, "jax.npz"), **out_arrays)
    with open(os.path.join(out_dir, "jax.json"), "w") as f:
        json.dump(out_json, f)


if __name__ == "__main__":
    main(*sys.argv[1:3])
