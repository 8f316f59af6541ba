"""The JAX package's dry run as the oracle of the port's
(``tests/test_torch_dryrun.py``).

    python torch_dryrun_jax.py SPEC.json OUT.json

On 4 placeholder CPU devices, a mesh of ``Auto`` axes {data: 2, model: 2}
(``jax.make_mesh`` defaults to ``Explicit`` axes in JAX 0.9, under which
the reference's sharded code fails) replaces the reference's production
mesh in this process alone, and its ``lower_cell`` lowers and compiles
each of SPEC's reduced cells (LLVM at -O0: compiles are the cost).  For
each it writes the argument bytes a device, the bytes of the batch inputs'
shards and the analytic terms.  For SPEC's full-width cells it writes the
shard arithmetic of ``param_specs``, ``cache_specs_tree`` and
``opt_state_specs`` on ``jax.eval_shape`` structures over the production
mesh's shape (no compile), and for every cell the reference's
``pick_plan`` at TPU v5e (its default) with its ``analytic`` terms.
"""
import os

os.environ["XLA_FLAGS"] = ("--xla_force_host_platform_device_count=4 "
                           "--xla_backend_optimization_level=0")
os.environ.setdefault("JAX_PLATFORMS", "cpu")

import dataclasses  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import sys  # noqa: E402
import time  # noqa: E402

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from jax.sharding import AxisType, NamedSharding  # noqa: E402
from jax.sharding import PartitionSpec as P  # noqa: E402

jax.devices()       # fixes the device count before the dry run sets its own

from repro.configs import SHAPES, cell_is_runnable, get_config  # noqa: E402
from repro.configs.base import ShapeConfig  # noqa: E402
from repro.launch import dryrun  # noqa: E402
from repro.models import api  # noqa: E402
from repro.perf.cost_model import step_cost  # noqa: E402
from repro.sharding.specs import cache_specs_tree, param_specs  # noqa: E402
from repro.training import OptConfig, init_opt_state  # noqa: E402
from repro.training import opt_state_specs  # noqa: E402

MESH = jax.make_mesh((2, 2), ("data", "model"),
                     axis_types=(AxisType.Auto, AxisType.Auto))
PRODUCTION = {False: {"data": 16, "model": 16},
              True: {"pod": 2, "data": 16, "model": 16}}


def analytic(cfg, shape, desc) -> dict:
    """The record's ``analytic`` as ``lower_cell`` builds it."""
    ct = step_cost(cfg, shape, desc)
    return {"flops_chip": ct.flops, "hbm_bytes_chip": ct.hbm_bytes,
            "coll_bytes_chip": ct.coll_bytes, "model_flops": ct.model_flops,
            "weight_bytes_chip": ct.weight_bytes_chip,
            "kv_bytes_chip": ct.kv_bytes_chip,
            "hbm_resident_chip": ct.hbm_resident,
            "times_s": ct.times(), "bottleneck": ct.bottleneck()}


def absorbed(mp):
    """The hillclimb's absorbed-MLA step of a plan."""
    return dataclasses.replace(
        mp, plan=dataclasses.replace(mp.plan, mla_absorbed=True),
        desc=dataclasses.replace(mp.desc, mla_absorbed=True))


def batch_shard_bytes(cfg, shape, plan) -> int:
    """Bytes a device of the cell's batch inputs as ``lower_cell`` places
    them: each leaf over the plan's batch axes, a train step's scalar step
    replicated."""
    ba = plan.batch_axes if len(plan.batch_axes) > 1 else \
        (plan.batch_axes[0] if plan.batch_axes else None)
    specs = api.input_specs(cfg, shape, dtype=jnp.bfloat16)
    leaves = jax.tree.leaves(specs["batch"]) if shape.kind != "decode" \
        else [specs["tokens"]]
    if shape.kind != "train":
        leaves.append(specs["kv_len"])
    total = 4 if shape.kind == "train" else 0
    for x in leaves:
        local = NamedSharding(MESH, P(ba)).shard_shape(x.shape)
        total += math.prod(local) * x.dtype.itemsize
    return total


def reduced_cell(case) -> dict:
    cfg = get_config(case["arch"]).reduced()
    shape = ShapeConfig(f"dry_{case['kind']}", case["seq"], case["batch"],
                        case["kind"])
    mp = dryrun.pick_plan(cfg, shape, multi_pod=False, which="baseline")
    if case.get("mla_absorbed"):
        mp = absorbed(mp)
    orig = dryrun.pick_plan
    dryrun.pick_plan = lambda *a, **k: mp
    try:
        t0 = time.perf_counter()
        rec = dryrun.lower_cell(cfg, shape, multi_pod=False, verbose=False)
    finally:
        dryrun.pick_plan = orig
    return {"plan": rec["plan"],
            "argument_bytes":
                rec["memory_analysis"]["argument_size_in_bytes"],
            "batch_bytes": batch_shard_bytes(cfg, shape, mp.plan),
            "analytic": rec["analytic"], "s": time.perf_counter() - t0}


def shard_bytes(structs, specs, mesh_shape) -> int:
    """Bytes a device of the leaves of ``structs`` under ``specs``."""
    leaves = jax.tree.leaves(structs)
    spec_leaves = jax.tree.leaves(specs, is_leaf=lambda s: isinstance(s, P))
    assert len(leaves) == len(spec_leaves)
    total = 0
    for x, spec in zip(leaves, spec_leaves):
        n = math.prod(x.shape) * x.dtype.itemsize
        for entry in spec:
            for ax in ((entry,) if isinstance(entry, str) else (entry or ())):
                n //= mesh_shape[ax]
        total += n
    return total


def full_cell(case) -> dict:
    cfg, shape = get_config(case["arch"]), SHAPES[case["shape"]]
    mshape = PRODUCTION[case["multi_pod"]]
    mp = dryrun.pick_plan(cfg, shape, multi_pod=case["multi_pod"],
                          which="baseline")
    if case.get("plan") is not None:
        mp = {c.name: c for c in dryrun.candidate_plans(
            cfg, shape, multi_pod=case["multi_pod"])}[case["plan"]]
    if case.get("mla_absorbed"):
        mp = absorbed(mp)
    params = jax.eval_shape(
        lambda: api.init_params(cfg, jax.random.PRNGKey(0), jnp.bfloat16))
    pspecs = param_specs(cfg, mp.plan, params, mshape)
    out = {"plan": mp.name, "params": shard_bytes(params, pspecs, mshape)}
    if shape.kind == "train":
        opt = OptConfig(kind=mp.desc.optimizer)
        ostruct = jax.eval_shape(lambda: init_opt_state(params, opt))
        out["opt_state"] = shard_bytes(ostruct, opt_state_specs(pspecs, opt),
                                       mshape)
    if shape.kind == "decode":
        dtype = jnp.int8 if case.get("int8_cache") else jnp.bfloat16
        cache = jax.tree.map(
            lambda x: jax.ShapeDtypeStruct(x.shape, dtype)
            if x.dtype == jnp.bfloat16 else x,
            api.cache_specs(cfg, shape.global_batch, shape.seq_len,
                            dtype=jnp.bfloat16))
        out["cache"] = shard_bytes(
            cache, cache_specs_tree(cfg, mp.plan, cache, mshape), mshape)
    return out


def plans(archs) -> list:
    """Every runnable cell's ``pick_plan`` on both meshes, both kinds."""
    out = []
    for arch in archs:
        cfg = get_config(arch)
        for name, shape in SHAPES.items():
            if not cell_is_runnable(cfg, shape)[0]:
                continue
            for multi_pod in (False, True):
                for which in ("baseline", "helr"):
                    mp = dryrun.pick_plan(cfg, shape, multi_pod=multi_pod,
                                          which=which)
                    out.append({"arch": arch, "shape": name,
                                "multi_pod": multi_pod, "which": which,
                                "name": mp.name,
                                "plan": dataclasses.asdict(mp.plan),
                                "desc": dataclasses.asdict(mp.desc),
                                "analytic": analytic(cfg, shape, mp.desc)})
    return out


def main(spec_path, out_path):
    spec = json.loads(open(spec_path).read())
    dryrun.make_production_mesh = lambda multi_pod=False: MESH
    out = {"reduced": [reduced_cell(c) for c in spec["reduced"]],
           "full": [full_cell(c) for c in spec["full"]],
           "plans": plans(spec["archs"])}
    with open(out_path, "w") as f:
        json.dump(out, f)


if __name__ == "__main__":
    main(*sys.argv[1:])
