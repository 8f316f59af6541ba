"""The JAX package's sharded functions on 4 placeholder CPU devices: the
oracle of the port's multi-device serve and train paths
(``torch_sharded_harness``).

    python torch_sharded_jax.py SPEC.json OUT_DIR

Runs every case of SPEC (logits, engine, continuous, paged, moe_block,
grad, step, opt, compress) under a mesh of ``Auto`` axes, the layout the
reference's sharded code expects (``jax.make_mesh`` defaults to
``Explicit`` axes in JAX 0.9, under which the embedding gather and
``with_sharding_constraint`` fail), with the parameters placed by ``param_specs``, the optimizer state
by ``opt_state_specs`` and the batch over the plan's batch axes, as
``launch/dryrun.py`` lowers its train step.  Weights and inputs come from
the harness's numpy files; results go to OUT_DIR/jax.npz and jax.json.
"""
import os

# LLVM at -O0: the cases are tiny, so compiling, not running, is their cost
os.environ["XLA_FLAGS"] = ("--xla_force_host_platform_device_count=4 "
                           "--xla_backend_optimization_level=0")
os.environ.setdefault("JAX_PLATFORMS", "cpu")

import dataclasses  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
import time  # noqa: E402

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
from jax.sharding import AxisType, NamedSharding  # noqa: E402
from jax.sharding import PartitionSpec as P  # noqa: E402

from repro.configs import get_config  # noqa: E402
from repro.core.types import Batch, Request  # noqa: E402
from repro.models import api, moe  # noqa: E402
from repro.obs.trace import Tracer  # noqa: E402
from repro.serving import paged_engine  # noqa: E402
from repro.serving.engine import EngineConfig, InferenceEngine  # noqa: E402
from repro.sharding.compat import set_mesh, shard_map  # noqa: E402
from repro.sharding.plan import ShardingPlan  # noqa: E402
from repro.sharding.specs import param_specs  # noqa: E402
from repro.training import OptConfig, TrainConfig  # noqa: E402
from repro.training import init_opt_state, make_train_step  # noqa: E402
from repro.training.grad_compress import dp_mean_compressed  # noqa: E402
from repro.training.optimizer import apply_updates  # noqa: E402
from repro.training.optimizer import opt_state_specs  # noqa: E402


def config(case):
    cfg = dataclasses.replace(get_config(case["arch"]).reduced(), **case["over"])
    if case.get("capacity") is not None:
        cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
            cfg.moe, capacity_factor=case["capacity"]))
    return cfg


def load_tree(path):
    with np.load(path) as f:
        return load_tree_of({k: f[k] for k in f.files}, "")


def load_tree_of(arrays, prefix):
    """The nested tree of the arrays keyed ``prefix/a/b/...`` (every
    array when ``prefix`` is empty)."""
    tree = {}
    for key, val in arrays.items():
        if prefix and not key.startswith(prefix + "/"):
            continue
        node = tree
        *parents, leaf = key[len(prefix) + 1 if prefix else 0:].split("/")
        for part in parents:
            node = node.setdefault(part, {})
        node[leaf] = val
    return tree


def requests(case):
    return [Request(rid=i, tokens=p, input_len=len(p), slo=1e9, arrival=0.0,
                    true_output_len=n)
            for i, (p, n) in enumerate(zip(case["prompts"], case["new"]))]


def _flat(tree, prefix):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}/{k}"))
        else:
            out[f"{prefix}/{k}"] = np.asarray(v)
    return out


def _place(mesh, tree, specs):
    return jax.tree.map(lambda a, s: jax.device_put(a, NamedSharding(mesh, s)),
                        tree, specs, is_leaf=lambda s: isinstance(s, P))


def _batch(mesh, plan, inputs, cid, i=0):
    """Step ``i``'s batch placed over the plan's batch axes: tokens,
    labels, mask and an encoder-decoder's frames."""
    axes = plan.batch_axes if len(plan.batch_axes) > 1 else plan.batch_axes[0]
    return {k: jax.device_put(inputs[f"{cid}/{i}/{k}"],
                              NamedSharding(mesh, P(axes)))
            for k in ("tokens", "labels", "mask", "frames")
            if f"{cid}/{i}/{k}" in inputs}


GRAD_FNS = {}


def grad_fn(cfg, plan):
    """The jitted ``value_and_grad`` of the sharded ``loss_fn``, one per
    model and plan: a grad case and a ``shared_grad`` step case of the
    same model and plan share its compile."""
    if (cfg, plan) not in GRAD_FNS:
        GRAD_FNS[cfg, plan] = jax.jit(jax.value_and_grad(
            lambda p, b: api.loss_fn(cfg, p, b, plan=plan), has_aux=True))
    return GRAD_FNS[cfg, plan]


def shared_grad_step(cfg, plan, tcfg):
    """``make_train_step``'s body at one micro-batch, run as two programs:
    ``grad_fn``'s gradients, then the global-norm clip and
    ``apply_updates``.  Where a grad case has compiled the gradients, the
    step compiles only its update, a small part of a whole step's
    compile."""
    assert tcfg.microbatches == 1
    grads_of = grad_fn(cfg, plan)

    @jax.jit
    def update(params, opt, grads, step):
        gnorm = jnp.sqrt(sum(jnp.sum(g.astype(jnp.float32) ** 2)
                             for g in jax.tree.leaves(grads)))
        scale = jnp.minimum(1.0, tcfg.grad_clip / jnp.maximum(gnorm, 1e-9))
        grads = jax.tree.map(lambda g: g * scale, grads)
        params, opt = apply_updates(params, grads, opt,
                                    step.astype(jnp.float32) + 1.0, tcfg.opt)
        return params, opt, gnorm

    def step_fn(params, opt, batch, step):
        (loss, _), grads = grads_of(params, batch)
        params, opt, gnorm = update(params, opt, grads, step)
        return params, opt, {"loss": loss, "grad_norm": gnorm}
    return step_fn


def run_train(case, cfg, plan, mesh, params, specs, inputs, out):
    """grad: the loss, its metrics and every gradient of the sharded
    ``loss_fn``; step: three steps of the sharded ``make_train_step``, or
    of ``shared_grad_step`` where the case is marked ``shared_grad`` (and
    Adafactor's moments after the first)."""
    cid = case["id"]
    if case["kind"] == "grad":
        (loss, met), grads = grad_fn(cfg, plan)(
            params, _batch(mesh, plan, inputs, cid))
        out[f"{cid}/loss"] = np.asarray(loss)
        for k, v in met.items():      # an encoder-decoder's: nll alone
            out[f"{cid}/{k}"] = np.asarray(v)
        out.update(_flat(grads, f"{cid}/grad"))
        return
    tcfg = TrainConfig(opt=OptConfig(kind=case["opt"]),
                       microbatches=plan.microbatches)
    opt = _place(mesh, init_opt_state(params, tcfg.opt),
                 opt_state_specs(specs, tcfg.opt))
    step_fn = (shared_grad_step(cfg, plan, tcfg) if case.get("shared_grad")
               else jax.jit(make_train_step(cfg, plan, tcfg)))
    for i in range(case["steps"]):
        params, opt, m = step_fn(params, opt, _batch(mesh, plan, inputs, cid, i),
                                 jnp.asarray(i, jnp.int32))
        out[f"{cid}/loss{i}"] = np.asarray(m["loss"])
        out[f"{cid}/grad_norm{i}"] = np.asarray(m["grad_norm"])
        if i == 0 and case["opt"] == "adafactor":
            for part in ("vr", "vc"):
                out.update(_flat(opt[part], f"{cid}/{part}"))


def run_opt(case, mesh, params, specs, inputs, out):
    """Two ``apply_updates`` of the case's optimizer on the harness's
    gradients, everything placed by its specs; the new parameters and
    the state."""
    cid = case["id"]
    ocfg = OptConfig(kind=case["opt"])
    ospecs = opt_state_specs(specs, ocfg)
    state = _place(mesh, init_opt_state(params, ocfg), ospecs)
    update = jax.jit(lambda p, g, st, i: apply_updates(p, g, st, i, ocfg))
    for i in range(2):
        grads = _place(mesh, load_tree_of(inputs, f"{cid}/{i}/jg"), specs)
        params, state = update(params, grads, state,
                               jnp.asarray(i + 1, jnp.float32))
    out.update(_flat(params, f"{cid}/p"))
    for part, tree in state.items():
        out.update(_flat(tree, f"{cid}/{part}"))


def run_compress(case, mesh, inputs, out):
    """``dp_mean_compressed`` under ``shard_map`` over data: data rank i
    holds gradient i, replicated over model."""
    cid = case["id"]
    n = case["mesh"][0]
    names = [k[len(f"{cid}/g0/"):] for k in inputs if k.startswith(f"{cid}/g0/")]
    stacked = {k: np.stack([inputs[f"{cid}/g{i}/{k}"] for i in range(n)])
               for k in names}
    fn = shard_map(lambda g: dp_mean_compressed(
        jax.tree.map(lambda a: a[0], g), "data"), mesh=mesh,
        in_specs=(P("data"),), out_specs=P())
    mean = jax.jit(fn)(stacked)
    for k, v in mean.items():
        out[f"{cid}/mean/{k}"] = np.asarray(v)


# PagedBatchResult fields that read the wall clock
CLOCKED = {"prefill_s", "decode_s", "prefill_stall_s", "inter_token_s"}


def paged_serve(case, cfg, params, plan) -> dict:
    """``PagedEngine(plan=)`` on the case's requests: outputs, counters but
    the clocked ones, trace events and each admission's (rid, slot, prefix
    tokens hit), or the exception it raised (type name and message)."""
    reqs = [Request(rid=rid, tokens=list(t), input_len=len(t), slo=slo,
                    arrival=arr, true_output_len=out)
            for rid, t, out, slo, arr in case["reqs"]]
    tracer, admits = Tracer(), []
    eng = paged_engine.PagedEngine(
        cfg, params, paged_engine.PagedEngineConfig(**case["pcfg"]),
        plan=plan, tracer=tracer)
    begin = eng._begin_prefill

    def logged(st, slot, r, outs, res):
        begin(st, slot, r, outs, res)
        admits.append([r.rid, slot, st.prefilling[slot].done])
    eng._begin_prefill = logged
    try:
        res = eng.run_continuous(reqs)
    except (ValueError, NotImplementedError) as e:
        return {"error": [type(e).__name__, str(e)]}
    counters = {f.name: getattr(res, f.name) for f in dataclasses.fields(res)
                if f.name not in CLOCKED and f.name != "outputs"}
    counters["inter_token_samples"] = len(res.inter_token_s)
    return {"outputs": {str(k): v for k, v in res.outputs.items()},
            "counters": counters, "admits": admits,
            "events": [[e.name, e.ph, e.row] for e in tracer.events]}


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
    if case["kind"] in ("grad", "step"):
        run_train(case, cfg, plan, mesh, params, specs, inputs, out_arrays)
    elif case["kind"] == "opt":
        run_opt(case, mesh, params, specs, inputs, out_arrays)
    elif case["kind"] == "compress":
        run_compress(case, mesh, inputs, out_arrays)
    elif case["kind"] == "logits":
        batch = {k: jnp.asarray(inputs[f"{cid}/{k}"])
                 for k in ("tokens", "frames") if f"{cid}/{k}" in inputs}
        kv_len = jnp.asarray(inputs[f"{cid}/kv_len"])
        steps = inputs[f"{cid}/steps"]
        lg, cache = jax.jit(lambda p, b, kl: api.prefill(
            cfg, p, b, plan=plan, cache_len=case["cache_len"],
            kv_len=kl))(params, batch, kv_len)
        out_arrays[f"{cid}/prefill"] = np.asarray(lg)
        dec = jax.jit(lambda p, t, c, kl: api.decode_step(cfg, p, t, c, kl,
                                                          plan=plan))
        for i, t in enumerate(steps):
            lg, cache = dec(params, jnp.asarray(t), cache, kv_len + i)
            out_arrays[f"{cid}/decode{i}"] = np.asarray(lg)
    elif case["kind"] == "paged":
        out_json[cid] = {"sharded": paged_serve(case, cfg, params, plan)}
        if not case.get("raises"):
            out_json[cid]["unsharded"] = paged_serve(
                case, cfg, jax.tree.map(jnp.asarray, load_tree(case["weights"])),
                None)
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
        if case.get("port_only"):       # the port against itself alone
            continue
        shape = tuple(case["mesh"])
        if shape not in meshes:
            meshes[shape] = jax.make_mesh(shape, ("data", "model"),
                                          axis_types=(AxisType.Auto,) * 2)
        t0 = time.perf_counter()
        with set_mesh(meshes[shape]):
            run(case, meshes[shape], inputs, out_arrays, out_json)
        print(f"{case['id']}: {time.perf_counter() - t0:.1f} s", flush=True)
    np.savez(os.path.join(out_dir, "jax.npz"), **out_arrays)
    with open(os.path.join(out_dir, "jax.json"), "w") as f:
        json.dump(out_json, f, default=lambda a: a.item())


if __name__ == "__main__":
    main(*sys.argv[1:3])
