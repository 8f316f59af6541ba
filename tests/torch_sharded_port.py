"""The port's side of the sharded tests: one rank of a 4-rank gloo run on
the CPU (``repro_torch.distributed.ranks.run_ranks``), started by
``torch_sharded_harness``.  Imports torch and the port only.

Each rank loads the harness's numpy weights into the port's model, cuts
them to its slices (``params.shard_params``) and runs every case of the
spec under the case's mesh and plan: prefill and decode logits, the
engine padded or continuous, the paged engine, one MoE block, the loss and
its gradients (gathered to full), three train steps, or
``dp_mean_compressed``.  Rank 0 writes the arrays and tokens; every rank
writes which attention and WKV6 wrappers it called, with what shapes, to
show which path each plan took, each cache tensor's layout where a logits
case asks (``cache_check``), and its paged engines' results and pools.
``collective_probe`` holds each differentiable collective's backward to
its transpose and its forward under ``no_grad`` to plain
``torch.distributed`` calls."""
import dataclasses
import json
import os
from collections import defaultdict

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.configs import get_config
from repro_torch.core.types import Batch, Request
from repro_torch.distributed import collectives as C
from repro_torch.distributed.collectives import all_gather, local_chunk
from repro_torch.models import api
from repro_torch.models import attention as attn_mod
from repro_torch.models import moe
from repro_torch.models import rwkv as rwkv_mod
from repro_torch.obs.trace import Tracer
from repro_torch.params import from_jax_params, shard_params, stacked_leaves
from repro_torch.serving import (EngineConfig, InferenceEngine, PagedEngine,
                                 PagedEngineConfig)
from repro_torch.serving import paged_engine
from repro_torch.sharding import Mesh, ShardingPlan, set_mesh
from repro_torch.sharding.mesh import current_mesh
from repro_torch.sharding.specs import (cache_spec, gather_tensor, gather_tree,
                                        shard_tensor, shard_tree)
from repro_torch.training import (OptConfig, TrainConfig, apply_updates,
                                  init_opt_state, make_train_step,
                                  opt_state_specs)
from repro_torch.training.grad_compress import (dp_mean_compressed,
                                                quantize_int8)
from repro_torch.training.trainer import clip_and_update, value_and_grad


def config(case):
    cfg = dataclasses.replace(get_config(case["arch"]).reduced(), **case["over"])
    if case.get("capacity") is not None:
        cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
            cfg.moe, capacity_factor=case["capacity"]))
    return cfg


def plan_of(case) -> ShardingPlan:
    return ShardingPlan(**{k: tuple(v) if isinstance(v, list) else v
                           for k, v in case["plan"].items()})


def load_model(case):
    """The port's model on the CPU carrying the case's numpy weights."""
    cfg = config(case)
    tree = {}
    with np.load(case["weights"]) as f:
        for key in f.files:
            node = tree
            *parents, leaf = key.split("/")
            for part in parents:
                node = node.setdefault(part, {})
            node[leaf] = f[key]
    model = api.init_params(cfg, seed=0, device="cpu")
    model.load_state_dict(from_jax_params(tree))
    return cfg, model


def requests(case):
    return [Request(rid=i, tokens=p, input_len=len(p), slo=1e9, arrival=0.0,
                    true_output_len=n)
            for i, (p, n) in enumerate(zip(case["prompts"], case["new"]))]


# PagedBatchResult fields that read the wall clock
CLOCKED = {"prefill_s", "decode_s", "prefill_stall_s", "inter_token_s"}


def paged_serve(case, cfg, model, plan, rows=None) -> dict:
    """``PagedEngine(plan=)`` on the case's requests (or ``rows``): its
    outputs, its counters but the clocked ones, its trace events, each
    admission's (rid, slot, prefix tokens hit) and its pools at the end
    (``pools``, tensors; absent when it never made them), or the
    exception it raised (``error``: type name and message)."""
    reqs = [Request(rid=rid, tokens=list(t), input_len=len(t), slo=slo,
                    arrival=arr, true_output_len=out)
            for rid, t, out, slo, arr in (rows or case["reqs"])]
    tracer, admits, states = Tracer(), [], []
    eng = PagedEngine(cfg, model, PagedEngineConfig(**case["pcfg"]),
                      plan=plan, tracer=tracer)
    begin = eng._begin_prefill

    def logged(st, slot, r, outs, res):
        begin(st, slot, r, outs, res)
        admits.append([r.rid, slot, st.prefilling[slot].done])
    eng._begin_prefill = logged
    create = paged_engine.PagedDecodeState.create

    def kept(*args, **kw):
        states.append(create(*args, **kw))
        return states[-1]
    paged_engine.PagedDecodeState.create = kept
    try:
        res = eng.run_continuous(reqs)
    except (ValueError, NotImplementedError) as e:
        return {"error": [type(e).__name__, str(e)], "made_pools": bool(states)}
    finally:
        paged_engine.PagedDecodeState.create = create
    counters = {f.name: getattr(res, f.name) for f in dataclasses.fields(res)
                if f.name not in CLOCKED and f.name != "outputs"}
    counters["inter_token_samples"] = len(res.inter_token_s)
    return {"outputs": {str(k): v for k, v in res.outputs.items()},
            "counters": counters, "admits": admits,
            "events": [[e.name, e.ph, e.row] for e in tracer.events],
            "pools": states[-1].pools}


def paged_case(case, cfg, model, plan, arrays, tokens):
    """A paged case on this rank (plan None: the unsharded port): its
    summary in ``tokens`` and its pools in ``arrays``, by layer."""
    cid = case["id"]
    if plan is None and case.get("raises"):
        return
    out = paged_serve(case, cfg, model, plan)
    for i, pool in enumerate(out.pop("pools", ())):
        for n in ("k", "v"):
            arrays[f"{cid}/pool{i}/{n}"] = pool[n].numpy()
    tokens[cid] = out


def train_batch(inputs, cid, i=0) -> dict:
    """Step ``i``'s batch: tokens, labels, mask and an encoder-decoder's
    frames."""
    return {k: torch.as_tensor(inputs[f"{cid}/{i}/{k}"])
            for k in ("tokens", "labels", "mask", "frames")
            if f"{cid}/{i}/{k}" in inputs}


def _rows(batch: dict, n: int, i: int) -> dict:
    return {k: v.chunk(n)[i] for k, v in batch.items()}


def grads_of(cfg, model, plan, batch, per_shard: int = 1, microbatches=1):
    """(loss, metrics, full gradients): under ``plan`` this rank's slices
    gathered; unsharded, with ``per_shard`` > 1, the mean of the unsharded
    function over that many row blocks (a batch-sharded MoE's function)."""
    if plan is not None or per_shard == 1:
        loss, metrics, grads = value_and_grad(cfg, plan, model, batch,
                                              microbatches)
    else:
        parts = [value_and_grad(cfg, None, model, _rows(batch, per_shard, i),
                                microbatches) for i in range(per_shard)]
        loss = sum(p[0] for p in parts) / per_shard
        metrics = {k: sum(p[1][k] for p in parts) / per_shard
                   for k in parts[0][1]}
        grads = {k: sum(p[2][k] for p in parts) / per_shard
                 for k in parts[0][2]}
    if plan is not None:
        specs = {n: p.shard_spec for n, p in model.named_parameters()}
        grads = {n: gather_tensor(g, specs[n]) for n, g in grads.items()}
    return loss, metrics, grads


def per_shard_step(cfg, tcfg, n: int):
    """The unsharded train step of a batch-sharded MoE: the loss and the
    gradient the mean of the unsharded ones over ``n`` row blocks, then
    the port's clip and update (``trainer.clip_and_update``)."""
    def step(model, opt, batch, i):
        loss, _, grads = grads_of(cfg, model, None, batch, n, tcfg.microbatches)
        gnorm = clip_and_update(cfg, None, tcfg, model, opt, grads, i)
        return model, opt, {"loss": loss, "grad_norm": gnorm}
    return step


def run_train_case(case, cfg, model, plan, inputs, arrays):
    cid = case["id"]
    model.requires_grad_(True)
    per_shard = case["per_shard"]
    if case["kind"] == "grad":
        loss, metrics, grads = grads_of(cfg, model, plan,
                                        train_batch(inputs, cid), per_shard)
        arrays[f"{cid}/loss"] = loss.numpy()
        for k, v in metrics.items():
            arrays[f"{cid}/{k}"] = v.numpy()
        for name, g in grads.items():
            arrays[f"{cid}/grad/{name}"] = g.numpy()
        return
    tcfg = TrainConfig(opt=OptConfig(kind=case["opt"]),
                       microbatches=case["plan"].get("microbatches", 1))
    named = {k: p.detach() for k, p in model.named_parameters()}
    stacks = stacked_leaves(cfg, named)
    opt = init_opt_state(named, tcfg.opt, stacks)
    if plan is None and per_shard > 1:
        step_fn = per_shard_step(cfg, tcfg, per_shard)
    else:
        step_fn = make_train_step(cfg, plan, tcfg)
    for i in range(case["steps"]):
        model, opt, m = step_fn(model, opt, train_batch(inputs, cid, i), i)
        arrays[f"{cid}/loss{i}"] = m["loss"].numpy()
        arrays[f"{cid}/grad_norm{i}"] = m["grad_norm"].numpy()
        if i == 0 and case["opt"] == "adafactor":
            specs = opt_state_specs(
                {n: getattr(p, "shard_spec", ()) for n, p in
                 model.named_parameters()}, tcfg.opt, stacks)
            for part in ("vr", "vc"):
                for key, t in opt[part].items():
                    full = gather_tensor(t, specs[part][key]) \
                        if plan is not None else t
                    arrays[f"{cid}/{part}/{key}"] = full.numpy()


def run_opt_case(case, cfg, model, plan, inputs, arrays):
    """Two updates of the case's optimizer on the harness's gradients
    (this rank's slices of them under ``plan``); the new parameters and
    the state, gathered to full."""
    cid = case["id"]
    ocfg = OptConfig(kind=case["opt"])
    specs = {n: getattr(p, "shard_spec", ()) for n, p in model.named_parameters()}
    params = {n: p.detach() for n, p in model.named_parameters()}
    stacks = stacked_leaves(cfg, params)
    state = init_opt_state(params, ocfg, stacks)
    for i in range(2):
        grads = {n: torch.as_tensor(inputs[f"{cid}/{i}/g/{n}"]) for n in params}
        if plan is not None:
            grads = {n: shard_tensor(g, specs[n]) for n, g in grads.items()}
        params, state = apply_updates(params, grads, state, float(i + 1), ocfg,
                                      stacks, specs if plan is not None else None)
    state_specs = opt_state_specs(specs, ocfg, stacks)
    for n, t in params.items():
        arrays[f"{cid}/p/{n}"] = (gather_tensor(t, specs[n]) if plan is not None
                                  else t).numpy()
    for part, tensors in state.items():
        for key, t in tensors.items():
            full = gather_tensor(t, state_specs[part][key]) \
                if plan is not None else t
            arrays[f"{cid}/{part}/{key}"] = full.numpy()


def run_compress_case(case, plan, inputs, arrays):
    """Each data rank's gradient (the harness's) averaged over data by
    ``dp_mean_compressed``; unsharded, the same arithmetic from the
    single-device pieces."""
    cid = case["id"]
    n = case["mesh"][0]
    local = [{k[len(f"{cid}/g{i}/"):]: torch.as_tensor(v)
              for k, v in inputs.items() if k.startswith(f"{cid}/g{i}/")}
             for i in range(n)]
    if plan is not None:
        out = dp_mean_compressed(local[C.axis_index("data")], "data")
    else:
        out = {}
        for name in local[0]:
            qs = [quantize_int8(g[name].float()) for g in local]
            total = sum(q.to(torch.int32) for q, _ in qs)
            s_max = torch.stack([s for _, s in qs]).max()
            out[name] = (total.float() * s_max / n).to(local[0][name].dtype)
    for name, g in out.items():
        arrays[f"{cid}/mean/{name}"] = g.numpy()


# this rank's cache layouts of the current case (``cache_check``): [step,
# layer, name, the tensor's shard_spec, cache_spec of its full shape]
CACHE_SPECS = []


def record_cache(case, cfg, plan, cache, arrays, step):
    """Each tensor of ``cache`` gathered to full (``{cid}/cache{step}/
    {layer}/{name}``) and, under ``plan``, its layout beside the
    reference's spec of its full shape (``CACHE_SPECS``).  An
    encoder-decoder's entries nest {"self", "cross"}: their tensors are
    named ``self/k``, ``cross/ck``, ..."""
    def leaves(entry, prefix=""):
        for name, t in entry.items():
            if isinstance(t, dict):
                yield from leaves(t, f"{prefix}{name}/")
            else:
                yield prefix + name, t

    for i, entry in enumerate(cache):
        for name, t in leaves(entry):
            full = t if plan is None else gather_tensor(t, t.shard_spec)
            arrays[f"{case['id']}/cache{step}/{i}/{name}"] = full.numpy().copy()
            if plan is not None:
                want = cache_spec(cfg, plan, name.split("/")[-1],
                                  tuple(full.shape), current_mesh().shape)
                CACHE_SPECS.append([step, i, name, t.shard_spec, want])


def run_case(case, cfg, model, plan, inputs, arrays, tokens):
    """One case on this rank (plan None: the unsharded port)."""
    cid = case["id"]
    if case["kind"] in ("grad", "step"):
        run_train_case(case, cfg, model, plan, inputs, arrays)
    elif case["kind"] == "opt":
        run_opt_case(case, cfg, model, plan, inputs, arrays)
    elif case["kind"] == "compress":
        run_compress_case(case, plan, inputs, arrays)
    elif case["kind"] == "logits":
        batch = {"tokens": torch.as_tensor(inputs[f"{cid}/tokens"]).long()}
        if f"{cid}/frames" in inputs:
            batch["frames"] = torch.as_tensor(inputs[f"{cid}/frames"])
        kv_len = torch.as_tensor(inputs[f"{cid}/kv_len"])
        lg, cache = api.prefill(cfg, model, batch,
                                cache_len=case["cache_len"], kv_len=kv_len,
                                plan=plan)
        arrays[f"{cid}/prefill"] = lg.numpy()
        steps = inputs[f"{cid}/steps"]
        if case.get("cache_check"):
            record_cache(case, cfg, plan, cache, arrays, 0)
        for i, t in enumerate(steps):
            lg, cache = api.decode_step(cfg, model, torch.as_tensor(t).long(),
                                        cache, kv_len + i, plan=plan)
            arrays[f"{cid}/decode{i}"] = lg.numpy()
        if case.get("cache_check"):
            record_cache(case, cfg, plan, cache, arrays, len(steps))
    elif case["kind"] == "paged":
        paged_case(case, cfg, model, plan, arrays, tokens)
    elif case["kind"] in ("engine", "continuous"):
        eng = InferenceEngine(cfg, model, EngineConfig(
            max_batch=case["max_batch"], cache_len=case["cache_len"],
            max_new_tokens=max(case["new"])), plan=plan)
        reqs = requests(case)
        if case["kind"] == "engine":
            res = eng.run_batch(Batch(requests=reqs),
                                true_lens={r.rid: r.true_output_len for r in reqs})
        else:
            res = eng.run_continuous(reqs)
        tokens[cid] = {str(k): v for k, v in res.outputs.items()}
    else:
        x = torch.as_tensor(inputs[f"{cid}/x"])
        if plan is not None and plan.batch_axes:
            x = local_chunk(x, plan.batch_axes, 0)
        with torch.inference_mode():
            y, aux = moe.moe_apply(cfg, model.blocks[0].mlp, x, plan=plan)
        if plan is not None and plan.batch_axes:
            y = all_gather(y, plan.batch_axes, 0)
        arrays[f"{cid}/y"] = y.numpy()
        arrays[f"{cid}/lb_loss"] = aux["lb_loss"].numpy()
        arrays[f"{cid}/drop_frac"] = aux["drop_frac"].numpy()


class CallLog:
    """Counts calls of the attention and RWKV modules' kernel wrappers
    (their plain versions on the CPU) and keeps their shapes."""

    def __init__(self):
        self.calls = defaultdict(list)

    def wrap(self, name, describe, module=attn_mod):
        orig = getattr(module, name)

        def counted(*args, **kw):
            self.calls[name].append(describe(*args, **kw))
            return orig(*args, **kw)
        setattr(module, name, counted)

    def take(self):
        out, self.calls = dict(self.calls), defaultdict(list)
        return out


def _flash(q, k, v, **kw):
    return {"sq": q.shape[1], "skv": k.shape[1], "h": q.shape[2],
            "kv": k.shape[2], "q_offset": kw.get("q_offset", 0)}


def _decode(q, k, v, kv_len, **kw):
    return {"h": q.shape[1], "kv": k.shape[2], "s": k.shape[1]}


def _partial(q, k, v, kv_len, **kw):
    return {"h": q.shape[1], "s": k.shape[1], "pos_offset": int(kw["pos_offset"])}


def _paged(q, k_pool, v_pool, tables, lengths, **kw):
    """K1's rows, window and the pool it reads."""
    return {"b": q.shape[0], "t": q.shape[1] if q.dim() == 4 else 1,
            "h": q.shape[-2], "blocks": k_pool.shape[0],
            "tables": list(tables.shape)}


def _wkv6(r, k, v, w, u, s0=None, **kw):
    """K4's rows, positions and heads."""
    return {"b": r.shape[0], "t": r.shape[1], "h": r.shape[2]}


def rank_main(rank: int, spec_path: str, out_dir: str) -> None:
    spec = json.loads(open(spec_path).read())
    with np.load(spec["inputs"]) as f:
        inputs = {k: f[k] for k in f.files}
    log = CallLog()
    log.wrap("flash_attention", _flash)
    log.wrap("decode_attention", _decode)
    log.wrap("decode_attention_partial", _partial)
    log.wrap("paged_decode_attention", _paged)
    log.wrap("paged_window_attention", _paged)
    log.wrap("wkv6", _wkv6, rwkv_mod)
    arrays, tokens, calls = {}, {}, {}
    paged, pools = {}, {}
    by_mesh = defaultdict(list)
    for case in spec["cases"]:
        by_mesh[tuple(case["mesh"])].append(case)
    for (data, model_ax), cases in by_mesh.items():
        with set_mesh(Mesh({"data": data, "model": model_ax}, device="cpu")):
            for case in cases:
                cfg, model = load_model(case)
                plan = plan_of(case)
                shard_params(cfg, model, plan)
                if case["kind"] == "paged":
                    paged_case(case, cfg, model, plan, pools, paged)
                else:
                    run_case(case, cfg, model, plan, inputs, arrays, tokens)
                calls[case["id"]] = log.take()
                if CACHE_SPECS:
                    calls[case["id"]]["cache_specs"] = CACHE_SPECS[:]
                    CACHE_SPECS.clear()
    with open(os.path.join(out_dir, f"calls{rank}.json"), "w") as f:
        json.dump(calls, f)
    if paged:
        np.savez(os.path.join(out_dir, f"pools{rank}.npz"), **pools)
        with open(os.path.join(out_dir, f"paged{rank}.json"), "w") as f:
            json.dump(paged, f, default=lambda a: a.item())
    if rank == 0:
        np.savez(os.path.join(out_dir, "port.npz"), **arrays)
        with open(os.path.join(out_dir, "port.json"), "w") as f:
            json.dump(tokens, f)


def mesh_probe(rank: int, out_dir: str) -> None:
    """Each mesh's coordinates, indices, gather orders and collectives as
    this rank sees them, and a tree cut by ``shard_tree`` and put back by
    ``gather_tree``."""
    seen = {}
    tree = {"a": torch.arange(32.0).reshape(4, 8), "b": torch.arange(8.0)}
    specs = {"a": ("data", "model"), "b": (("data", "model"),)}
    for shape in ({"data": 2, "model": 2}, {"data": 1, "model": 4}):
        mesh = Mesh(shape, device="cpu")
        with set_mesh(mesh):
            me = torch.tensor([float(rank)])
            key = f"{shape['data']}x{shape['model']}"
            seen[key] = {
                "backend": mesh.backend,
                "coords": mesh.coords,
                "index": {a: C.axis_index(ax) for a, ax in
                          (("data", "data"), ("model", "model"),
                           ("both", ("data", "model")))},
                "gather": {a: C.all_gather(me, ax, 0).tolist() for a, ax in
                           (("data", "data"), ("model", "model"),
                            ("both", ("data", "model")))},
                "psum": C.psum(me, ("data", "model")).item(),
                "pmax": C.pmax(me, "model").item(),
                "to_all": C.all_to_all(torch.arange(4.0) + 10 * rank,
                                       ("data", "model"), 0, 0).tolist(),
                "scatter": C.reduce_scatter(torch.arange(4.0) * (rank + 1),
                                            "model", 0).tolist(),
                "tree": {k: v.tolist() for k, v in
                         shard_tree(tree, specs).items()},
                "round_trip": all(torch.equal(v, tree[k]) for k, v in
                                  gather_tree(shard_tree(tree, specs),
                                              specs).items()),
            }
    with open(os.path.join(out_dir, f"mesh{rank}.json"), "w") as f:
        json.dump(seen, f)


def _old_forward(name, x, axis, *dims):
    """Each collective's forward as plain ``torch.distributed`` calls on
    the current mesh (the CPU ranks' gloo), the yardstick of its forward
    under ``no_grad``."""
    mesh = C.current_mesh()
    group = mesh.group(axis)
    n = dist.get_world_size(group)
    idx = mesh.axis_index(axis)
    buf = x.detach().contiguous().clone()
    if name == "psum":
        dist.all_reduce(buf, group=group)
        return buf
    if name == "all_gather":
        parts = [torch.empty_like(buf) for _ in range(n)]
        dist.all_gather(parts, buf, group=group)
        return torch.cat(parts, dim=dims[0])
    if name == "local_chunk":
        size = x.shape[dims[0]] // n
        return x.narrow(dims[0], idx * size, size).contiguous()
    if name == "reduce_scatter":
        dist.all_reduce(buf, group=group)
        size = x.shape[dims[0]] // n
        return buf.narrow(dims[0], idx * size, size).contiguous()
    send = torch.stack(buf.chunk(n, dim=dims[0]))
    recv = torch.empty_like(send)
    dist.all_to_all_single(recv, send, group=group)
    return torch.cat(recv.unbind(0), dim=dims[1])


PROBES = [("psum", ()), ("all_gather", (1,)), ("local_chunk", (1,)),
          ("reduce_scatter", (0,)), ("all_to_all", (0, 2)),
          ("all_to_all", (2, 1))]


def failing_probe(rank: int, out_dir: str) -> None:
    """After a barrier rank 2 raises; the others wait for it in a
    collective and lose their peer."""
    dist.barrier()
    if rank == 2:
        raise ValueError("probe failure on rank 2")
    dist.all_reduce(torch.ones(1))


def collective_probe(rank: int, out_dir: str) -> None:
    """For each differentiable collective over "model", "data" and both on
    {data: 2, model: 2} and {data: 1, model: 4}: the forward under
    ``no_grad`` against ``_old_forward`` (equal bit for bit), and the
    backward of a random cotangent against the transpose named in
    ``collectives``' docstring, computed with the forward functions, plus
    the adjoint identity sum_r <gy_r, f(x)_r> = sum_r <f^T(gy)_r, x_r>."""
    transpose = {
        "psum": lambda g, ax, d: C.psum(g, ax),
        "all_gather": lambda g, ax, d: C.reduce_scatter(g, ax, d[0]),
        "local_chunk": lambda g, ax, d: _placed(g, ax, d[0]),
        "reduce_scatter": lambda g, ax, d: C.all_gather(g, ax, d[0]),
        "all_to_all": lambda g, ax, d: C.all_to_all(g, ax, d[1], d[0]),
    }
    seen = {}
    for shape in ({"data": 2, "model": 2}, {"data": 1, "model": 4}):
        with set_mesh(Mesh(shape, device="cpu")):
            for axis in ("model", "data", ("data", "model")):
                if C.axis_size(axis) == 1:
                    continue
                for name, dims in PROBES:
                    gen = torch.Generator().manual_seed(100 * rank + len(seen))
                    x = torch.randn(4, 8, 4, generator=gen, dtype=torch.float64)
                    fn = getattr(C, name)
                    with torch.no_grad():
                        y0 = fn(x, axis, *dims)
                    same = bool(torch.equal(y0, _old_forward(name, x, axis,
                                                             *dims)))
                    xg = x.clone().requires_grad_(True)
                    y = fn(xg, axis, *dims)
                    gy = torch.randn(y.shape, generator=gen, dtype=x.dtype)
                    gx, = torch.autograd.grad(y, xg, gy)
                    with torch.no_grad():
                        want = transpose[name](gy, axis, dims)
                        dots = torch.stack([(gy * y).sum(), (gx * x).sum()])
                        dots = C.psum(dots, ("data", "model"))
                    key = f"{shape['data']}x{shape['model']}/{axis}/{name}{dims}"
                    seen[key] = {
                        "forward_equal": same,
                        "backward_err": float((gx - want).abs().max()),
                        "adjoint": [float(d) for d in dots],
                        "shapes": [list(x.shape), list(y.shape)]}
    with open(os.path.join(out_dir, f"probe{rank}.json"), "w") as f:
        json.dump(seen, f)


def _placed(g, axis, dim):
    """This rank's slice g placed into zeros along ``dim``."""
    n, i = C.axis_size(axis), C.axis_index(axis)
    shape = list(g.shape)
    shape[dim] *= n
    out = g.new_zeros(shape)
    out.narrow(dim, i * g.shape[dim], g.shape[dim]).copy_(g)
    return out
