"""The port's side of the sharded serve tests: one rank of a 4-rank gloo
run on the CPU (``repro_torch.distributed.ranks.run_ranks``), started by
``torch_sharded_harness``.  Imports torch and the port only.

Each rank loads the harness's numpy weights into the port's model, cuts
them to its slices (``params.shard_params``) and runs every case of the
spec under the case's mesh and plan: prefill and decode logits, the
engine padded or continuous, or one MoE block.  Rank 0 writes the
arrays and tokens; every rank writes which attention wrappers it called,
with what shapes, to show which path each plan took."""
import dataclasses
import json
import os
from collections import defaultdict

import numpy as np
import torch

from repro_torch.configs import get_config
from repro_torch.core.types import Batch, Request
from repro_torch.distributed import collectives as C
from repro_torch.distributed.collectives import all_gather, local_chunk
from repro_torch.models import api
from repro_torch.models import attention as attn_mod
from repro_torch.models import moe
from repro_torch.params import from_jax_params, shard_params
from repro_torch.serving import EngineConfig, InferenceEngine
from repro_torch.sharding import Mesh, ShardingPlan, set_mesh
from repro_torch.sharding.specs import gather_tree, shard_tree


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


def run_case(case, cfg, model, plan, inputs, arrays, tokens):
    """One case on this rank (plan None: the unsharded port)."""
    cid = case["id"]
    if case["kind"] == "logits":
        toks = torch.as_tensor(inputs[f"{cid}/tokens"]).long()
        kv_len = torch.as_tensor(inputs[f"{cid}/kv_len"])
        lg, cache = api.prefill(cfg, model, {"tokens": toks},
                                cache_len=case["cache_len"], kv_len=kv_len,
                                plan=plan)
        arrays[f"{cid}/prefill"] = lg.numpy()
        for i, t in enumerate(inputs[f"{cid}/steps"]):
            lg, cache = api.decode_step(cfg, model, torch.as_tensor(t).long(),
                                        cache, kv_len + i, plan=plan)
            arrays[f"{cid}/decode{i}"] = lg.numpy()
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
    """Counts calls of the attention module's kernel wrappers (their plain
    versions on the CPU) and keeps their shapes."""

    def __init__(self):
        self.calls = defaultdict(list)

    def wrap(self, name, describe):
        orig = getattr(attn_mod, name)

        def counted(*args, **kw):
            self.calls[name].append(describe(*args, **kw))
            return orig(*args, **kw)
        setattr(attn_mod, name, counted)

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


def rank_main(rank: int, spec_path: str, out_dir: str) -> None:
    spec = json.loads(open(spec_path).read())
    with np.load(spec["inputs"]) as f:
        inputs = {k: f[k] for k in f.files}
    log = CallLog()
    log.wrap("flash_attention", _flash)
    log.wrap("decode_attention", _decode)
    log.wrap("decode_attention_partial", _partial)
    arrays, tokens, calls = {}, {}, {}
    by_mesh = defaultdict(list)
    for case in spec["cases"]:
        by_mesh[tuple(case["mesh"])].append(case)
    for (data, model_ax), cases in by_mesh.items():
        with set_mesh(Mesh({"data": data, "model": model_ax}, device="cpu")):
            for case in cases:
                cfg, model = load_model(case)
                plan = plan_of(case)
                shard_params(cfg, model, plan)
                run_case(case, cfg, model, plan, inputs, arrays, tokens)
                calls[case["id"]] = log.take()
    with open(os.path.join(out_dir, f"calls{rank}.json"), "w") as f:
        json.dump(calls, f)
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
