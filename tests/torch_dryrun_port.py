"""Real ranks of the port on the CPU for ``tests/test_torch_dryrun.py``:
each case's step on 4 gloo ranks (``repro_torch.distributed.ranks.
run_ranks``), its collectives counted, beside the dry run's of the same
step on 4 fake meta ranks.

A case is a reduced config, a step kind, a batch and a plan; each rank
draws the seeded f32 weights, keeps its slices, fills the dry run's input
specs (``api.input_specs``) with seeded values and runs one step with
``collectives.counts`` set to 0 just before and read just after.  Writes
``rank{r}.json``: the counts of each case.
"""
import json
from dataclasses import replace
from pathlib import Path

import torch

from repro_torch.configs import get_config
from repro_torch.configs.base import ShapeConfig
from repro_torch.distributed import collectives
from repro_torch.launch.dryrun import shard_cache
from repro_torch.models import api
from repro_torch.params import shard_params, stacked_leaves
from repro_torch.sharding.mesh import Mesh, set_mesh
from repro_torch.sharding.plan import ShardingPlan
from repro_torch.training import (OptConfig, TrainConfig, init_opt_state,
                                  make_train_step)

MESH = {"data": 2, "model": 2}


def case_config(case):
    """(reduced config, shape, plan) of a case."""
    cfg = replace(get_config(case["arch"]).reduced(), **case.get("over", {}))
    shape = ShapeConfig(f"dry_{case['kind']}", case["seq"], case["batch"],
                        case["kind"])
    plan = ShardingPlan(**{k: tuple(v) if isinstance(v, list) else v
                           for k, v in case["plan"].items()})
    return cfg, shape, plan


def fill(cfg, shape, tree, gen):
    """Seeded CPU tensors in the place of the meta ``tree``: token ids
    below the vocabulary, every length half the sequence, a mask of ones,
    zero caches, small normal frames and embeddings."""
    def one(name, t):
        if name in ("tokens", "labels"):
            return torch.randint(1, cfg.vocab_size, t.shape, generator=gen,
                                 dtype=t.dtype)
        if name == "kv_len":
            return torch.full(t.shape, shape.seq_len // 2, dtype=t.dtype)
        if name == "mask":
            return torch.ones(t.shape, dtype=t.dtype)
        if name in ("frames", "embeds"):
            return (torch.randn(t.shape, generator=gen) * 0.02).to(t.dtype)
        return torch.zeros(t.shape, dtype=t.dtype)

    def walk(node, name=""):
        if isinstance(node, dict):
            return {k: walk(v, k) for k, v in node.items()}
        if isinstance(node, list):
            return [walk(v, name) for v in node]
        return one(name, node)
    return walk(tree)


def step_counts(cfg, shape, plan, gen) -> dict:
    """One step of the case on this rank's slices: its collectives."""
    model = api.init_params(cfg, seed=0, device="cpu")
    shard_params(cfg, model, plan)
    specs = fill(cfg, shape, api.input_specs(cfg, shape, dtype=torch.float32),
                 gen)
    if shape.kind == "train":
        model.requires_grad_(True)
        named = {k: p.detach() for k, p in model.named_parameters()}
        tcfg = TrainConfig(opt=OptConfig(kind="adamw"),
                           microbatches=plan.microbatches)
        opt = init_opt_state(named, tcfg.opt, stacked_leaves(cfg, named))
        step = make_train_step(cfg, plan, tcfg)
        collectives.counts.reset()
        step(model, opt, specs["batch"], 0)
    else:
        cache = shard_cache(cfg, plan, specs["cache"], MESH)
        collectives.counts.reset()
        api.decode_step(cfg, model, specs["tokens"], cache, specs["kv_len"],
                        plan=plan)
    return collectives.counts.read()


def collective_probe(rank: int, spec_path: str, out_dir: str) -> None:
    cases = json.loads(Path(spec_path).read_text())
    gen = torch.Generator().manual_seed(0)
    out = {}
    with set_mesh(Mesh(MESH, device="cpu")):
        for name, case in cases.items():
            out[name] = step_counts(*case_config(case), gen)
    (Path(out_dir) / f"rank{rank}.json").write_text(json.dumps(out))
