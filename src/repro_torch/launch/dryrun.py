"""Dry run of every (architecture x input shape) cell on the production
meshes, on shapes alone.  Port of ``repro/launch/dryrun.py``.

The reference lowers and compiles each cell's train, prefill or decode step
with XLA for 256 or 512 placeholder devices and reads the compiled
program's ``memory_analysis``, ``cost_analysis`` and the collectives of its
HLO.  No torch function lowers a program the way XLA does.  Here nothing is
lowered or compiled: ``lower_cell`` runs rank r's own program, the port's
step functions as they serve and train, on ``meta`` tensors over a fake
process group of the mesh's size (``torch.testing``'s ``"fake"`` backend:
every collective returns at once with its output's shape).  Every
parameter and cache slice of the plan, and every collective its model code
issues, must agree in shape, or the cell fails.  Each cell runs rank 0 and
the last rank.

A record, ``artifacts/dryrun_torch/<arch>__<shape>__<mesh>__<plan>.json``,
holds the reference's ``arch``, ``shape``, ``mesh``, ``plan``,
``plan_kind`` and ``n_chips``, plus ``hw``; ``analytic``, the cost model's
terms with the reference's keys; and for each rank run (``ranks``; the
top-level ``memory``, ``collectives`` and ``kernels`` are rank 0's):

- ``memory``: this rank's bytes of ``params`` (bf16 slices), ``opt_state``,
  ``cache`` (a decode step's input slice, a prefill's output), ``inputs``
  (the whole batch, as the port's sharded entry points take it) and
  ``outputs`` (the step's new tensors: logits and cache, or the train
  metrics), and ``peak``: the most bytes of meta storage live at once
  during the step, the held tensors included, counted by a dispatch mode
  over every storage the step allocates and frees (``MetaMemory``);
- ``collectives``: calls and input bytes by kind and by axes
  (``distributed.collectives.counts``);
- ``kernels``: the K2, K2-gradient, K3 and K4 wrappers' calls on meta;

and ``wall_s``.  There is no ``compile_s``, ``hlo_flops``, ``hlo_bytes``
or ``memory_analysis``: only XLA computes those.  A cell that
``cell_is_runnable`` rejects, and a train cell of a model with RWKV-6
layers (the K4 kernel has no backward on the card), is recorded as
``skipped`` with its reason before it runs.

Usage:
  python -m repro_torch.launch.dryrun --arch smollm-135m --shape train_4k
  python -m repro_torch.launch.dryrun --all [--multi-pod] [--plan helr|baseline]
  python -m repro_torch.launch.dryrun --all --both-meshes
"""
from __future__ import annotations

import argparse
import contextlib
import json
import math
import pathlib
import time
import traceback
import weakref
from typing import Callable, Optional

import torch
import torch.distributed as dist
from torch.utils import _pytree as pytree
from torch.utils._python_dispatch import TorchDispatchMode

from repro_torch.configs import (SHAPES, cell_is_runnable, get_config,
                                 list_archs)
from repro_torch.configs.base import H100, HWSpec, ModelConfig, ShapeConfig
from repro_torch.core.deployer import MeshPlan, candidate_plans
from repro_torch.distributed import collectives
from repro_torch.kernels.decode_attention.ops import decode_attention
from repro_torch.kernels.flash_attention.ops import flash_attention
from repro_torch.kernels.wkv6.ops import wkv6
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.models import api
from repro_torch.params import shard_params, stacked_leaves
from repro_torch.perf.cost_model import ParallelismDesc, step_cost
from repro_torch.sharding.mesh import Mesh, set_mesh
from repro_torch.sharding.plan import ShardingPlan
from repro_torch.sharding.specs import cache_specs_tree, shard_tensor
from repro_torch.training import (OptConfig, TrainConfig, init_opt_state,
                                  make_train_step)

ART_DIR = pathlib.Path(__file__).resolve().parents[3] / "artifacts" / \
    "dryrun_torch"
GiB = 2 ** 30


def pick_plan(cfg: ModelConfig, shape: ShapeConfig, *, multi_pod: bool,
              which: str, hw: HWSpec = H100) -> MeshPlan:
    """The cell's plan among ``candidate_plans`` priced at ``hw``: with
    ``which="helr"`` the fastest that fits, else (baseline) the first
    that fits (``tp16_dp*``); the fastest or the first of all when none
    fits (``repro/launch/dryrun.py:122``)."""
    cands = candidate_plans(cfg, shape, multi_pod=multi_pod, hw=hw)
    feas = [c for c in cands if c.fits] or cands
    if which == "helr":
        return min(feas, key=lambda c: c.step_time)
    return feas[0]


def plan_of(name: str, plan: ShardingPlan, cfg: ModelConfig,
            shape: ShapeConfig, desc: ParallelismDesc,
            hw: HWSpec = H100) -> MeshPlan:
    """A ``MeshPlan`` of an explicit ``plan``, priced by ``desc`` (whose
    ``optimizer`` a train cell takes), for ``lower_cell(mesh_plan=)``."""
    cost = step_cost(cfg, shape, desc)
    return MeshPlan(name, plan, desc, cost, cost.hbm_resident <= hw.hbm_bytes,
                    cost.hbm_resident, hw)


class MetaMemory(TorchDispatchMode):
    """Bytes of meta storage live at once: every storage an op returns is
    counted until it is freed (a weak reference's callback), each once
    however many tensors view it; ``hold`` counts tensors made before the
    mode.  ``peak`` is the most seen."""

    def __init__(self):
        super().__init__()
        self.live = self.peak = 0
        self._refs: dict[int, weakref.ref] = {}

    def hold(self, t: torch.Tensor) -> None:
        if t.device.type != "meta":
            return
        st = t.untyped_storage()
        key = st._cdata
        if key in self._refs:
            return
        n = st.nbytes()
        self.live += n
        self.peak = max(self.peak, self.live)

        def freed(_, key=key, n=n):
            self.live -= n
            self._refs.pop(key, None)
        self._refs[key] = weakref.ref(st, freed)

    def _hold_all(self, out) -> None:
        if isinstance(out, torch.Tensor):
            self.hold(out)
        elif isinstance(out, (tuple, list)):
            for t in out:
                self._hold_all(t)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        self._hold_all(out)
        return out


def _tensors(tree) -> list:
    """The tensors of a nested dict / list / tuple, in order."""
    return [t for t in pytree.tree_leaves(tree) if isinstance(t, torch.Tensor)]


def tree_bytes(tree) -> int:
    """Bytes of the distinct storages of the tensors in a nested
    dict / list / tuple."""
    return sum({t.untyped_storage()._cdata: t.untyped_storage().nbytes()
                for t in _tensors(tree)}.values())


@contextlib.contextmanager
def fake_group(rank: int, world: int):
    """A default process group of ``world`` placeholder ranks, this process
    rank ``rank``, destroyed on exit."""
    from torch.testing._internal.distributed.fake_pg import FakeStore
    if dist.is_initialized():
        raise RuntimeError("the dry run needs a process without a default "
                           "process group")
    dist.init_process_group("fake", store=FakeStore(), rank=rank,
                            world_size=world)
    try:
        yield
    finally:
        dist.destroy_process_group()


def shard_cache(cfg: ModelConfig, plan: ShardingPlan, cache, mesh_shape):
    """This rank's slice of a whole cache (``api.cache_specs``), laid out
    by ``cache_specs_tree``, each slice carrying its spec as
    ``shard_spec`` as the model code leaves it."""
    specs = cache_specs_tree(cfg, plan, cache, mesh_shape)

    def walk(node, spec):
        if isinstance(node, dict):
            return {k: walk(v, spec[k]) for k, v in node.items()}
        if isinstance(node, list):
            return [walk(v, s) for v, s in zip(node, spec)]
        part = shard_tensor(node, spec)
        if part.numel() < node.numel():     # a view would keep the whole
            part = part.clone()
        part.shard_spec = spec
        return part
    return walk(cache, specs)


def cast_cache(cache, dtype, like):
    """The cache with every ``like``-dtype tensor made ``dtype``."""
    return pytree.tree_map(lambda t: t.to(dtype) if t.dtype == like else t,
                           cache)


def _reset_kernels() -> None:
    flash_attention.meta_calls = flash_attention.meta_backward_calls = 0
    decode_attention.meta_calls = wkv6.meta_calls = 0


def _read_kernels() -> dict:
    return {"flash_attention": flash_attention.meta_calls,
            "flash_attention_grad": flash_attention.meta_backward_calls,
            "decode_attention": decode_attention.meta_calls,
            "wkv6": wkv6.meta_calls}


def run_rank(cfg: ModelConfig, shape: ShapeConfig, mp: MeshPlan,
             mesh_shape: dict[str, int], rank: int, *,
             dtype=torch.bfloat16, decode_fn: Callable = api.decode_step,
             cache_dtype=None) -> dict:
    """Rank ``rank``'s step of the cell on meta tensors over a fake group
    of the mesh's size: its memory, collectives and kernel calls."""
    plan = mp.plan
    world = math.prod(mesh_shape.values())
    with fake_group(rank, world), \
            set_mesh(Mesh(mesh_shape, device="meta")):
        model = api.init_params(cfg, dtype=dtype, device="meta")
        shard_params(cfg, model, plan)
        specs = api.input_specs(cfg, shape, dtype=dtype)
        opt, cache = {}, None
        if shape.kind == "train":
            model.requires_grad_(True)
            named = {k: p.detach() for k, p in model.named_parameters()}
            tcfg = TrainConfig(opt=OptConfig(kind=mp.desc.optimizer),
                               microbatches=plan.microbatches)
            opt = init_opt_state(named, tcfg.opt, stacked_leaves(cfg, named))
            inputs = specs["batch"]
            step_fn = make_train_step(cfg, plan, tcfg)

            def step():
                return step_fn(model, opt, inputs, 0)[2]
        elif shape.kind == "prefill":
            inputs = specs

            def step():
                return api.prefill(cfg, model, specs["batch"],
                                   cache_len=shape.seq_len,
                                   kv_len=specs["kv_len"], plan=plan)
        else:
            whole = specs["cache"]
            if cache_dtype is not None:
                whole = cast_cache(whole, cache_dtype, dtype)
            cache = shard_cache(cfg, plan, whole, mesh_shape)
            inputs = {"tokens": specs["tokens"], "kv_len": specs["kv_len"]}

            def step():
                return decode_fn(cfg, model, specs["tokens"], cache,
                                 specs["kv_len"], plan=plan)
        params = list(model.parameters())
        mem = MetaMemory()
        for t in params + _tensors(opt) + _tensors(inputs) + _tensors(cache):
            mem.hold(t)
        collectives.counts.reset()
        _reset_kernels()
        with mem:
            out = step()
        coll = collectives.counts.read()
        kernels = _read_kernels()
        if shape.kind == "prefill":
            cache = out[1]
        held = {t.untyped_storage()._cdata for t in params + _tensors(opt)}
        outputs = [t for t in _tensors(out)
                   if t.untyped_storage()._cdata not in held]
        memory = {"params": tree_bytes(params), "opt_state": tree_bytes(opt),
                  "cache": tree_bytes(cache) if cache is not None else 0,
                  "inputs": tree_bytes(inputs), "outputs": tree_bytes(outputs),
                  "peak": mem.peak}
    return {"rank": rank, "memory": memory, "collectives": coll,
            "kernels": kernels}


def analytic_terms(cfg: ModelConfig, shape: ShapeConfig,
                   desc: ParallelismDesc, hw: HWSpec) -> dict:
    """The cost model's terms of the cell, keyed as the reference's record
    (``repro/launch/dryrun.py:227``), its times and bottleneck at ``hw``."""
    ct = step_cost(cfg, shape, desc)
    return {"flops_chip": ct.flops, "hbm_bytes_chip": ct.hbm_bytes,
            "coll_bytes_chip": ct.coll_bytes, "model_flops": ct.model_flops,
            "weight_bytes_chip": ct.weight_bytes_chip,
            "kv_bytes_chip": ct.kv_bytes_chip,
            "hbm_resident_chip": ct.hbm_resident,
            "times_s": ct.times(hw), "bottleneck": ct.bottleneck(hw)}


def lower_cell(cfg: ModelConfig, shape: ShapeConfig, *, multi_pod: bool,
               plan_kind: str = "baseline", verbose: bool = True,
               hw: HWSpec = H100, mesh_plan: Optional[MeshPlan] = None,
               mesh_shape: Optional[dict[str, int]] = None,
               dtype=torch.bfloat16, ranks: Optional[tuple[int, ...]] = None,
               decode_fn: Callable = api.decode_step,
               cache_dtype=None) -> dict:
    """The cell's record (module docstring).  Nothing is lowered or
    compiled: rank r's program runs on meta tensors over a fake process
    group of the mesh's size, for rank 0 and the last rank (or ``ranks``).
    The plan is ``pick_plan``'s at ``hw`` unless ``mesh_plan`` is given; the
    mesh is the production one unless ``mesh_shape`` is; a decode step is
    ``decode_fn`` on the cache in ``cache_dtype`` (default ``dtype``) where
    it is ``dtype``."""
    mshape = dict(mesh_shape or make_production_mesh(multi_pod=multi_pod))
    n = math.prod(mshape.values())
    mp = mesh_plan or pick_plan(cfg, shape, multi_pod=multi_pod,
                                which=plan_kind, hw=hw)
    record: dict = {
        "arch": cfg.name, "shape": shape.name,
        "mesh": "x".join(str(v) for v in mshape.values()),
        "plan": mp.name, "plan_kind": plan_kind,
        "n_chips": n, "hw": hw.name,
    }
    t0 = time.perf_counter()
    runs = [run_rank(cfg, shape, mp, mshape, r, dtype=dtype,
                     decode_fn=decode_fn, cache_dtype=cache_dtype)
            for r in (ranks if ranks is not None else (0, n - 1))]
    record["wall_s"] = time.perf_counter() - t0
    record["ranks"] = runs
    record["memory"] = runs[0]["memory"]
    record["collectives"] = runs[0]["collectives"]
    record["kernels"] = runs[0]["kernels"]
    record["fits"] = max(r["memory"]["peak"] for r in runs) <= hw.hbm_bytes
    record["analytic"] = analytic_terms(cfg, shape, mp.desc, hw)
    if verbose:
        print("  " + summary(record), flush=True)
    return record


def summary(rec: dict) -> str:
    """One line of a cell's record: plan, fit, GiB a rank, collectives and
    kernel calls (rank 0's)."""
    m, c, k = rec["memory"], rec["collectives"], rec["kernels"]
    coll = ", ".join(f"{kind} {c['calls'][kind]} ({c['bytes'][kind] / GiB:.3f} GiB)"
                     for kind in collectives.KINDS)
    return (f"{rec['plan']} on {rec['mesh']} ({rec['hw']}): ranks "
            f"{[r['rank'] for r in rec['ranks']]} in {rec['wall_s']:.2f} s; "
            f"GiB a rank: params {m['params'] / GiB:.3f}, opt "
            f"{m['opt_state'] / GiB:.3f}, cache {m['cache'] / GiB:.3f}, peak "
            f"{max(r['memory']['peak'] for r in rec['ranks']) / GiB:.3f} "
            f"(fits: {'yes' if rec['fits'] else 'no'}); collectives: {coll}; "
            f"kernels on meta: {k}")


def skip_reason(cfg: ModelConfig, shape: ShapeConfig) -> str:
    """Why the cell is not run ("" when it is): ``cell_is_runnable``'s
    reason, or a train cell of a model with RWKV-6 layers, whose K4
    kernel has no backward on the card."""
    ok, why = cell_is_runnable(cfg, shape)
    if not ok:
        return why
    if shape.kind == "train" and any(sp.mixer == "rwkv6"
                                     for sp in cfg.layer_plan()):
        return "train skipped: the WKV6 kernel (K4) has no backward on the card"
    return ""


def run_cell(arch: str, shape_name: str, *, multi_pod: bool, plan_kind: str
             ) -> dict:
    """One cell's record, written to ART_DIR: skipped, run, or its error."""
    cfg = get_config(arch)
    shape = SHAPES[shape_name]
    mesh_tag = "2x16x16" if multi_pod else "16x16"
    out = ART_DIR / f"{arch}__{shape_name}__{mesh_tag}__{plan_kind}.json"
    ART_DIR.mkdir(parents=True, exist_ok=True)
    why = skip_reason(cfg, shape)
    if why:
        print(f"[skip] {arch} x {shape_name} on {mesh_tag}: {why}", flush=True)
        rec = {"arch": arch, "shape": shape_name, "mesh": mesh_tag,
               "skipped": why}
        out.write_text(json.dumps(rec, indent=1))
        return rec
    print(f"[cell] {arch} x {shape_name} on {mesh_tag} ({plan_kind})",
          flush=True)
    try:
        rec = lower_cell(cfg, shape, multi_pod=multi_pod, plan_kind=plan_kind)
    except Exception as e:                        # noqa: BLE001
        print(f"  FAILED: {e}", flush=True)
        traceback.print_exc()
        rec = {"arch": arch, "shape": shape_name, "mesh": mesh_tag,
               "error": str(e)}
    out.write_text(json.dumps(rec, indent=1, default=str))
    return rec


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--both-meshes", action="store_true")
    ap.add_argument("--plan", default="baseline", choices=["baseline", "helr"])
    args = ap.parse_args(argv)

    meshes = [False, True] if args.both_meshes else [args.multi_pod]
    archs = list_archs() if args.all or not args.arch else [args.arch]
    shapes = list(SHAPES) if args.all or not args.shape else [args.shape]

    failures = 0
    for mp in meshes:
        for arch in archs:
            for shp in shapes:
                rec = run_cell(arch, shp, multi_pod=mp, plan_kind=args.plan)
                if "error" in rec:
                    failures += 1
    if failures:
        raise SystemExit(f"{failures} cells failed")
    print("dry-run complete: every requested cell ran on meta tensors")


if __name__ == "__main__":
    main()
