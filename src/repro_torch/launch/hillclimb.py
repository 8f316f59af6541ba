"""Perf hillclimb of three cells, each dry-run at its baseline and after
each optimisation step (``launch.dryrun``: rank r's program on meta
tensors over a fake process group; nothing is compiled), with the cost
model's roofline terms at the port's ``H100`` (data-sheet rates, not
measurements).  Port of ``repro/launch/hillclimb.py``.

  PYTHONPATH=src python -m repro_torch.launch.hillclimb

Each climb's records go to ``artifacts/perf_torch/<name>.json``; its lines
give each step's compute, memory and collective times and bottleneck from
the cost model, then the dry run's peak bytes a rank and collective calls
(the reference prints XLA's ``hlo_flops`` there, which only a compiled
program has).
"""
from __future__ import annotations

import dataclasses
import json
import pathlib

import torch

from repro_torch.configs import SHAPES, get_config
from repro_torch.core.deployer import candidate_plans
from repro_torch.launch import dryrun as dr
from repro_torch.models import api
from repro_torch.perf.cost_model import step_cost

ART = pathlib.Path(__file__).resolve().parents[3] / "artifacts" / "perf_torch"
QUANT_STEP = 0.05        # the int8 cache's scale (one per tensor)


def measure(cfg, shape, mp, tag, **kw) -> dict:
    """The dry run's record of the cell under the plan ``mp``."""
    return dr.lower_cell(cfg, shape, multi_pod=False, plan_kind=tag,
                         mesh_plan=mp, **kw)


def emit(name, steps) -> None:
    ART.mkdir(parents=True, exist_ok=True)
    (ART / f"{name}.json").write_text(json.dumps(steps, indent=1, default=str))
    print(f"== {name} ==")
    for s in steps:
        t = s["analytic"]["times_s"]
        peak = max(r["memory"]["peak"] for r in s["ranks"]) / dr.GiB
        calls = sum(s["collectives"]["calls"].values())
        print(f"  {s['plan_kind']:24s} comp={t['compute_s']*1e3:9.3f}ms "
              f"mem={t['memory_s']*1e3:8.3f}ms coll={t['collective_s']*1e3:8.3f}ms "
              f"dom={s['analytic']['bottleneck']:10s} peak={peak:.3f}GiB "
              f"coll_calls={calls}", flush=True)


def climb_minicpm3():
    """Cell 1 (least useful FLOPs): minicpm3-4b x decode_32k.
    Hypothesis: the per-step latent -> K/V expansion, 2 S r H (dn + dv)
    FLOPs a layer and a sequence, is most of the step's compute; absorbing
    W_uk / W_uv into the query and the output removes it and leaves the
    step bound by its bytes (weights and the latent cache).  The step
    costs are the cost model's at the H100's data-sheet rates."""
    cfg = get_config("minicpm3-4b")
    shape = SHAPES["decode_32k"]
    base = dr.pick_plan(cfg, shape, multi_pod=False, which="baseline")
    steps = [measure(cfg, shape, base, "baseline_expanded")]
    opt = dataclasses.replace(
        base,
        plan=dataclasses.replace(base.plan, mla_absorbed=True),
        desc=dataclasses.replace(base.desc, mla_absorbed=True))
    opt = dataclasses.replace(opt, cost=step_cost(cfg, shape, opt.desc))
    steps.append(measure(cfg, shape, opt, "opt1_mla_absorbed"))
    emit("hillclimb_minicpm3_decode", steps)
    return steps


def climb_smollm():
    """Cell 2 (most collective-bound): smollm-135m x train_4k.
    Hypothesis A: tensor parallelism over 16 ranks for a 135M model spends
    its step on activation all-reduces, four a layer; pure data
    parallelism over all 256 ranks leaves one gradient sync.
    Hypothesis B (beyond the paper): an int8 gradient sync halves the
    sync's bytes against bf16; projected from the cost model only (the
    port's ``training.grad_compress.dp_mean_compressed`` is held to the
    reference's in the tests)."""
    cfg = get_config("smollm-135m")
    shape = SHAPES["train_4k"]
    cands = {c.name: c for c in candidate_plans(cfg, shape, multi_pod=False)}
    base = dr.pick_plan(cfg, shape, multi_pod=False, which="baseline")
    steps = [measure(cfg, shape, base, "baseline_tp16")]
    steps.append(measure(cfg, shape, cands["dp256"], "opt1_pure_dp256"))
    # int8 grad sync: the analytic projection of the dp256 step
    proj = dict(steps[-1])
    coll = proj["analytic"]["coll_bytes_chip"] / 2.0
    t = dict(proj["analytic"]["times_s"])
    t["collective_s"] = t["collective_s"] / 2.0
    proj = {**proj, "plan_kind": "opt2_int8_gradsync(analytic)",
            "analytic": {**proj["analytic"], "coll_bytes_chip": coll,
                         "times_s": t}}
    steps.append(proj)
    emit("hillclimb_smollm_train", steps)
    return steps


def climb_gemma2():
    """Cell 3 (most serving-representative): gemma2-27b x decode_32k.
    Hypothesis: the step is bound by its bytes, the weights' and the KV
    cache's reads; an int8 KV cache halves the cache's term (the window
    layers' ring caches already hold only their window, counted in the
    baseline)."""
    cfg = get_config("gemma2-27b")
    shape = SHAPES["decode_32k"]
    base = dr.pick_plan(cfg, shape, multi_pod=False, which="baseline")
    steps = [measure(cfg, shape, base, "baseline_bf16kv")]
    opt = dataclasses.replace(
        base, desc=dataclasses.replace(base.desc, kv_bytes_per=1))
    opt = dataclasses.replace(opt, cost=step_cost(cfg, shape, opt.desc))
    steps.append(measure(cfg, shape, opt, "opt1_int8_kv",
                         decode_fn=int8_cache_decode, cache_dtype=torch.int8))
    emit("hillclimb_gemma2_decode", steps)
    return steps


def _map(fn, tree, like):
    """``fn(leaf, like_leaf)`` over two caches of one layout."""
    if isinstance(tree, dict):
        return {k: _map(fn, v, like[k]) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_map(fn, v, w) for v, w in zip(tree, like)]
    out = fn(tree, like)
    if hasattr(like, "shard_spec"):
        out.shard_spec = like.shard_spec
    return out


def int8_cache_decode(cfg, params, tokens, cache, kv_len, *, plan=None):
    """``api.decode_step`` on an int8 cache, with the reference's
    arithmetic (``repro/launch/hillclimb.py:163-176``): each int8 tensor
    is dequantised as x * 0.05 in bf16, the step runs, and each of its
    new tensors is requantised as round(x / 0.05) clipped to +-127; the
    other tensors pass as they are.  Returns (logits, int8 cache)."""
    step = torch.tensor(QUANT_STEP, dtype=torch.bfloat16)

    def deq(x, _):
        return x.to(torch.bfloat16) * step.to(x.device) \
            if x.dtype == torch.int8 else x

    def req(new, old):
        if old.dtype != torch.int8:
            return new
        return torch.clamp(torch.round(new / QUANT_STEP), -127, 127
                           ).to(torch.int8)
    logits, new_cache = api.decode_step(cfg, params, tokens,
                                        _map(deq, cache, cache), kv_len,
                                        plan=plan)
    return logits, _map(req, new_cache, cache)


def main() -> None:
    climb_minicpm3()
    climb_smollm()
    climb_gemma2()


if __name__ == "__main__":
    main()
