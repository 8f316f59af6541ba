"""Serving launcher of the port: UELLM's pipeline on a real model.

  PYTHONPATH=src python -m repro_torch.launch.serve --no-reduced --device cuda

Port of the single-engine default path of ``repro/launch/serve.py``: the
resource profiler predicts each request's output length, SLO-ODBS (or the
``--scheduler`` baseline) composes batches, the padded engine runs each
batch (``--continuous``: the continuous engine runs the queue), and the
monitor feeds every finished request back into the predictor online.  Same
flags and defaults as the reference; ``--reduced`` is on by default and
``--no-reduced`` serves the full-width model.  The paged, prefix, speculate,
cluster, fault and profile flags exit with "not ported yet".
"""
from __future__ import annotations

import argparse
import hashlib
import json
import time

import torch

from repro_torch.configs import get_config
from repro_torch.configs.base import ModelConfig
from repro_torch.core import (LengthPredictor, Monitor, PredictorConfig,
                              ResourceProfiler, SchedulerConfig, get_scheduler)
from repro_torch.core.types import Request
from repro_torch.data.workload import WorkloadConfig, gen_requests, train_pairs
from repro_torch.device import resolve_device
from repro_torch.models import api
from repro_torch.models.transformer import Transformer
from repro_torch.serving import EngineConfig, InferenceEngine

# flags of the reference CLI whose paths later slices port
_LATER_FLAGS = {
    "paged-engine slice": ("--paged", "--prefix-cache", "--lookahead",
                           "--chunk-tokens", "--preempt", "--speculate",
                           "--spec-tokens", "--drafter", "--kv-budget"),
    "cluster slice": ("--replicas", "--models", "--fleet", "--router",
                      "--autoscale", "--fault-crash", "--fault-mtbf",
                      "--fault-mttr", "--fault-seed", "--retry-budget",
                      "--retry-backoff", "--detect-lag", "--health-interval",
                      "--brownout-tiers"),
    "observability slice": ("--trace", "--metrics-json", "--profile-out",
                            "--profile-in", "--pricing-quantile",
                            "--profile-half-life"),
}


def outputs_digest(done: dict) -> str:
    """Order-independent digest of the generated tokens, computed exactly
    as the reference's ``_outputs_digest``."""
    blob = json.dumps(sorted((int(k), list(map(int, v)))
                             for k, v in done.items()))
    return hashlib.sha1(blob.encode()).hexdigest()[:12]


def make_requests(cfg: ModelConfig, n: int, max_new: int,
                  workload: str = "alpaca") -> list[Request]:
    """The reference serve path's request stream: seeded workload, prompts
    cut to 16 tokens of the model's vocab, output lengths in [1, max_new]."""
    pattern = workload if workload in ("bursty", "diurnal") else "poisson"
    reqs = gen_requests(WorkloadConfig(n_requests=n, seed=0,
                                       vocab=cfg.vocab_size,
                                       arrival_pattern=pattern))
    for r in reqs:
        r.tokens = [t % cfg.vocab_size for t in r.tokens[:16]]
        r.input_len = len(r.tokens)
        r.true_output_len = r.true_output_len % max_new + 1
    return reqs


def fit_predictor(cfg: ModelConfig, device) -> LengthPredictor:
    """The serve path's length predictor: seed 0, 8 epochs on 256 pairs."""
    pred = LengthPredictor(PredictorConfig(vocab=cfg.vocab_size), seed=0,
                           device=device)
    toks, lens = train_pairs(WorkloadConfig(vocab=cfg.vocab_size), 256, seed=1)
    pred.fit(toks, lens, epochs=8)
    return pred


def serve(cfg: ModelConfig, params: Transformer, reqs: list[Request],
          predictor: LengthPredictor, *, scheduler: str = "slo-odbs",
          continuous: bool = False, max_new: int = 16) -> dict:
    """Profile -> schedule -> execute -> monitor, on the device the
    parameters live on.  Returns the outputs, their digest, the batch
    results, the elapsed seconds and the monitor."""
    engine = InferenceEngine(cfg, params,
                             EngineConfig(max_batch=4, cache_len=64,
                                          max_new_tokens=max_new))
    prof = ResourceProfiler(predictor, cfg)
    mon = Monitor(prof)
    prof.profile(reqs)
    results = []
    t0 = time.perf_counter()
    if continuous:
        res = engine.run_continuous(sorted(reqs, key=lambda r: r.arrival))
        results.append(res)
        done = res.outputs
    else:
        done = {}
        for b in get_scheduler(scheduler)(reqs, SchedulerConfig(max_batch=4)):
            res = engine.run_batch(b, true_lens={r.rid: r.true_output_len
                                                 for r in b.requests})
            results.append(res)
            done.update(res.outputs)
            for r in b.requests:
                mon.observe(r)
    seconds = time.perf_counter() - t0
    return {"outputs": done, "digest": outputs_digest(done),
            "results": results, "seconds": seconds,
            "tokens": sum(len(v) for v in done.values()), "monitor": mon}


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="smollm-135m")
    ap.add_argument("--reduced", action=argparse.BooleanOptionalAction,
                    default=True,
                    help="serve the reduced config (--no-reduced: full width)")
    ap.add_argument("--requests", type=int, default=12)
    ap.add_argument("--scheduler", default="slo-odbs",
                    choices=["slo-odbs", "slo-dbs", "odbs", "fifo", "s3"])
    ap.add_argument("--continuous", action="store_true",
                    help="beyond-paper continuous batching mode")
    ap.add_argument("--workload", default="alpaca",
                    choices=["alpaca", "shared-prefix", "bursty", "diurnal"])
    ap.add_argument("--max-new", type=int, default=16)
    ap.add_argument("--device", default="cuda",
                    help="torch device to serve on (cuda, or cpu)")
    for slice_name, flags in _LATER_FLAGS.items():
        for flag in flags:
            ap.add_argument(flag, nargs="?", const=True,
                            default=argparse.SUPPRESS,
                            help=f"not ported yet ({slice_name})")
    return ap


def main(argv=None) -> dict:
    ap = build_parser()
    args = ap.parse_args(argv)
    for slice_name, flags in _LATER_FLAGS.items():
        for flag in flags:
            if hasattr(args, flag[2:].replace("-", "_")):
                ap.error(f"{flag} is not ported yet ({slice_name})")
    if args.workload == "shared-prefix":
        ap.error("--workload shared-prefix is not ported yet "
                 "(paged-engine slice)")
    device = resolve_device(args.device)
    where = (f"{device} ({torch.cuda.get_device_name(device)})"
             if device.type == "cuda" else str(device))

    cfg = get_config(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    print(f"serving {cfg.name} ({cfg.n_layers} layers, d_model {cfg.d_model}) "
          f"on {where}")
    params = api.init_params(cfg, seed=0, dtype=torch.float32, device=device)
    reqs = make_requests(cfg, args.requests, args.max_new, args.workload)
    out = serve(cfg, params, reqs, fit_predictor(cfg, device),
                scheduler=args.scheduler, continuous=args.continuous,
                max_new=args.max_new)
    dt, total = out["seconds"], out["tokens"]
    print(f"served {len(out['outputs'])} requests, {total} tokens in "
          f"{dt:.2f}s ({total / dt:.1f} tok/s on {where})")
    print(f"outputs_digest={out['digest']}")
    print("monitor:", out["monitor"].metrics())
    return out


if __name__ == "__main__":
    main()
