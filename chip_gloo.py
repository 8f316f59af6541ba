"""Time multi-device serving and training on 4 ranks that share one NVIDIA
GPU over gloo (phases 16 and 17 of ``chip_smoke.py``) between checkouts,
and probe the parts of a collective that gloo stages through the host.

    python3 chip_gloo.py OLD_ROOT NEW_ROOT

First the probe, in 4 ranks of this checkout on {data: 2, model: 2}: the
seconds of one all-reduce of 256 MB of host memory over the data axis (in
both data groups at once) and of copying as much off the card into
pageable and into page-locked host memory (median of 3 after a warm-up).
Then each checkout runs in a process of its own, in the order OLD, NEW,
NEW, OLD, so both meet the same card: it builds its kernels and runs
``chip_smoke.phase_sharded`` and ``phase_sharded_train`` with their
checks, and prints one JSON line: each phase's seconds, each serve run's
decode ms a step and prefill ms a batch, each train run's step ms (rank
0's, and the card alone's), and rank 0's calls and seconds inside gloo.
Needs a CUDA device; imports no JAX.
"""
from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
import tempfile
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
PROBE_MB = 256


def probe_rank(rank: int, out_dir: str) -> None:
    import torch
    import torch.distributed as dist
    from repro_torch.sharding import Mesh

    torch.cuda.set_device(0)
    mesh = Mesh({"data": 2, "model": 2}, device="cuda")
    n = PROBE_MB * 2**20 // 4
    host, dev = torch.ones(n), torch.ones(n, device="cuda")
    pinned = torch.empty(n, pin_memory=True)

    def secs(fn, reps=3):
        fn()
        dist.barrier()
        times = []
        for _ in range(reps):
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t0)
        return statistics.median(times)
    rec = {"mb": PROBE_MB,
           "all_reduce_s": secs(lambda: dist.all_reduce(
               host, group=mesh.group("data"))),
           "d2h_pageable_s": secs(lambda: dev.to("cpu")),
           "d2h_pinned_s": secs(lambda: pinned.copy_(dev))}
    (Path(out_dir) / f"probe{rank}.json").write_text(json.dumps(rec))


def probe() -> dict:
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.distributed.ranks import run_ranks

    with tempfile.TemporaryDirectory() as tmp:
        run_ranks(probe_rank, (tmp,), world=4, timeout=120.0,
                  join_timeout=300.0)
        return json.loads((Path(tmp) / "probe0.json").read_text())


def measure(root: Path) -> dict:
    sys.path.insert(0, str(root))
    import chip_smoke as c

    phase_s = {}
    for name, fn in (("build", c.phase_build), ("sharded", c.phase_sharded),
                     ("sharded_train", c.phase_sharded_train)):
        t0 = time.perf_counter()
        out = fn()
        phase_s[name] = time.perf_counter() - t0
        if name == "sharded":
            serve = {k: {"decode_ms_per_step": r["decode_ms_per_step"],
                         "prefill_ms": [b["prefill_ms"] for b in r["batches"]],
                         "gloo_rank0": r["gloo_rank0"]}
                     for k, r in out["runs"].items()}
        elif name == "sharded_train":
            train = {k: {"step_ms": r["step_ms"][0] if "mesh" in r
                         else r["step_ms"], "gloo_rank0": r["gloo"]}
                     for k, r in out["runs"].items()}
    return {"phase_s": phase_s, "sharded": serve, "sharded_train": train}


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("roots", nargs="*", type=Path,
                    help="checkouts: OLD NEW runs OLD, NEW, NEW, OLD")
    ap.add_argument("--one", type=Path, help=argparse.SUPPRESS)
    ap.add_argument("--probe", action="store_true", help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.one:
        print(json.dumps(measure(args.one.resolve())))
        return
    if args.probe:
        print(json.dumps(probe()))
        return
    if len(args.roots) != 2:
        ap.error("name two checkouts")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    print(f"card: {smi}", flush=True)
    old, new = (r.resolve() for r in args.roots)
    for flag, what in ((["--probe"], "probe"),
                       *((["--one", str(r)], str(r)) for r in (old, new, new, old))):
        res = subprocess.run([sys.executable, __file__, *flag],
                             capture_output=True, text=True, timeout=900)
        if res.returncode:
            sys.exit(f"{what}: exit {res.returncode}\n{res.stdout[-4000:]}\n"
                     f"{res.stderr[-4000:]}")
        print(f"{what} {res.stdout.strip().splitlines()[-1]}", flush=True)


if __name__ == "__main__":
    main()
