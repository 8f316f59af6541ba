"""Start the ranks of one multi-device run as local processes.

``run_ranks(fn, args, world=4)`` spawns ``world`` processes; rank r sets
one torch thread, joins a default process group (gloo: it carries only
barriers and the mesh's set-up) that meets through a ``FileStore`` in a
fresh temporary directory, so concurrent runs never share a port, and
calls ``fn(r, *args)``.  ``fn`` must be importable by name (a module's
top-level function), since the processes start from a fresh interpreter.
Every wait is bounded: the group's operations time out after ``timeout``
seconds, and the parent kills every rank still alive when
``join_timeout`` passes, then raises.  The collectives' own backend is
chosen by the mesh the ranks make (``repro_torch.sharding.mesh``).
"""
from __future__ import annotations

import datetime
import multiprocessing
import os
import tempfile
import time

import torch
import torch.distributed as dist


def _rank_main(rank: int, world: int, store_path: str, timeout: float,
               fn, args: tuple) -> None:
    torch.set_num_threads(1)
    store = dist.FileStore(store_path, world)
    dist.init_process_group(
        "gloo", store=store, rank=rank, world_size=world,
        timeout=datetime.timedelta(seconds=timeout))
    try:
        fn(rank, *args)
        dist.barrier()
    finally:
        dist.destroy_process_group()


def run_ranks(fn, args: tuple = (), *, world: int = 4, timeout: float = 120.0,
              join_timeout: float = 600.0) -> None:
    """Run ``fn(rank, *args)`` on ``world`` spawned ranks; raise
    ``RuntimeError`` if a rank fails and ``TimeoutError`` if any is still
    running after ``join_timeout`` seconds (all are stopped first)."""
    ctx = multiprocessing.get_context("spawn")
    with tempfile.TemporaryDirectory(prefix="ranks-") as tmp:
        store = os.path.join(tmp, "store")
        procs = [ctx.Process(target=_rank_main,
                             args=(r, world, store, timeout, fn, args))
                 for r in range(world)]
        for p in procs:
            p.start()
        deadline = time.monotonic() + join_timeout
        try:
            for p in procs:
                p.join(max(deadline - time.monotonic(), 0.0))
        finally:
            hung = [r for r, p in enumerate(procs) if p.is_alive()]
            for p in procs:
                if p.is_alive():
                    p.kill()
                    p.join(10)
        if hung:
            raise TimeoutError(f"ranks {hung} still running after "
                               f"{join_timeout} s")
        failed = {r: p.exitcode for r, p in enumerate(procs) if p.exitcode}
        if failed:
            raise RuntimeError(f"ranks failed (rank: exit code): {failed}")
