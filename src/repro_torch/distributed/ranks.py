"""Start the ranks of one multi-device run as local processes.

``run_ranks(fn, args, world=4)`` spawns ``world`` processes; rank r sets
one torch thread, joins a default process group (gloo: it carries only
barriers and the mesh's set-up) that meets through a ``FileStore`` in a
fresh temporary directory, so concurrent runs never share a port, and
calls ``fn(r, *args)``.  ``fn`` must be importable by name (a module's
top-level function), since the processes start from a fresh interpreter.
Every wait is bounded: the group's operations time out after ``timeout``
seconds, and the parent kills every rank still alive when
``join_timeout`` passes, then raises.  A rank that raises notes its
exception beside the store, and the parent's error lists every rank's,
first-raised first: the cause, then the ranks that lost their peer.  The
collectives' own backend is chosen by the mesh the ranks make
(``repro_torch.sharding.mesh``).
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
    try:
        store = dist.FileStore(store_path, world)
        dist.init_process_group(
            "gloo", store=store, rank=rank, world_size=world,
            timeout=datetime.timedelta(seconds=timeout))
        try:
            fn(rank, *args)
            dist.barrier()
        except BaseException as e:
            _note(store_path, rank, e)      # before the peers lose this rank
            raise
        finally:
            dist.destroy_process_group()
    except BaseException as e:
        _note(store_path, rank, e)
        raise


def _note(store_path: str, rank: int, e: BaseException) -> None:
    """Note this rank's exception and when it was raised, once."""
    msg = " ".join(str(e).split())[:400]
    try:
        with open(f"{store_path}.error{rank}", "x") as f:
            f.write(f"{time.time()!r} {type(e).__name__}: {msg}")
    except FileExistsError:
        pass


def _errors(store_path: str, ranks) -> str:
    """The exceptions the failed ``ranks`` noted, first-raised first."""
    notes = []
    for r in ranks:
        try:
            with open(f"{store_path}.error{r}") as f:
                at, _, msg = f.read().partition(" ")
            notes.append((float(at), r, msg))
        except (OSError, ValueError):
            notes.append((float("inf"), r, "no exception noted"))
    notes.sort()
    t0 = notes[0][0]
    return "; ".join(f"rank {r} (+{at - t0:.2f} s): {msg}" if at < float("inf")
                     else f"rank {r}: {msg}" for at, r, msg in notes)


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
            raise RuntimeError(f"ranks failed (rank: exit code): {failed}; "
                               f"{_errors(store, failed)}")
