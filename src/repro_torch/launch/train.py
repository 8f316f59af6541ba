"""Training launcher of the port.

CPU:   PYTHONPATH=src python -m repro_torch.launch.train --device cpu --steps 50
Card:  PYTHONPATH=src python -m repro_torch.launch.train --no-reduced \\
           --batch 4 --seq 1024 --steps 30

Port of ``repro/launch/train.py``, with its flags and lines: the
production plan the LLM deployer (HELR-mesh) picks for the full-width arch
at ``train_4k``, then ``step N loss X`` every 10 steps and at the last, and
``N steps in Xs``.  Weights are drawn from seed 0 (``init_training``); the
batches are the reference's, seeded numpy tokens rolled by step % 8, with
next-token labels.  ``--ckpt-dir`` saves (params, optimizer state) every
20 steps in the reference's layout, asynchronously.  Besides the
reference's flags: ``--device`` (default ``cuda``; ``cpu`` on request) and
``--no-reduced`` (``--reduced`` is on by default, as in the reference).
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch.checkpoint import CheckpointManager
from repro_torch.configs import SHAPES, get_config
from repro_torch.core import helr_mesh
from repro_torch.device import resolve_device
from repro_torch.training import (OptConfig, TrainConfig, init_training,
                                  make_train_step, train_state_tree)

CKPT_EVERY = 20


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="smollm-135m")
    ap.add_argument("--reduced", action=argparse.BooleanOptionalAction,
                    default=True,
                    help="train the reduced config (--no-reduced: full width)")
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--optimizer", default="adamw",
                    choices=["adamw", "adafactor"])
    ap.add_argument("--ckpt-dir", default="")
    ap.add_argument("--device", default="cuda",
                    help="torch device to train on (cuda, or cpu)")
    return ap


def token_base(cfg, batch: int, seq: int) -> np.ndarray:
    """The reference launcher's tokens, [batch, seq] in [2, vocab)."""
    return np.random.default_rng(0).integers(2, cfg.vocab_size,
                                             size=(batch, seq))


def batch_at(base: np.ndarray, step: int, device) -> dict:
    """Step ``step``'s batch: the base rolled by step % 8, next-token
    labels, a full mask."""
    toks = torch.as_tensor(np.roll(base, step % 8, axis=1), dtype=torch.int32,
                           device=device)
    return {"tokens": toks, "labels": torch.roll(toks, -1, 1),
            "mask": torch.ones(toks.shape, dtype=torch.float32, device=device)}


def main(argv=None) -> dict:
    """Returns {"cfg", "params", "opt_state", "losses" (every step's),
    "seconds"}."""
    args = build_parser().parse_args(argv)
    device = resolve_device(args.device)
    full_cfg = get_config(args.arch)
    plan = helr_mesh(full_cfg, SHAPES["train_4k"])
    print(f"production plan for {args.arch}: {plan.name} "
          f"(HBM/chip {plan.hbm_used/2**30:.1f} GiB)")
    cfg = full_cfg.reduced() if args.reduced else full_cfg

    tcfg = TrainConfig(opt=OptConfig(kind=args.optimizer, lr=1e-3))
    params, opt_state = init_training(cfg, 0, tcfg, torch.float32, device)
    step_fn = make_train_step(cfg, None, tcfg)
    mgr = CheckpointManager(args.ckpt_dir) if args.ckpt_dir else None

    base = token_base(cfg, args.batch, args.seq)
    losses = []
    t0 = time.perf_counter()
    for step in range(args.steps):
        params, opt_state, m = step_fn(params, opt_state,
                                       batch_at(base, step, device), step)
        losses.append(m["loss"])
        if step % 10 == 0 or step == args.steps - 1:
            print(f"step {step:4d} loss {float(m['loss']):.4f}")
        if mgr and (step + 1) % CKPT_EVERY == 0:
            mgr.save(step + 1, train_state_tree(cfg, params, opt_state),
                     blocking=False)
    if mgr:
        mgr.wait()
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    seconds = time.perf_counter() - t0
    print(f"{args.steps} steps in {seconds:.1f}s")
    return {"cfg": cfg, "params": params, "opt_state": opt_state,
            "losses": [float(x) for x in losses], "seconds": seconds}


if __name__ == "__main__":
    main()
