"""Training step: loss and gradients (summed over micro-batches), the
global-norm clip and the optimizer update.  Port of
``repro/training/trainer.py``, single-device (no sharding plan).

The parameters are the model's own ``nn.Parameter`` tensors, made
trainable by ``init_training`` (the serve path's stay frozen) and updated
in place.  On the card attention runs the K2 kernel forward and its torch
gradient (``kernels.flash_attention``); on the CPU autograd runs through
the plain versions.  ``train_state_tree`` and ``load_train_state`` put the
parameters and the optimizer state in the reference's layout and back, for
a checkpoint either package reads.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Optional

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import api
from repro_torch.params import (from_jax_params, from_jax_tree,
                                stacked_leaves, to_jax_tree)
from repro_torch.training.optimizer import (OptConfig, apply_updates,
                                            init_opt_state)


@dataclass(frozen=True)
class TrainConfig:
    opt: OptConfig = field(default_factory=OptConfig)
    microbatches: int = 1
    grad_clip: float = 1.0


def _split_micro(batch: dict, n: int) -> list[dict]:
    """n micro-batches of equal rows, in order."""
    return [{k: v.reshape(n, v.shape[0] // n, *v.shape[1:])[i]
             for k, v in batch.items()} for i in range(n)]


def make_train_step(cfg: ModelConfig, plan, tcfg: TrainConfig):
    """Returns train_step(params, opt_state, batch, step) -> (params,
    opt_state, {"loss", "grad_norm"}): ``params`` is the model, updated in
    place; ``step`` the 0-based step (the update takes step + 1)."""
    if plan is not None:
        raise NotImplementedError(
            "make_train_step under a plan comes with the sharded training slice")

    def grads_of(names, plist, params, mb):
        loss, _ = api.loss_fn(cfg, params, mb)
        grads = torch.autograd.grad(loss, plist, allow_unused=True)
        return loss.detach(), {n: torch.zeros_like(p) if g is None else g
                               for n, p, g in zip(names, plist, grads)}

    def train_step(params, opt_state, batch, step):
        named = dict(params.named_parameters())
        names, plist = list(named), list(named.values())
        n = tcfg.microbatches
        if n > 1:
            grads = {k: torch.zeros(p.shape, dtype=torch.float32,
                                    device=p.device) for k, p in named.items()}
            loss = torch.zeros((), dtype=torch.float32, device=plist[0].device)
            for mb in _split_micro(batch, n):
                mb_loss, g = grads_of(names, plist, params, mb)
                for k in grads:
                    grads[k] += g[k]
                loss = loss + mb_loss
            grads = {k: g / n for k, g in grads.items()}
            loss = loss / n
        else:
            loss, grads = grads_of(names, plist, params, batch)
        with torch.no_grad():
            gnorm = torch.sqrt(sum((g.float() ** 2).sum()
                                   for g in grads.values()))
            scale = torch.clamp(tcfg.grad_clip / gnorm.clamp_min(1e-9), max=1.0)
            grads = {k: g * scale for k, g in grads.items()}
            new, opt_state = apply_updates(
                {k: p.detach() for k, p in named.items()}, grads, opt_state,
                float(step) + 1.0, tcfg.opt, stacked_leaves(cfg, named))
            for k, p in named.items():
                p.copy_(new[k])
        return params, opt_state, {"loss": loss, "grad_norm": gnorm}

    return train_step


def init_training(cfg: ModelConfig, seed: int, tcfg: TrainConfig,
                  dtype=torch.float32, device: str | torch.device = "cuda"):
    """Seeded weights (``api.init_params``), made trainable, and a zero
    optimizer state.  Returns (params, opt_state)."""
    params = api.init_params(cfg, seed, dtype, device)
    params.requires_grad_(True)
    named = {k: p.detach() for k, p in params.named_parameters()}
    return params, init_opt_state(named, tcfg.opt, stacked_leaves(cfg, named))


def train_state_tree(cfg: ModelConfig, params, opt_state: dict) -> tuple:
    """(params, opt_state) in the reference's layout, the tree its
    launcher checkpoints: block leaves stacked, Adafactor's state under
    its stacked leaves' paths.  Leaves are detached tensors."""
    named = {k: p.detach() for k, p in params.named_parameters()}
    if "m" in opt_state:
        opt = {k: to_jax_tree(cfg, opt_state[k]) for k in ("m", "v")}
    else:
        opt = {k: to_jax_tree(cfg, opt_state[k], stacked=True)
               for k in ("vr", "vc")}
    return to_jax_tree(cfg, named), opt


def load_train_state(params, tree: tuple,
                     device: Optional[str | torch.device] = None) -> dict:
    """Load a ``train_state_tree``-layout tree (a restored checkpoint of
    either package) into ``params`` in place; returns the optimizer state
    on ``device`` (the parameters' device by default)."""
    ptree, otree = tree
    device = device or next(params.parameters()).device
    params.load_state_dict(from_jax_params(ptree))
    if "m" in otree:
        return {k: {n: t.to(device) for n, t in from_jax_params(otree[k]).items()}
                for k in ("m", "v")}
    return {k: {n: t.to(device) for n, t in from_jax_tree(otree[k]).items()}
            for k in ("vr", "vc")}
