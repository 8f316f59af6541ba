"""Training step: loss and gradients (summed over micro-batches), the
global-norm clip and the optimizer update.  Port of
``repro/training/trainer.py``.

The parameters are the model's own ``nn.Parameter`` tensors, made
trainable by ``init_training`` (the serve path's stay frozen) and updated
in place.  On the card attention runs the K2 kernel forward and its torch
gradient (``kernels.flash_attention``); on the CPU autograd runs through
the plain versions.  ``train_state_tree`` and ``load_train_state`` put the
parameters and the optimizer state in the reference's layout and back, for
a checkpoint either package reads.

Under a sharding plan (a mesh set, the parameters cut by
``params.shard_params``) every rank takes the whole batch and returns the
global step's metrics, with its slices of the parameters and of the
optimizer state updated.  The micro-batches split the global batch, and
the loss takes each one's rows of this rank (``api.loss_fn(plan=)``).
Each rank's loss is the global one, and its backward is seeded with
1 / ranks: the collectives' backwards being their transposes, a
parameter's local gradient is then its share of the global gradient, which
is psummed over the mesh axes its spec does not name (those it is
replicated along; an fsdp gather's backward has already reduce-scattered
over its axes).  The clip's squared norm sums each slice's squares and
psums them over the axes that shard the parameter.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Optional

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.distributed.collectives import psum
from repro_torch.models import api
from repro_torch.params import (from_jax_params, from_jax_tree,
                                stacked_leaves, to_jax_tree)
from repro_torch.sharding.mesh import current_mesh
from repro_torch.sharding.specs import replicated_axes, spec_axes
from repro_torch.training.optimizer import (OptConfig, init_opt_state,
                                            update_in_place)


@dataclass(frozen=True)
class TrainConfig:
    opt: OptConfig = field(default_factory=OptConfig)
    microbatches: int = 1
    grad_clip: float = 1.0


def _split_micro(batch: dict, n: int) -> list[dict]:
    """n micro-batches of equal rows, in order; every entry of the batch
    (tokens, labels, mask, an encoder-decoder's frames) is split alike."""
    return [{k: v.reshape(n, v.shape[0] // n, *v.shape[1:])[i]
             for k, v in batch.items()} for i in range(n)]


# elements of one psum of gradients (f32: 256 MB)
BUCKET = 1 << 26


@torch.no_grad()
def _psum_grouped(tensors: dict, axes_of: dict) -> None:
    """Psum each tensor over its ``axes_of`` entry, in place: the tensors
    of one entry flattened into buckets of at most BUCKET elements, one
    psum a bucket, in the dict's order (the same on every rank)."""
    groups: dict = {}
    for n in tensors:
        if axes_of[n]:
            groups.setdefault(axes_of[n], []).append(n)
    for axes, names in groups.items():
        bucket, size = [], 0
        for i, n in enumerate(names):
            bucket.append(n)
            size += tensors[n].numel()
            if size >= BUCKET or i == len(names) - 1:
                flat = psum(torch.cat([tensors[m].reshape(-1)
                                       for m in bucket]), axes)
                for m, part in zip(bucket, flat.split(
                        [tensors[m].numel() for m in bucket])):
                    tensors[m].copy_(part.view(tensors[m].shape))
                bucket, size = [], 0


def _global_norm(grads: dict, specs: dict, axis_names) -> torch.Tensor:
    """The global gradient's L2 norm from this rank's slices: the squares
    summed per set of axes that shard a parameter, each sum psummed over
    those axes (one sum, no psum, without a mesh)."""
    sums: dict = {}
    for n, g in grads.items():
        axes = spec_axes(specs.get(n, ()), axis_names)
        sums[axes] = sums.get(axes, 0.0) + (g.float() ** 2).sum()
    return torch.sqrt(sum(psum(v, axes) for axes, v in sums.items()))


def value_and_grad(cfg: ModelConfig, plan, params, batch: dict,
                   microbatches: int = 1) -> tuple:
    """(loss, {"nll", "lb_loss"}, gradients by parameter name, f32 where
    summed over micro-batches): the loss and metrics averaged over
    ``microbatches`` equal splits of ``batch`` and the gradient of that
    average.  Under ``plan`` the gradients are this rank's slices of the
    global gradient (module docstring) and the metrics the global ones."""
    named = dict(params.named_parameters())
    names, plist = list(named), list(named.values())
    mesh = current_mesh() if plan is not None else None
    seed = 1.0 / mesh.size if mesh is not None else 1.0
    n = microbatches
    loss = metrics = grads = None
    for mb in _split_micro(batch, n) if n > 1 else [batch]:
        mb_loss, mb_metrics = api.loss_fn(cfg, params, mb, plan=plan)
        g = torch.autograd.grad(mb_loss, plist,
                                grad_outputs=torch.full_like(mb_loss, seed),
                                allow_unused=True)
        mb_metrics = {k: v.detach() for k, v in mb_metrics.items()}
        if grads is None:
            loss, metrics = mb_loss.detach(), mb_metrics
            grads = {k: torch.zeros(p.shape, dtype=torch.float32,
                                    device=p.device) for k, p in named.items()} \
                if n > 1 else {}
        else:
            loss = loss + mb_loss.detach()
            metrics = {k: metrics[k] + v for k, v in mb_metrics.items()}
        seen: set = set()
        for k, p, gk in zip(names, plist, g):
            if n > 1:
                if gk is not None:
                    grads[k] += gk
            elif gk is None:
                grads[k] = torch.zeros_like(p)
            else:
                # a tensor of its own: the grads are psummed in place
                grads[k] = gk.clone() if id(gk) in seen else gk
                seen.add(id(gk))
        del g
    if n > 1:
        for g in grads.values():
            g.div_(n)
        loss, metrics = loss / n, {k: v / n for k, v in metrics.items()}
    if mesh is not None:
        _psum_grouped(grads, {k: replicated_axes(
            getattr(named[k], "shard_spec", ()), mesh.axis_names)
            for k in grads})
    return loss, metrics, grads


def make_train_step(cfg: ModelConfig, plan, tcfg: TrainConfig):
    """Returns train_step(params, opt_state, batch, step) -> (params,
    opt_state, {"loss", "grad_norm"}): ``params`` is the model and
    ``opt_state`` the state, both updated in place (the state's entries
    replaced); ``step`` the 0-based step (the update takes step + 1).  Under
    ``plan`` (module docstring) ``params`` holds this rank's slices,
    ``opt_state`` its slices of the state (``init_opt_state`` on them) and
    ``batch`` the whole batch."""

    def train_step(params, opt_state, batch, step):
        loss, _, grads = value_and_grad(cfg, plan, params, batch,
                                        tcfg.microbatches)
        gnorm = clip_and_update(cfg, plan, tcfg, params, opt_state, grads,
                                step)
        return params, opt_state, {"loss": loss, "grad_norm": gnorm}

    return train_step


@torch.no_grad()
def clip_and_update(cfg: ModelConfig, plan, tcfg: TrainConfig, params,
                    opt_state: dict, grads: dict, step) -> torch.Tensor:
    """The train step after its gradients (``value_and_grad``'s, taken
    out of ``grads``): the global-norm clip, then the optimizer's update of
    ``params`` and ``opt_state`` in place at the 0-based ``step``.  Returns
    the norm before the clip."""
    named = dict(params.named_parameters())
    mesh = current_mesh() if plan is not None else None
    specs = {k: getattr(p, "shard_spec", ()) for k, p in named.items()} \
        if mesh is not None else None
    gnorm = _global_norm(grads, specs or {},
                         mesh.axis_names if mesh is not None else ())
    scale = torch.clamp(tcfg.grad_clip / gnorm.clamp_min(1e-9), max=1.0)
    for k in grads:
        grads[k] = grads[k] * scale
    update_in_place({k: p.detach() for k, p in named.items()}, grads,
                    opt_state, float(step) + 1.0, tcfg.opt,
                    stacked_leaves(cfg, named), specs)
    return gnorm


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
