"""Optimizers: AdamW (fp32 moments) and Adafactor (factored second moment).
Port of ``repro/training/optimizer.py``, as plain functions on tensors
(not ``torch.optim``): ``init_opt_state(params, cfg)`` -> state,
``apply_updates(params, grads, state, step, cfg)`` -> (new params, new
state), with ``params`` and ``grads`` dicts keyed by the port's parameter
names; ``update_in_place`` computes the same one leaf at a time into the
parameters and the state it is given (the train step's form: it never
holds a second copy of the parameters or the state).

AdamW is elementwise, so its moments ``m`` and ``v`` are kept per port
tensor.  Adafactor is not: the reference runs it on its *stacked* leaves
(a block leaf is [n_groups, ...] over layer groups), so it factors the
second moment by the stacked leaf's rank and clips the update by the RMS
over all of the leaf's layers.  With ``stacks`` (``params.stacked_leaves``)
the port runs it on the same stacks: a layer's norm scale [d] is a slice of
a [n_groups, d] leaf, factored into ``vr`` [n_groups] and ``vc`` [d].  The
state ``vr`` / ``vc`` of a stacked leaf sits under its first layer's name
and has the stacked shape.

Under a sharding plan each rank holds its slice of every parameter, and
of every stacked leaf (the layers are never sharded), and so its slice
of the state: ``opt_state_specs`` gives the state's layout, the
reference's ``opt_state_specs`` on the port's names.  AdamW needs no
communication.  Adafactor takes ``specs`` (each parameter's spec) and
psums wherever it reduces across a sharded dimension: the row and column
means of the squared gradient, the mean of the row factor, and the mean
square of the update that its clip reads.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Literal, Optional

import torch

from repro_torch.distributed.collectives import psum
from repro_torch.sharding.mesh import axis_size, current_mesh
from repro_torch.sharding.specs import spec_axes


@dataclass(frozen=True)
class OptConfig:
    kind: Literal["adamw", "adafactor"] = "adamw"
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.999
    eps: float = 1e-8
    weight_decay: float = 0.01
    # adafactor
    decay_pow: float = 0.8
    clip_threshold: float = 1.0


def _leaves(params: dict, stacks: Optional[dict]):
    """(state key, member names, stacked) of every leaf the reference's
    tree would have."""
    stacks = stacks or {}
    in_stack = {m for ms in stacks.values() for m in ms}
    for name in params:
        if name not in in_stack:
            yield name, [name], False
    for key, members in stacks.items():
        yield key, members, True


def _gather(tensors: dict, members: list, stacked: bool) -> torch.Tensor:
    return torch.stack([tensors[m] for m in members]) if stacked \
        else tensors[members[0]]


def _leaf_spec(specs: Optional[dict], members: list, stacked: bool):
    """The spec of a reference leaf (a stacked leaf's layer dimension is
    never sharded), or None without specs."""
    if specs is None:
        return None
    spec = tuple(specs[members[0]])
    return ((None,) + spec) if stacked else spec


def opt_state_specs(specs: dict, cfg: OptConfig,
                    stacks: Optional[dict] = None) -> dict:
    """The optimizer state's specs for the parameters' ``specs`` (port
    name -> spec): AdamW's moments as the parameters; Adafactor's row
    factor drops a leaf's last dimension's entry, its column factor the
    second-to-last (a vector's column factor is (None,)), keyed as
    ``init_opt_state`` keys them."""
    if cfg.kind == "adamw":
        return {"m": dict(specs), "v": dict(specs)}
    vr, vc = {}, {}
    for key, members, stacked in _leaves(specs, stacks):
        spec = _leaf_spec(specs, members, stacked)
        if len(spec) >= 2:
            vr[key], vc[key] = spec[:-1], spec[:-2] + spec[-1:]
        else:
            vr[key], vc[key] = spec, (None,)
    return {"vr": vr, "vc": vc}


def init_opt_state(params: dict, cfg: OptConfig,
                   stacks: Optional[dict] = None) -> dict:
    """Zero state, f32, on the parameters' device."""
    if cfg.kind == "adamw":
        return {"m": {n: torch.zeros(p.shape, dtype=torch.float32,
                                     device=p.device) for n, p in params.items()},
                "v": {n: torch.zeros(p.shape, dtype=torch.float32,
                                     device=p.device) for n, p in params.items()}}
    vr, vc = {}, {}
    for key, members, stacked in _leaves(params, stacks):
        p = params[members[0]]
        shape = ((len(members),) if stacked else ()) + tuple(p.shape)
        kw = dict(dtype=torch.float32, device=p.device)
        if len(shape) < 2:
            vr[key], vc[key] = torch.zeros(shape, **kw), torch.zeros((1,), **kw)
        else:
            vr[key] = torch.zeros(shape[:-1], **kw)
            vc[key] = torch.zeros(shape[:-2] + shape[-1:], **kw)
    return {"vr": vr, "vc": vc}


def _adamw_update(g, m, v, p, step, cfg: OptConfig):
    gf = g.float()
    m = cfg.b1 * m + (1 - cfg.b1) * gf
    v = cfg.b2 * v + (1 - cfg.b2) * gf * gf
    mh = m / (1 - cfg.b1 ** step)
    vh = v / (1 - cfg.b2 ** step)
    upd = mh / (torch.sqrt(vh) + cfg.eps) + cfg.weight_decay * p.float()
    return (p.float() - cfg.lr * upd).to(p.dtype), m, v


def _mean(x: torch.Tensor, dim: int, spec, keepdim: bool = False):
    """x's mean over ``dim``, whose entry of ``spec`` (x's layout, or
    None) may shard it: then the shards' sums are psummed."""
    ax = spec[dim] if spec else None
    if ax is None:
        return x.mean(dim=dim, keepdim=keepdim)
    return psum(x.sum(dim=dim, keepdim=keepdim), ax) \
        / (x.shape[dim] * axis_size(ax))


def _mean_all(x: torch.Tensor, spec) -> torch.Tensor:
    """The mean of every element of x, whose shards ``spec`` lays out."""
    mesh = current_mesh()
    axes = spec_axes(spec, mesh.axis_names) if spec and mesh else ()
    if not axes:
        return x.mean()
    return psum(x.sum(), axes) / (x.numel() * axis_size(axes))


def _adafactor_update(g, vr, vc, p, step, cfg: OptConfig, spec=None):
    gf = g.float()
    decay = 1.0 - (step + 1.0) ** -cfg.decay_pow
    g2 = gf * gf + 1e-30
    if p.dim() < 2:
        vr_new = decay * vr + (1 - decay) * g2
        upd = gf / torch.sqrt(vr_new + cfg.eps)
        vc_new = vc
    else:
        vr_new = decay * vr + (1 - decay) * _mean(g2, -1, spec)
        vc_new = decay * vc + (1 - decay) * _mean(g2, -2, spec)
        row_mean = _mean(vr_new, -1, spec[:-1] if spec else None, keepdim=True)
        r = vr_new / row_mean.clamp_min(1e-30)
        upd = gf / (torch.sqrt(r)[..., None] * torch.sqrt(vc_new)[..., None, :]
                    + cfg.eps)
    # update clipping (adafactor rms rule)
    rms = torch.sqrt(_mean_all(upd * upd, spec) + 1e-30)
    upd = upd / (rms / cfg.clip_threshold).clamp_min(1.0)
    new_p = p.float() - cfg.lr * (upd + cfg.weight_decay * p.float())
    return new_p.to(p.dtype), vr_new, vc_new


@torch.no_grad()
def apply_updates(params: dict, grads: dict, state: dict, step, cfg: OptConfig,
                  stacks: Optional[dict] = None,
                  specs: Optional[dict] = None) -> tuple[dict, dict]:
    """step: the 1-based step, a number or a 0-d tensor (taken as f32, as
    the reference's is).  With ``specs`` (port name -> spec, on the current
    mesh) ``params``, ``grads`` and ``state`` are this rank's slices.
    Returns new tensors; the inputs are not changed."""
    new = {n: p.clone() for n, p in params.items()}
    new_state = {part: dict(tensors) for part, tensors in state.items()}
    update_in_place(new, dict(grads), new_state, step, cfg, stacks, specs)
    return new, new_state


@torch.no_grad()
def update_in_place(params: dict, grads: dict, state: dict, step,
                    cfg: OptConfig, stacks: Optional[dict] = None,
                    specs: Optional[dict] = None) -> None:
    """The update, one reference leaf at a time: each parameter tensor of
    ``params`` is overwritten with its new value, each entry of ``state``
    replaced by its new tensor, and each gradient taken out of ``grads``
    when its leaf is done, so no more than one leaf's new tensors are
    alive at once.  ``step`` and ``specs`` as ``apply_updates`` takes
    them."""
    any_p = next(iter(params.values()))
    step = torch.as_tensor(step, dtype=torch.float32, device=any_p.device)
    if cfg.kind == "adamw":
        for n, p in params.items():
            new, state["m"][n], state["v"][n] = _adamw_update(
                grads.pop(n), state["m"][n], state["v"][n], p, step, cfg)
            p.copy_(new)
        return
    for key, members, stacked in _leaves(params, stacks):
        g = _gather(grads, members, stacked)
        for name in members:
            del grads[name]
        new, state["vr"][key], state["vc"][key] = _adafactor_update(
            g, state["vr"][key], state["vc"][key],
            _gather(params, members, stacked), step, cfg,
            _leaf_spec(specs, members, stacked))
        for i, name in enumerate(members):
            params[name].copy_(new[i] if stacked else new)
