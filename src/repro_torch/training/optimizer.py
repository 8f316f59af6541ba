"""Optimizers: AdamW (fp32 moments) and Adafactor (factored second moment).
Port of ``repro/training/optimizer.py``, as plain functions on tensors
(not ``torch.optim``): ``init_opt_state(params, cfg)`` -> state,
``apply_updates(params, grads, state, step, cfg)`` -> (new params, new
state), with ``params`` and ``grads`` dicts keyed by the port's parameter
names.

AdamW is elementwise, so its moments ``m`` and ``v`` are kept per port
tensor.  Adafactor is not: the reference runs it on its *stacked* leaves
(a block leaf is [n_groups, ...] over layer groups), so it factors the
second moment by the stacked leaf's rank and clips the update by the RMS
over all of the leaf's layers.  With ``stacks`` (``params.stacked_leaves``)
the port runs it on the same stacks: a layer's norm scale [d] is a slice of
a [n_groups, d] leaf, factored into ``vr`` [n_groups] and ``vc`` [d].  The
state ``vr`` / ``vc`` of a stacked leaf sits under its first layer's name
and has the stacked shape.  (``opt_state_specs``, which takes a sharding
tree, comes with the multi-device slice.)
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Literal, Optional

import torch


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


def _adafactor_update(g, vr, vc, p, step, cfg: OptConfig):
    gf = g.float()
    decay = 1.0 - (step + 1.0) ** -cfg.decay_pow
    g2 = gf * gf + 1e-30
    if p.dim() < 2:
        vr_new = decay * vr + (1 - decay) * g2
        upd = gf / torch.sqrt(vr_new + cfg.eps)
        vc_new = vc
    else:
        vr_new = decay * vr + (1 - decay) * g2.mean(dim=-1)
        vc_new = decay * vc + (1 - decay) * g2.mean(dim=-2)
        r = vr_new / vr_new.mean(dim=-1, keepdim=True).clamp_min(1e-30)
        upd = gf / (torch.sqrt(r)[..., None] * torch.sqrt(vc_new)[..., None, :]
                    + cfg.eps)
    # update clipping (adafactor rms rule)
    rms = torch.sqrt((upd * upd).mean() + 1e-30)
    upd = upd / (rms / cfg.clip_threshold).clamp_min(1.0)
    new_p = p.float() - cfg.lr * (upd + cfg.weight_decay * p.float())
    return new_p.to(p.dtype), vr_new, vc_new


@torch.no_grad()
def apply_updates(params: dict, grads: dict, state: dict, step, cfg: OptConfig,
                  stacks: Optional[dict] = None) -> tuple[dict, dict]:
    """step: the 1-based step, a number or a 0-d tensor (taken as f32, as
    the reference's is).  Returns new tensors; the inputs are not
    changed."""
    any_p = next(iter(params.values()))
    step = torch.as_tensor(step, dtype=torch.float32, device=any_p.device)
    if cfg.kind == "adamw":
        new, m, v = {}, {}, {}
        for n, p in params.items():
            new[n], m[n], v[n] = _adamw_update(grads[n], state["m"][n],
                                               state["v"][n], p, step, cfg)
        return new, {"m": m, "v": v}
    new, vr, vc = {}, {}, {}
    for key, members, stacked in _leaves(params, stacks):
        p, vr[key], vc[key] = _adafactor_update(
            _gather(grads, members, stacked), state["vr"][key],
            state["vc"][key], _gather(params, members, stacked), step, cfg)
        for i, name in enumerate(members):
            new[name] = p[i] if stacked else p
    return new, {"vr": vr, "vc": vc}
