"""Load the JAX package's parameters into the port.

The reference keeps its parameter tree as nested dicts.  A decoder-only
model's block leaves are stacked ``[n_groups, ...]`` over layer groups
keyed ``l0..l{period-1}``; an encoder-decoder's ``enc_blocks`` and
``dec_blocks`` are each stacked ``[n_layers, ...]`` directly.
``from_jax_params`` takes that tree with **numpy** leaves (e.g.
``jax.tree.map(np.asarray, params)``, made by the caller) and returns the
state dict of ``models.transformer.Transformer`` (layer ``g * period + i``
taking group ``g``'s slice of ``l{i}``) or of ``models.encdec.EncDec``
(``enc_blocks.{i}`` and ``dec_blocks.{i}`` taking slice ``i`` of their
stack).  ``to_jax_tree`` goes the other way, for checkpoints the reference
reads.  ``stacked_leaves`` names the port tensors that make up each of the
reference's stacked leaves (Adafactor factors and clips per such leaf).
``shard_params`` cuts a loaded model to one rank's slices under a sharding
plan (``sharding.specs``), marking the dimensions the plan's fsdp axes
shard.  No JAX import happens here.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig, group_period
from repro_torch.core.profiler import LengthPredictor, PredictorConfig

STACKS = ("blocks", "enc_blocks", "dec_blocks")


def _flatten(tree: dict, prefix: str, out: dict) -> None:
    for key, val in tree.items():
        name = f"{prefix}{key}"
        if isinstance(val, dict):
            _flatten(val, name + ".", out)
        else:
            out[name] = val


def _unstack(stack: dict, name_of, out: dict) -> None:
    """Slice ``g`` of every stacked leaf of ``stack`` into
    ``out[name_of(g, leaf name)]``."""
    flat: dict = {}
    _flatten(stack, "", flat)
    for name, stacked in flat.items():
        for g in range(stacked.shape[0]):
            out[name_of(g, name)] = stacked[g]


def _tensor(v) -> torch.Tensor:
    return v.clone() if isinstance(v, torch.Tensor) \
        else torch.from_numpy(np.array(v, copy=True))


def from_jax_params(tree: dict) -> dict[str, torch.Tensor]:
    """Reference parameter tree (numpy leaves) -> the port's state dict."""
    out: dict = {}
    _flatten({k: v for k, v in tree.items() if k not in STACKS}, "", out)
    for key in ("enc_blocks", "dec_blocks"):
        if key in tree:
            _unstack(tree[key], lambda g, n, key=key: f"{key}.{g}.{n}", out)
    groups = tree.get("blocks", {})
    period = len(groups)
    for i in range(period):
        _unstack(groups[f"l{i}"],
                 lambda g, n, i=i: f"blocks.{g * period + i}.{n}", out)
    return {k: _tensor(v) for k, v in out.items()}


def stacked_leaves(cfg: ModelConfig, names) -> dict[str, list[str]]:
    """For each stacked leaf of the reference's tree, the port names that
    make it up, in stacking order, keyed by the first of them: layer j of
    ``blocks`` is group j // period of leaf ``l{j % period}``; every layer
    of ``enc_blocks`` / ``dec_blocks`` is one slice of its stack.  Names
    outside those stacks are leaves of their own and are not listed."""
    period = 1 if cfg.is_encdec else group_period(cfg)
    groups: dict[str, list[str]] = {}
    for name in names:
        top, _, rest = name.partition(".")
        if top in STACKS:
            j, _, leaf = rest.partition(".")
            key = f"{top}.{int(j) % period if top == 'blocks' else 0}.{leaf}"
            groups.setdefault(key, []).append(name)
    for members in groups.values():
        members.sort(key=lambda n: int(n.split(".")[1]))
    return groups


def ref_path(key: str) -> list[str]:
    """The reference's tree path of a port name or ``stacked_leaves`` key."""
    top, _, rest = key.partition(".")
    if top == "blocks":
        i, _, leaf = rest.partition(".")
        return ["blocks", f"l{i}", *leaf.split(".")]
    if top in STACKS:
        return [top, *rest.partition(".")[2].split(".")]
    return key.split(".")


def to_jax_tree(cfg: ModelConfig, flat: dict, *, stacked: bool = False) -> dict:
    """The port's tensors (torch or numpy, kept as they are) in the
    reference's nested layout.  ``flat`` is keyed by port names, stacked
    here as the reference stacks them, or with ``stacked`` by
    ``stacked_leaves`` keys whose tensors are whole stacked leaves already
    (Adafactor's state)."""
    stacks = {} if stacked else stacked_leaves(cfg, flat)
    members = {m for ms in stacks.values() for m in ms}
    leaves = {k: v for k, v in flat.items() if k not in members}
    for key, ms in stacks.items():
        parts = [flat[m] for m in ms]
        leaves[key] = torch.stack(parts) if isinstance(parts[0], torch.Tensor) \
            else np.stack(parts)
    tree: dict = {}
    for key, leaf in leaves.items():
        *path, last = ref_path(key)
        node = tree
        for part in path:
            node = node.setdefault(part, {})
        node[last] = leaf
    return tree


def from_jax_tree(tree: dict) -> dict[str, torch.Tensor]:
    """Inverse of ``to_jax_tree(..., stacked=True)``: the reference's
    nested leaves keyed by ``stacked_leaves`` keys, not unstacked."""
    out: dict = {}
    _flatten({k: v for k, v in tree.items() if k not in STACKS}, "", out)
    for top in ("enc_blocks", "dec_blocks"):
        if top in tree:
            _flatten(tree[top], f"{top}.0.", out)
    for group, sub in tree.get("blocks", {}).items():
        _flatten(sub, f"blocks.{group[1:]}.", out)
    return {k: _tensor(v) for k, v in out.items()}


def predictor_from_numpy(params: dict, cfg: PredictorConfig = PredictorConfig(),
                         *, device="cuda") -> LengthPredictor:
    """A ``LengthPredictor`` carrying the reference predictor's parameters
    ({"embed", "w1", "b1", "w2", "b2"} as numpy arrays)."""
    pred = LengthPredictor(cfg, device=device)
    with torch.no_grad():
        for name, p in pred.net.named_parameters():
            p.copy_(torch.from_numpy(np.array(params[name], copy=True)))
    return pred


def shard_params(cfg: ModelConfig, model: torch.nn.Module, plan) -> None:
    """Cut every parameter of ``model`` (full tensors, e.g. a converted
    reference tree loaded with ``load_state_dict``, or weights drawn at
    full size) to this rank's slice under ``plan`` on the current mesh, in
    place; each slice carries its spec as ``shard_spec``, which the model
    code reads.  Where the plan's ``fsdp_axes`` shard a dimension, the
    slice also carries ``fsdp_spec`` (those axes at those dimensions, None
    elsewhere): the model code gathers such a weight before it uses it
    (``models.common.gather_params``).  The full tensors are freed as their
    slices replace them; a slice keeps the parameter's ``requires_grad``."""
    import dataclasses
    from repro_torch.sharding.mesh import current_mesh
    from repro_torch.sharding.specs import param_spec, shard_tensor
    mesh = current_mesh()
    if mesh is None:
        raise RuntimeError("shard_params needs a mesh (sharding.mesh.set_mesh)")
    tp_plan = dataclasses.replace(plan, fsdp_axes=()) if plan is not None \
        else None
    for name, p in list(model.named_parameters()):
        spec = param_spec(cfg, plan, name, tuple(p.shape), mesh.shape)
        tp_spec = param_spec(cfg, tp_plan, name, tuple(p.shape), mesh.shape)
        part = shard_tensor(p.data, spec)
        if part.numel() < p.numel():      # a view would keep the full one
            part = part.clone()
        part = torch.nn.Parameter(part, requires_grad=p.requires_grad)
        part.shard_spec = spec
        if spec != tp_spec:
            part.fsdp_spec = tuple(s if s != t else None
                                   for s, t in zip(spec, tp_spec))
        owner, _, leaf = name.rpartition(".")
        setattr(model.get_submodule(owner), leaf, part)
