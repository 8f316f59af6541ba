"""Parameter and cache layouts of the port under a plan.  Port of
``repro/sharding/specs.py``.

``param_specs`` applies the reference's per-tensor rules to the port's
parameters, named as in its state dict (``blocks.3.mixer.q.w``): TP on the
model axis wherever the tensor's sharded dimension divides (head-aligned
for attention, always for FFN and vocab), FSDP over the plan's fsdp axes,
EP for expert banks, replication elsewhere.  A port name maps to the
reference's tree path through ``params.ref_path``; the reference stacks a
decoder's layers along a leading dimension that is never sharded, and the
port's spec of one layer's tensor is the reference's without that entry.
``cache_specs_tree`` does the same for the decode cache (a list with one
nested dict a layer): K/V head-sharded under head-TP, else sequence-sharded
over the plan's seq axes where the cache length divides them (a ring of a
window layer never), states batch-sharded.

A spec is a tuple as in ``repro_torch.sharding.plan``, one axis written
as its name, as ``PartitionSpec`` writes it.  ``shard_tree``
cuts this rank's slice of each full tensor (the reference's
``device_put`` onto a ``NamedSharding``); ``gather_tree`` puts the full
tensors back together, for tests.  ``spec_axes`` and ``replicated_axes``
name the mesh axes a spec shards over and those it is replicated along
(the sharded train step psums a gradient over the latter).
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.distributed.collectives import all_gather, local_chunk
from repro_torch.params import ref_path
from repro_torch.sharding.mesh import axis_size, divisible
from repro_torch.sharding.plan import ShardingPlan


def _entry(axes: tuple[str, ...]):
    """A spec entry for ``axes``: None, one name, or a tuple of names (as
    ``PartitionSpec`` writes them)."""
    if not axes:
        return None
    return axes[0] if len(axes) == 1 else tuple(axes)


def param_spec(cfg: ModelConfig, plan: Optional[ShardingPlan], name: str,
               shape: tuple[int, ...], mesh_shape: dict[str, int]) -> tuple:
    """The spec of the port's parameter ``name`` of ``shape`` (one layer's,
    for a block's tensor)."""
    if plan is None:
        return ()
    tp_ax = plan.model_axis
    fsdp = _entry(plan.fsdp_axes)
    fsdp_size = axis_size(plan.fsdp_axes, mesh_shape)
    ep_ax = plan.ep_axis
    h, kv = cfg.n_heads, cfg.n_kv_heads
    body = tuple(shape)
    path = ref_path(name)
    leaf, parent = path[-1], (path[-2] if len(path) >= 2 else "")

    def fs(dim: int):
        """fsdp axes if the dim divides, else None."""
        return fsdp if (fsdp and dim % fsdp_size == 0) else None

    def tp_if(n: int):
        return tp_ax if divisible(n, tp_ax, mesh_shape) else None

    if path[0] == "embed":
        return (tp_if(body[0]), fs(body[1]))
    if path[0] == "head":
        return (fs(body[0]), tp_if(body[1]))
    if "norm" in path[0] or "norm" in parent:
        return (None,) * len(body)
    # MoE banks [E, a, b]: EP on the expert dim when enabled, else FSDP on
    # the dense dim
    if parent == "mlp" and leaf in ("up", "gate", "down") and len(body) == 3:
        e_ax = ep_ax if divisible(body[0], ep_ax, mesh_shape) else None
        bank_fs = fs if e_ax is None else (lambda _: None)
        if leaf == "down":     # [E, f, d]
            return (e_ax, tp_if(body[1]), bank_fs(body[2]))
        return (e_ax, bank_fs(body[1]), tp_if(body[2]))
    if parent == "router":
        return (None,) * len(body)
    # dense and shared-expert MLPs {up,gate,down}.{w,b}
    if parent in ("up", "gate", "key"):
        if leaf == "b":
            return (tp_if(body[0]),)
        return (fs(body[0]), tp_if(body[1]))
    if parent in ("down", "value"):
        if leaf == "b":
            return (None,)
        return (tp_if(body[0]), fs(body[1]))
    # attention projections: head-aligned
    if parent == "q":
        if leaf == "b":
            return (tp_if(h),)
        return (fs(body[0]), tp_if(h))
    if parent in ("k", "v"):
        if leaf == "b":
            return (tp_if(kv),)
        return (fs(body[0]), tp_if(kv))
    if parent == "o":
        if leaf == "b":
            return (None,)
        return (tp_if(h), fs(body[1]))
    # MLA pieces: replicated over tp unless the head count divides
    if parent in ("q_down", "kv_down"):
        return (fs(body[0]), None)
    if parent in ("q_up", "kv_up"):
        return (None, tp_if(h))
    # mamba
    if parent == "in_proj":
        return (fs(body[0]), tp_if(body[1]))
    if parent == "out_proj":
        return (tp_if(body[0]), fs(body[1]))
    if parent == "bcdt_proj":
        return (tp_if(body[0]), None)
    if leaf == "conv_w":
        return (None, tp_if(body[1]))
    if leaf in ("conv_b", "dt_bias", "d_skip"):
        return (tp_if(body[0]),)
    if leaf == "a_log":
        return (tp_if(body[0]), None)
    # rwkv time-mix: the head count rarely divides, so only fsdp
    if parent in ("r", "g"):
        return (fs(body[0]), None)
    if leaf in ("w_lora_a", "w_lora_b", "u", "w0"):
        return (None,) * len(body)
    # default: fsdp on the first dim when possible, else replicated
    if len(body) >= 2:
        return (fs(body[0]),) + (None,) * (len(body) - 1)
    return (None,) * len(body)


def param_specs(cfg: ModelConfig, plan: Optional[ShardingPlan],
                shapes: dict[str, tuple[int, ...]],
                mesh_shape: dict[str, int]) -> dict[str, tuple]:
    """Spec of every parameter of ``shapes`` (port name -> shape; tensors
    do as well)."""
    return {name: param_spec(cfg, plan, name, tuple(s.shape) if
                             isinstance(s, torch.Tensor) else tuple(s),
                             mesh_shape)
            for name, s in shapes.items()}


def cache_spec(cfg: ModelConfig, plan: Optional[ShardingPlan], name: str,
               shape: tuple[int, ...], mesh_shape: dict[str, int]) -> tuple:
    """The spec of one layer's cache tensor ``name`` ("k", "c_kv", "ssm",
    ...) of global ``shape`` ([B, S, ...] for K/V and latents, [B, ...]
    for states)."""
    if plan is None:
        return ()
    batch, seq = _entry(plan.batch_axes), _entry(plan.seq_axes)
    tp_ax = plan.model_axis
    head_tp = cfg.mla is None and divisible(cfg.n_kv_heads, tp_ax, mesh_shape)
    body = tuple(shape)
    if name in ("k", "v", "ck", "cv") and head_tp and len(body) == 4:
        # head-TP cache [B, S, KV, hd], KV over the model axis: decode is
        # local to the head shard
        return (batch, None, tp_ax, None)
    seq_ok = seq is not None and len(body) >= 2 \
        and body[1] % axis_size(plan.seq_axes, mesh_shape) == 0
    # a window layer's ring stays batch-sharded: it is small and the ring
    # decode is local to the batch shard
    if cfg.sliding_window and len(body) >= 2 and body[1] <= cfg.sliding_window:
        seq_ok = False
    if name in ("k", "v", "c_kv", "k_rope", "ck", "cv"):
        return (batch, seq if seq_ok else None) + (None,) * (len(body) - 2)
    return (batch,) + (None,) * (len(body) - 1)


def cache_specs_tree(cfg: ModelConfig, plan: Optional[ShardingPlan], cache,
                     mesh_shape: dict[str, int]):
    """Specs of a decode cache: the same nested structure (a list of
    layers' dicts), each leaf's global shape (a tensor or a tuple) replaced
    by its spec."""
    def walk(node, name=""):
        if isinstance(node, dict):
            return {k: walk(v, k) for k, v in node.items()}
        if isinstance(node, list):
            return [walk(v) for v in node]
        if node is None:
            return None
        shape = tuple(node.shape) if isinstance(node, torch.Tensor) else tuple(node)
        return cache_spec(cfg, plan, name, shape, mesh_shape)
    return walk(cache)


def spec_axes(spec: tuple, axis_names) -> tuple[str, ...]:
    """The axes of ``axis_names`` (a mesh's, in its order) that ``spec``
    shards any dimension over."""
    named = set()
    for entry in spec:
        if entry is not None:
            named.update((entry,) if isinstance(entry, str) else entry)
    return tuple(a for a in axis_names if a in named)


def replicated_axes(spec: tuple, axis_names) -> tuple[str, ...]:
    """The axes of ``axis_names`` along which a tensor of ``spec`` is
    replicated: every one the spec does not name."""
    named = spec_axes(spec, axis_names)
    return tuple(a for a in axis_names if a not in named)


def shard_tensor(x: torch.Tensor, spec: tuple) -> torch.Tensor:
    """This rank's slice of the full tensor ``x`` under ``spec`` (of the
    current mesh), contiguous."""
    for dim, axes in enumerate(spec):
        if axes is not None:
            x = local_chunk(x, axes, dim)
    return x.contiguous()


def gather_tensor(x: torch.Tensor, spec: tuple) -> torch.Tensor:
    """The full tensor of which ``x`` is this rank's slice under ``spec``."""
    for dim, axes in reversed(list(enumerate(spec))):
        if axes is not None:
            x = all_gather(x, axes, dim)
    return x


def shard_tree(tree: dict, specs: dict) -> dict:
    """This rank's slice of each full tensor of ``tree`` (a flat dict),
    under the spec of the same key."""
    return {k: shard_tensor(v, specs[k]) for k, v in tree.items()}


def gather_tree(tree: dict, specs: dict) -> dict:
    """Inverse of ``shard_tree``: collective over the current mesh."""
    return {k: gather_tensor(v, specs[k]) for k, v in tree.items()}
