"""Shared model primitives: dense and norm modules, the RWKV group norm,
activations, RoPE and M-RoPE, sinusoidal positions, softcap.  Port of ``repro/models/common.py``.

Parameters keep the JAX package's layouts (a dense weight is [d_in, d_out]
and applies as ``x @ w``), so a converted JAX tree loads without transposes.

Under a sharding plan each rank holds its slice of a parameter
(``params.shard_params``), whose layout rides on the tensor as
``shard_spec`` (``sharded_axis`` reads it).  A column-parallel dense is
``apply_dense`` on the slice: its output holds this rank's columns.  A
row-parallel one (``apply_dense_rows``) multiplies this rank's rows and
finishes with ``reduce_rows``: a psum over the model axis, or with a
sequence-parallel residual a reduce-scatter along the sequence.  A weight
whose slice the plan's fsdp axes also cut (``fsdp_spec``, ZeRO-3) is
gathered over them before it is used, one block (or the embedding, or the
head) at a time (``gather_params``, ``unshard``); the all-gather's
gradient is the reduce-scatter that sums the data-parallel gradient into
this rank's slice.
"""
from __future__ import annotations

import math
from typing import Optional

import torch
from torch import nn

from repro_torch.configs.base import ModelConfig
from repro_torch.distributed.collectives import (all_gather, local_chunk,
                                                 psum, reduce_scatter)
from repro_torch.sharding.mesh import current_mesh
from repro_torch.sharding.specs import cache_spec


def randn(*shape: int, generator: Optional[torch.Generator]) -> torch.Tensor:
    """Standard normal draws of ``shape`` (f32) from ``generator``, on its
    device; with no generator (a build on ``meta``, ``init_params(...,
    device="meta")``) an empty meta tensor of that shape: nothing is
    drawn."""
    if generator is None:
        return torch.empty(shape, device="meta")
    return torch.randn(*shape, generator=generator, device=generator.device)


def rand(*shape: int, generator: Optional[torch.Generator]) -> torch.Tensor:
    """Uniform [0, 1) draws, or an empty meta tensor, as ``randn``."""
    if generator is None:
        return torch.empty(shape, device="meta")
    return torch.rand(*shape, generator=generator, device=generator.device)


class Dense(nn.Module):
    """``x @ w (+ b)`` with ``w`` [d_in, d_out]; normal init with std
    ``scale`` (default ``d_in ** -0.5``) drawn from ``generator`` (zero
    bias), or no draw on meta (``generator`` None)."""

    def __init__(self, d_in: int, d_out: int, *, bias: bool = False,
                 generator: Optional[torch.Generator] = None,
                 dtype=torch.float32, scale: Optional[float] = None):
        super().__init__()
        std = scale if scale is not None else d_in ** -0.5
        w = randn(d_in, d_out, generator=generator) * std
        self.w = nn.Parameter(w.to(dtype), requires_grad=False)
        self.b = nn.Parameter(torch.zeros(d_out, dtype=dtype),
                              requires_grad=False) if bias else None


class Norm(nn.Module):
    """RMSNorm or LayerNorm parameters (scale ones, bias zeros)."""

    def __init__(self, cfg: ModelConfig, dtype=torch.float32):
        super().__init__()
        self.scale = nn.Parameter(torch.ones(cfg.d_model, dtype=dtype),
                                  requires_grad=False)
        self.bias = nn.Parameter(torch.zeros(cfg.d_model, dtype=dtype),
                                 requires_grad=False) \
            if cfg.norm == "layernorm" else None


def apply_dense(p: Dense, x: torch.Tensor) -> torch.Tensor:
    y = x @ p.w
    if p.b is not None:
        y = y + p.b
    return y


def sharded_axis(t: torch.Tensor, dim: int):
    """The mesh axis along which dimension ``dim`` of parameter ``t`` holds
    only this rank's slice, or None (not sharded, or no plan).  A weight
    still cut by fsdp axes must be gathered first (``unshard``)."""
    if getattr(t, "fsdp_spec", None) is not None:
        raise RuntimeError("an fsdp-sharded weight is read before it was "
                           "gathered (models.common.unshard)")
    spec = getattr(t, "shard_spec", None)
    return spec[dim] if spec else None


def unshard(t: torch.Tensor) -> torch.Tensor:
    """``t`` with the dimensions its ``fsdp_spec`` names gathered over
    those axes (a differentiable all-gather), carrying the tensor-parallel
    spec that remains; ``t`` itself when no fsdp axis cuts it."""
    fsdp = getattr(t, "fsdp_spec", None)
    if fsdp is None:
        return t
    out = t
    for dim, axes in enumerate(fsdp):
        if axes is not None:
            out = all_gather(out, axes, dim)
    out.shard_spec = tuple(None if f is not None else s
                           for s, f in zip(t.shard_spec, fsdp))
    return out


class _Gathered:
    """A module's parameters as the model code reads them, with every
    fsdp-sharded one gathered (``full``: gathered tensors by dotted name
    under the root module); submodules come back wrapped in turn, other
    attributes as they are."""

    __slots__ = ("_module", "_full", "_prefix")

    def __init__(self, module: nn.Module, full: dict, prefix: str):
        self._module, self._full, self._prefix = module, full, prefix

    def __getattr__(self, name):
        key = self._prefix + name
        if key in self._full:
            return self._full[key]
        val = getattr(self._module, name)
        if isinstance(val, nn.Module):
            return _Gathered(val, self._full, key + ".")
        return val


def gather_params(module: nn.Module):
    """``module`` with its fsdp-sharded parameters gathered (in the order
    of ``named_parameters``, the same on every rank), or ``module`` itself
    when none is."""
    full = {n: unshard(p) for n, p in module.named_parameters()
            if getattr(p, "fsdp_spec", None) is not None}
    return _Gathered(module, full, "") if full else module


def reduce_rows(y: torch.Tensor, plan, partial: bool,
                seq_out: bool = False) -> torch.Tensor:
    """Finish a row-parallel product y [B, S, ...]: ``partial`` sums over
    the model axis are psummed, or with ``seq_out`` (a sequence-parallel
    residual) reduce-scattered along the sequence; a full ``y`` is kept,
    or its sequence slice taken."""
    ax = plan.model_axis if plan is not None else None
    if partial:
        return reduce_scatter(y, ax, 1) if seq_out else psum(y, ax)
    return local_chunk(y, ax, 1) if seq_out else y


def apply_dense_rows(p: Dense, x: torch.Tensor, plan,
                     seq_out: bool = False) -> torch.Tensor:
    """``x @ w (+ b)`` with x's last dim and w's rows this rank's slice
    when w is row-sharded: the partial product is reduced (``reduce_rows``)
    before the bias is added."""
    y = reduce_rows(x @ p.w, plan, sharded_axis(p.w, 0) is not None, seq_out)
    if p.b is not None:
        y = y + p.b
    return y


def cache_layout(cfg: ModelConfig, plan, entry: dict) -> dict:
    """A layer's new cache under ``specs.cache_spec``: each tensor cut to
    this rank's sequence slice where the spec shards it, the spec kept on
    the tensor as ``shard_spec``.  A recurrent state's spec shards only
    its batch, which is already this rank's rows."""
    mesh = current_mesh()
    if plan is None or mesh is None:
        return entry
    for name, t in entry.items():
        spec = cache_spec(cfg, plan, name, tuple(t.shape), mesh.shape)
        if spec[1] is not None:
            t = local_chunk(t, spec[1], 1)
        t.shard_spec = spec
        entry[name] = t
    return entry


def apply_norm(cfg: ModelConfig, p: Norm, x: torch.Tensor) -> torch.Tensor:
    """Norm in fp32, result in x's dtype."""
    xf = x.float()
    if cfg.norm == "rmsnorm":
        xf = xf * torch.rsqrt((xf * xf).mean(-1, keepdim=True) + cfg.norm_eps)
        return (xf * p.scale.float()).to(x.dtype)
    mean = xf.mean(-1, keepdim=True)
    var = ((xf - mean) ** 2).mean(-1, keepdim=True)
    xf = (xf - mean) * torch.rsqrt(var + cfg.norm_eps)
    return (xf * p.scale.float() + p.bias.float()).to(x.dtype)


def last_valid(x: torch.Tensor, kv_len: Optional[torch.Tensor]) -> torch.Tensor:
    """Row ``kv_len - 1`` (at least 0) of each sequence of the right-padded
    x [B, S, ...]; the last row when ``kv_len`` is None."""
    if kv_len is None:
        return x[:, -1]
    return x[torch.arange(x.shape[0], device=x.device), (kv_len - 1).clamp_min(0)]


def group_norm(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
               n_groups: int, eps: float = 1e-5) -> torch.Tensor:
    """GroupNorm over the last dim split into ``n_groups`` (the RWKV head
    norm); statistics in fp32, result in x's dtype."""
    *lead, d = x.shape
    xf = x.float().reshape(*lead, n_groups, d // n_groups)
    mean = xf.mean(-1, keepdim=True)
    var = ((xf - mean) ** 2).mean(-1, keepdim=True)
    xf = ((xf - mean) * torch.rsqrt(var + eps)).reshape(*lead, d)
    return (xf * scale.float() + bias.float()).to(x.dtype)


def activation(cfg: ModelConfig, x: torch.Tensor) -> torch.Tensor:
    if cfg.act == "gelu":
        return nn.functional.gelu(x, approximate="tanh")
    return nn.functional.silu(x)


def rope_freqs(head_dim: int, theta: float, device=None) -> torch.Tensor:
    exps = torch.arange(0, head_dim, 2, dtype=torch.float32, device=device) / head_dim
    return 1.0 / (theta ** exps)


def apply_rope(x: torch.Tensor, pos: torch.Tensor, theta: float) -> torch.Tensor:
    """Half-split RoPE.  x: [..., S, H, D]; pos: broadcastable to [..., S]
    absolute positions; angles in fp32."""
    d = x.shape[-1]
    freqs = rope_freqs(d, theta, device=x.device)            # [D/2]
    angles = pos[..., None].float() * freqs                  # [..., S, D/2]
    cos = torch.cos(angles)[..., None, :]                    # [..., S, 1, D/2]
    sin = torch.sin(angles)[..., None, :]
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


def apply_mrope(x: torch.Tensor, pos3: torch.Tensor, theta: float,
                sections: tuple[int, int, int]) -> torch.Tensor:
    """Qwen2-VL multimodal RoPE.  x: [B, S, H, D]; pos3: [3, B, S] (t, h,
    w).  The D/2 rotary frequency channels are split into ``sections``
    groups, each rotated by its own position stream; angles in fp32."""
    d = x.shape[-1]
    if sum(sections) != d // 2:
        raise ValueError(f"M-RoPE sections {sections} do not cover "
                         f"head_dim {d} // 2")
    freqs = rope_freqs(d, theta, device=x.device)               # [D/2]
    stream = [i for i, n in enumerate(sections) for _ in range(n)]
    pos_sel = pos3[stream]                                      # [D/2, B, S]
    angles = pos_sel.permute(1, 2, 0).float() * freqs           # [B, S, D/2]
    cos = torch.cos(angles)[..., None, :]                       # [B, S, 1, D/2]
    sin = torch.sin(angles)[..., None, :]
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


def sinusoidal_positions(pos: torch.Tensor, d_model: int) -> torch.Tensor:
    """Whisper-style sinusoidal embeddings [..., S, d_model] (f32) of the
    positions ``pos`` [..., S]: sin then cos of pos * exp(-ln(1e4) * i /
    (half - 1)), i < half, as the reference's formula (not HF Whisper's)."""
    half = d_model // 2
    freqs = torch.exp(-math.log(10000.0)
                      * torch.arange(half, dtype=torch.float32, device=pos.device)
                      / max(half - 1, 1))
    ang = pos[..., None].float() * freqs
    return torch.cat([torch.sin(ang), torch.cos(ang)], dim=-1)


def softcap(x: torch.Tensor, cap: Optional[float]) -> torch.Tensor:
    if cap is None:
        return x
    return cap * torch.tanh(x / cap)
