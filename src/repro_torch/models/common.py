"""Shared model primitives: dense and norm modules, activations, RoPE,
softcap.  Port of ``repro/models/common.py``.

Parameters keep the JAX package's layouts (a dense weight is [d_in, d_out]
and applies as ``x @ w``), so a converted JAX tree loads without transposes.
"""
from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from repro_torch.configs.base import ModelConfig


class Dense(nn.Module):
    """``x @ w (+ b)`` with ``w`` [d_in, d_out]; normal init with std
    ``d_in ** -0.5`` drawn from ``generator`` (zero bias)."""

    def __init__(self, d_in: int, d_out: int, *, bias: bool = False,
                 generator: Optional[torch.Generator] = None,
                 dtype=torch.float32):
        super().__init__()
        w = torch.randn(d_in, d_out, generator=generator) * d_in ** -0.5
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


def softcap(x: torch.Tensor, cap: Optional[float]) -> torch.Tensor:
    if cap is None:
        return x
    return cap * torch.tanh(x / cap)
