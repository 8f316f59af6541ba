"""Feed-forward blocks: gated (SwiGLU/GeGLU) and plain MLPs, plus the RWKV
channel mix (squared ReLU, token-shifted).  Port of ``repro/models/mlp.py``.

Under a plan the MLP is Megatron's: ``up`` and ``gate`` column-parallel
(this rank's hidden units), ``down`` row-parallel, reduced once; the
channel mix likewise, ``key`` column-parallel and ``value`` row-parallel."""
from __future__ import annotations

import torch
from torch import nn

from repro_torch.configs.base import ModelConfig
from repro_torch.models.common import (Dense, activation, apply_dense,
                                      apply_dense_rows)


class MLP(nn.Module):
    """Up, down and (gated) gate projections of ``hidden`` units (default
    ``cfg.d_ff``)."""

    def __init__(self, cfg: ModelConfig, generator: torch.Generator,
                 dtype=torch.float32, hidden: int | None = None):
        super().__init__()
        hidden = hidden or cfg.d_ff
        kw = dict(generator=generator, dtype=dtype)
        self.up = Dense(cfg.d_model, hidden, **kw)
        self.down = Dense(hidden, cfg.d_model, **kw)
        self.gate = Dense(cfg.d_model, hidden, **kw) if cfg.gated_mlp else None


def mlp_apply(cfg: ModelConfig, p: MLP, x: torch.Tensor, *, plan=None,
              seq_out: bool = False) -> torch.Tensor:
    """x [B, S, d] -> [B, S, d]; under ``plan`` the hidden units are this
    rank's and ``down``'s partial sums are reduced (``seq_out``: to this
    rank's sequence slice, for a sequence-parallel residual)."""
    up = apply_dense(p.up, x)
    if p.gate is not None:
        up = activation(cfg, apply_dense(p.gate, x)) * up
    else:
        up = activation(cfg, up)
    if plan is None:
        return apply_dense(p.down, up)
    return apply_dense_rows(p.down, up, plan, seq_out)


# ------------------------------------------------------------ rwkv channel mix

class ChannelMix(nn.Module):
    def __init__(self, cfg: ModelConfig, generator: torch.Generator,
                 dtype=torch.float32):
        super().__init__()
        kw = dict(generator=generator, dtype=dtype)
        self.key = Dense(cfg.d_model, cfg.d_ff, **kw)
        self.value = Dense(cfg.d_ff, cfg.d_model, **kw)
        self.mix_k = nn.Parameter(torch.full((cfg.d_model,), 0.5, dtype=dtype),
                                  requires_grad=False)


def channel_mix_apply(cfg: ModelConfig, p: ChannelMix, x: torch.Tensor,
                      shifted: torch.Tensor, *, plan=None,
                      seq_out: bool = False) -> torch.Tensor:
    """x, shifted: [B, S, d]; shifted = x delayed by one token.  Under
    ``plan`` as ``mlp_apply``: ``key``'s units are this rank's and
    ``value``'s partial sums are reduced (``seq_out``: to this rank's
    sequence slice)."""
    xk = x + (shifted - x) * p.mix_k
    k = torch.square(torch.relu(apply_dense(p.key, xk)))
    if plan is None:
        return apply_dense(p.value, k)
    return apply_dense_rows(p.value, k, plan, seq_out)


def token_shift(x: torch.Tensor) -> torch.Tensor:
    """[B, S, d] -> the previous token's features; position 0 sees zeros."""
    return torch.cat([torch.zeros_like(x[:, :1]), x[:, :-1]], dim=1)
