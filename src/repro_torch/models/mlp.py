"""Feed-forward block: gated (SwiGLU/GeGLU) or plain MLP.  Port of
``repro/models/mlp.py`` (the RWKV channel mix comes with its slice)."""
from __future__ import annotations

import torch
from torch import nn

from repro_torch.configs.base import ModelConfig
from repro_torch.models.common import Dense, activation, apply_dense


class MLP(nn.Module):
    def __init__(self, cfg: ModelConfig, generator: torch.Generator,
                 dtype=torch.float32):
        super().__init__()
        kw = dict(generator=generator, dtype=dtype)
        self.up = Dense(cfg.d_model, cfg.d_ff, **kw)
        self.down = Dense(cfg.d_ff, cfg.d_model, **kw)
        self.gate = Dense(cfg.d_model, cfg.d_ff, **kw) if cfg.gated_mlp else None


def mlp_apply(cfg: ModelConfig, p: MLP, x: torch.Tensor) -> torch.Tensor:
    up = apply_dense(p.up, x)
    if p.gate is not None:
        up = activation(cfg, apply_dense(p.gate, x)) * up
    else:
        up = activation(cfg, up)
    return apply_dense(p.down, up)
