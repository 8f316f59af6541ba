"""RWKV-6 ("Finch") time-mix block: token shift, data-dependent decay via a
low-rank projection, the WKV recurrence (prefill through the ``wkv6``
kernel, decode through the ``wkv6_step`` torch op), grouped head norm and a
SiLU output gate.  Port of ``repro/models/rwkv.py``, with the reference's
parameter names and its simplification (static token-shift mixes, the
decay lora kept).

Decode cache of one layer: {"shift" [B, d], "state" [B, H, hs, hs]} (the
block adds the channel mix's "cm_shift").
"""
from __future__ import annotations

import torch
from torch import nn

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels.wkv6 import wkv6, wkv6_step
from repro_torch.models.common import Dense, group_norm, last_valid
from repro_torch.models.mlp import token_shift


class RWKV(nn.Module):
    def __init__(self, cfg: ModelConfig, generator: torch.Generator,
                 dtype=torch.float32):
        super().__init__()
        rc = cfg.rwkv
        d = cfg.d_model
        h = d // rc.head_size
        kw = dict(generator=generator, dtype=dtype)

        def param(x):
            return nn.Parameter(x, requires_grad=False)

        self.r = Dense(d, d, **kw)
        self.k = Dense(d, d, **kw)
        self.v = Dense(d, d, **kw)
        self.g = Dense(d, d, **kw)
        self.o = Dense(d, d, **kw)
        # base log-decay: w = exp(-exp(w0 + tanh(x A) B))
        self.w0 = param(torch.full((d,), -5.0))
        self.w_lora_a = param((torch.randn(d, rc.decay_lora, generator=generator,
                                           device=generator.device)
                               * d ** -0.5).to(dtype))
        self.w_lora_b = param(torch.zeros(rc.decay_lora, d, dtype=dtype))
        self.u = param(torch.randn(h, rc.head_size, generator=generator,
                                     device=generator.device) * 0.3)
        for name in ("mix_r", "mix_k", "mix_v", "mix_w", "mix_g"):
            setattr(self, name, param(torch.full((d,), 0.5, dtype=dtype)))
        self.ln_scale = param(torch.ones(d, dtype=dtype))
        self.ln_bias = param(torch.zeros(d, dtype=dtype))


def _mix(x, shifted, m):
    return x + (shifted - x) * m


def _project(cfg: ModelConfig, p: RWKV, x: torch.Tensor,
             shifted: torch.Tensor):
    """r, k, v [..., H, hs], the decay w [..., H, hs] f32 and the gate g."""
    hs = cfg.rwkv.head_size
    shp = (*x.shape[:-1], cfg.d_model // hs, hs)
    r = _mix(x, shifted, p.mix_r) @ p.r.w
    k = _mix(x, shifted, p.mix_k) @ p.k.w
    v = _mix(x, shifted, p.mix_v) @ p.v.w
    g = _mix(x, shifted, p.mix_g) @ p.g.w
    xw = _mix(x, shifted, p.mix_w)
    # data-dependent decay, in the reference's order of operations (the
    # kernel then takes log(clip(w)), as the reference's op does)
    dlog = p.w0 + (torch.tanh(xw @ p.w_lora_a) @ p.w_lora_b).float()
    w = torch.exp(-torch.exp(dlog))
    return r.reshape(shp), k.reshape(shp), v.reshape(shp), w.reshape(shp), g


def rwkv_prefill(cfg: ModelConfig, p: RWKV, x: torch.Tensor, *,
                 cache_len: int = 0, kv_len=None):
    """x: [B, T, d] -> (y, cache or None).  The recurrence runs over every
    position of the right-padded rows, as in the reference; only the
    token-shift entries honour ``kv_len``."""
    b, t, d = x.shape
    h = d // cfg.rwkv.head_size
    r, k, v, w, g = _project(cfg, p, x, token_shift(x))
    out, state = wkv6(r, k, v, w, p.u)
    out = group_norm(out.reshape(b, t, d), p.ln_scale, p.ln_bias, h)
    y = (out * nn.functional.silu(g)) @ p.o.w
    cache = {"shift": last_valid(x, kv_len), "state": state} if cache_len \
        else None
    return y, cache


def rwkv_decode(cfg: ModelConfig, p: RWKV, x: torch.Tensor, cache: dict):
    """x: [B, 1, d]; cache {"shift" [B, d], "state" [B, H, hs, hs]}."""
    b, _, d = x.shape
    h = d // cfg.rwkv.head_size
    xt = x[:, 0]
    r, k, v, w, g = _project(cfg, p, xt, cache["shift"])
    out, state = wkv6_step(r, k, v, w, p.u, cache["state"])
    out = group_norm(out.reshape(b, d), p.ln_scale, p.ln_bias, h)
    y = (out * nn.functional.silu(g)) @ p.o.w
    return y[:, None], {"shift": xt, "state": state}
