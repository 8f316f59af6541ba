"""RWKV-6 ("Finch") time-mix block: token shift, data-dependent decay via a
low-rank projection, the WKV recurrence (prefill through the ``wkv6``
kernel, decode through the ``wkv6_step`` torch op), grouped head norm and a
SiLU output gate.  Port of ``repro/models/rwkv.py``, with the reference's
parameter names and its simplification (static token-shift mixes, the
decay lora kept).

Decode cache of one layer: {"shift" [B, d], "state" [B, H, hs, hs]} (the
block adds the channel mix's "cm_shift").

Under a sharding plan the time mix is head-parallel where the reference's
specs shard ``k`` and ``v`` by their columns (heads) and ``o`` by its rows
over the model axis: each rank cuts its heads' columns of the replicated
``r``, ``g`` and decay lora and its rows of ``u`` and the head norm, runs
the WKV recurrence (the ``wkv6`` kernel at prefill) and the norm on its
heads, and ``o``'s partial products are reduced.  The cache keeps the
reference's layout, whole heads on every rank: a rank reads its heads'
slice of the state and its new slice is all-gathered over the model
axis.  Without a model axis (a batch-only plan) the block runs whole on
this rank's rows.
"""
from __future__ import annotations

import torch
from torch import nn

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels.wkv6 import wkv6, wkv6_step
from repro_torch.distributed.collectives import all_gather, local_chunk
from repro_torch.models.common import (Dense, apply_dense_rows, group_norm,
                                      last_valid, randn, sharded_axis)
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
        self.w_lora_a = param((randn(d, rc.decay_lora, generator=generator)
                               * d ** -0.5).to(dtype))
        self.w_lora_b = param(torch.zeros(rc.decay_lora, d, dtype=dtype))
        self.u = param(randn(h, rc.head_size, generator=generator) * 0.3)
        for name in ("mix_r", "mix_k", "mix_v", "mix_w", "mix_g"):
            setattr(self, name, param(torch.full((d,), 0.5, dtype=dtype)))
        self.ln_scale = param(torch.ones(d, dtype=dtype))
        self.ln_bias = param(torch.zeros(d, dtype=dtype))


def _mix(x, shifted, m):
    return x + (shifted - x) * m


def _project(cfg: ModelConfig, p: RWKV, x: torch.Tensor,
             shifted: torch.Tensor, ax=None):
    """r, k, v [..., H, hs], the decay w [..., H, hs] f32 and the gate g,
    of this rank's heads when ``ax`` cuts them."""
    hs = cfg.rwkv.head_size
    r = _mix(x, shifted, p.mix_r) @ local_chunk(p.r.w, ax, 1)
    k = _mix(x, shifted, p.mix_k) @ p.k.w
    v = _mix(x, shifted, p.mix_v) @ p.v.w
    g = _mix(x, shifted, p.mix_g) @ local_chunk(p.g.w, ax, 1)
    xw = _mix(x, shifted, p.mix_w)
    # data-dependent decay, in the reference's order of operations (the
    # kernel then takes log(clip(w)), as the reference's op does)
    dlog = local_chunk(p.w0, ax, 0) + (torch.tanh(xw @ p.w_lora_a)
                                        @ local_chunk(p.w_lora_b, ax, 1)).float()
    w = torch.exp(-torch.exp(dlog))
    shp = (*x.shape[:-1], r.shape[-1] // hs, hs)
    return r.reshape(shp), k.reshape(shp), v.reshape(shp), w.reshape(shp), g


def _output(p: RWKV, out: torch.Tensor, g: torch.Tensor, ax, plan,
            seq_out: bool = False) -> torch.Tensor:
    """Head norm of out [..., H, hs] (this rank's heads), gated by g, then
    ``o`` (row-parallel under ``plan``)."""
    h = out.shape[-2]
    out = group_norm(out.flatten(-2), local_chunk(p.ln_scale, ax, 0),
                     local_chunk(p.ln_bias, ax, 0), h)
    return apply_dense_rows(p.o, out * nn.functional.silu(g), plan, seq_out)


def rwkv_prefill(cfg: ModelConfig, p: RWKV, x: torch.Tensor, *,
                 cache_len: int = 0, kv_len=None, plan=None,
                 seq_out: bool = False):
    """x: [B, T, d] -> (y, cache or None).  The recurrence runs over every
    position of the right-padded rows, as in the reference; only the
    token-shift entries honour ``kv_len``.  Under ``plan`` x is this
    rank's rows, the whole sequence, and ``seq_out`` reduce-scatters y to
    this rank's sequence slice (module docstring)."""
    ax = sharded_axis(p.k.w, 1)         # this rank's heads, or None: all
    r, k, v, w, g = _project(cfg, p, x, token_shift(x), ax)
    out, state = wkv6(r, k, v, w, local_chunk(p.u, ax, 0))
    y = _output(p, out, g, ax, plan, seq_out)
    cache = {"shift": last_valid(x, kv_len),
             "state": all_gather(state, ax, 1)} if cache_len else None
    return y, cache


def rwkv_decode(cfg: ModelConfig, p: RWKV, x: torch.Tensor, cache: dict, *,
                plan=None):
    """x: [B, 1, d]; cache {"shift" [B, d], "state" [B, H, hs, hs]}."""
    ax = sharded_axis(p.k.w, 1)         # this rank's heads, or None: all
    xt = x[:, 0]
    r, k, v, w, g = _project(cfg, p, xt, cache["shift"], ax)
    out, state = wkv6_step(r, k, v, w, local_chunk(p.u, ax, 0),
                           local_chunk(cache["state"], ax, 1))
    y = _output(p, out, g, ax, plan)
    return y[:, None], {"shift": xt, "state": all_gather(state, ax, 1)}
