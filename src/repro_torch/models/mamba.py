"""Mamba (S6 selective-state-space) mixer of the Jamba hybrid.  Port of
``repro/models/mamba.py``, with the reference's parameter names and its
simplification: dt is a scalar a position, broadcast over the channels
through a learned per-channel bias (a rank-1 dt projection).

The prefill scans in chunks of ``chunk`` positions, as the reference's
``lax.scan`` over chunks does, so the f32 [B, chunk, d_in, N] transients
stay bounded; inside a chunk the recurrence h_t = abar_t h_{t-1} + bx_t
runs as a step loop of one in-place multiply-add a position (the
reference runs an ``associative_scan``: the same recurrence, summed in
another order).  The reference's scan is not a Pallas kernel, so this is
torch ops.  The recurrence runs over the right padding of a padded batch
(the state is the one at the padded end); only the conv tail honours
``kv_len``, as in the reference.  Decode is the exact one-step
recurrence.

Decode cache of one layer: {"conv" [B, d_conv - 1, d_in] (the
activations' dtype), "ssm" [B, d_in, N] f32}.

Under a sharding plan the mixer is channel-parallel where the reference's
specs cut ``d_in`` over the model axis (``conv_w``, ``conv_b``,
``dt_bias``, ``a_log``, ``d_skip``, and the rows of ``bcdt_proj`` and
``out_proj``): each rank convolves and scans its slice of the channels.
``in_proj`` is column-sharded contiguously over [x | z], so a rank's
columns are not its channels' x and z (on model = 2, rank 0 holds all of
x and rank 1 all of z): the projection's columns are all-gathered over
the model axis and each rank takes its channels of x and z.  B, C and dt
come from a product over the channels, psummed.  ``out_proj``'s partial
products are reduced.  The cache keeps the reference's layout, whole
channels on every rank: the conv tail comes from the gathered x, and a
rank reads its channels' slice of the ssm state and its new slice is
all-gathered.
"""
from __future__ import annotations

import math

import torch
from torch import nn
from torch.nn import functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.distributed.collectives import (all_gather, local_chunk,
                                                 psum)
from repro_torch.models.common import (Dense, apply_dense_rows, rand, randn,
                                      sharded_axis)


class Mamba(nn.Module):
    """``in_proj.w`` [d, 2 d_in], ``conv_w`` [d_conv, d_in] and ``conv_b``,
    ``bcdt_proj.w`` [d_in, 2N + 1], ``out_proj.w`` [d_in, d] in ``dtype``;
    ``dt_bias`` [d_in], ``a_log`` [d_in, N] and ``d_skip`` [d_in] in f32
    whatever ``dtype`` is, as the reference keeps them."""

    def __init__(self, cfg: ModelConfig, generator: torch.Generator,
                 dtype=torch.float32):
        super().__init__()
        mc = cfg.mamba
        d, d_in, n = cfg.d_model, mc.expand * cfg.d_model, mc.d_state
        g = generator
        kw = dict(generator=g, dtype=dtype)

        def param(x):
            return nn.Parameter(x, requires_grad=False)

        self.in_proj = Dense(d, 2 * d_in, **kw)
        self.conv_w = param((randn(mc.d_conv, d_in, generator=g)
                             * mc.d_conv ** -0.5).to(dtype))
        self.conv_b = param(torch.zeros(d_in, dtype=dtype))
        self.bcdt_proj = Dense(d_in, 2 * n + 1, **kw)
        # dt = softplus(. + dt_bias) starts in [1e-3, 1e-1], log-uniform
        u = rand(d_in, generator=g) \
            * (math.log(1e-1) - math.log(1e-3)) + math.log(1e-3)
        self.dt_bias = param(torch.log(torch.expm1(torch.exp(u))))
        self.a_log = param(torch.log(torch.arange(1, n + 1, dtype=torch.float32)
                                     ).expand(d_in, n).contiguous())
        self.d_skip = param(torch.ones(d_in))
        self.out_proj = Dense(d_in, d, **kw)


def _selective_inputs(p: Mamba, x: torch.Tensor, n: int):
    """x: conv'd activations [..., d_in] -> (dt [..., d_in], B [..., N], C
    [..., N]), all f32.  Under a plan x and dt are this rank's channels,
    and B and C the same on every rank."""
    bcdt = psum(x @ p.bcdt_proj.w, sharded_axis(p.bcdt_proj.w, 0))
    b_ssm, c_ssm, dt_s = bcdt.split([n, n, 1], dim=-1)
    dt = F.softplus(dt_s.float() + p.dt_bias)
    return dt, b_ssm.float(), c_ssm.float()


def _in_proj(p: Mamba, x_in: torch.Tensor):
    """x_in [..., d] -> (x of all channels, x and z of this rank's
    channels), each [..., d_in] unsharded (module docstring)."""
    xz = all_gather(x_in @ p.in_proj.w, sharded_axis(p.in_proj.w, 1), -1)
    x_all, z = xz.chunk(2, dim=-1)
    ax = sharded_axis(p.conv_w, 1)
    return x_all, local_chunk(x_all, ax, -1), local_chunk(z, ax, -1)


def _causal_conv(p: Mamba, x: torch.Tensor) -> torch.Tensor:
    """x [B, T, d_in]: depthwise causal conv + SiLU, in f32, back in x's
    dtype."""
    dc, t = p.conv_w.shape[0], x.shape[1]
    xp = F.pad(x, (0, 0, dc - 1, 0))
    w = p.conv_w.float()
    y = sum(xp[:, i:i + t].float() * w[i] for i in range(dc))
    return F.silu(y + p.conv_b.float()).to(x.dtype)


def selective_scan(x: torch.Tensor, dt: torch.Tensor, a: torch.Tensor,
                   b_ssm: torch.Tensor, c_ssm: torch.Tensor, chunk: int):
    """The S6 recurrence h_t = exp(dt_t a) h_{t-1} + (dt_t x_t) B_t from
    h_0 = 0, y_t = h_t C_t, in f32.  x, dt [B, T, d_in]; a [d_in, N];
    b_ssm, c_ssm [B, T, N].  Returns (y [B, T, d_in], the final state h_T
    [B, d_in, N]).  Each chunk of ``chunk`` positions holds its [chunk, B,
    d_in, N] decays and states, position-major so that a step is one
    contiguous multiply-add.  Under autograd (grad enabled and an input
    that requires it) the states are built out of place, a step at a time,
    with the same products and sums."""
    bsz, t, d_in = x.shape
    grad = torch.is_grad_enabled() and any(
        v.requires_grad for v in (x, dt, a, b_ssm, c_ssm))
    h = torch.zeros(bsz, d_in, a.shape[1], dtype=torch.float32, device=x.device)
    ys = []
    for t0 in range(0, t, chunk):
        dtb, xb, bb, cb = (v[:, t0:t0 + chunk].transpose(0, 1).contiguous()
                           for v in (dt, x, b_ssm, c_ssm))  # [c, B, ...]
        abar = (dtb[..., None] * a).exp_()                    # [c, B, d_in, N]
        # the states start as bx_t and are accumulated in place
        hs = (dtb * xb)[..., None] * bb[:, :, None, :]
        if grad:
            steps = []
            for i in range(hs.shape[0]):
                h = hs[i] + abar[i] * h
                steps.append(h)
            hs = torch.stack(steps)
        else:
            hs[0].addcmul_(abar[0], h)
            for i in range(1, hs.shape[0]):
                hs[i].addcmul_(abar[i], hs[i - 1])
            h = hs[-1].clone()
        ys.append(torch.einsum("cbdn,cbn->cbd", hs, cb).transpose(0, 1))
        del abar, hs
    return torch.cat(ys, dim=1), h


def mamba_prefill(cfg: ModelConfig, p: Mamba, x_in: torch.Tensor, *,
                  cache_len: int = 0, chunk: int = 256, kv_len=None,
                  plan=None, seq_out: bool = False):
    """x_in: [B, T, d] -> (y [B, T, d], cache or None).  The state runs
    over every position of the right-padded rows, as in the reference;
    the conv tail is each row's last d_conv - 1 valid inputs (index 0
    repeated where the row is shorter) when ``kv_len`` is given.  Under
    ``plan`` x_in is this rank's rows, the whole sequence, and
    ``seq_out`` reduce-scatters y to this rank's sequence slice."""
    mc = cfg.mamba
    n = mc.d_state
    x_all, x_raw, z = _in_proj(p, x_in)
    x = _causal_conv(p, x_raw)
    dt, b_ssm, c_ssm = _selective_inputs(p, x, n)
    a = -torch.exp(p.a_log)
    xf = x.float()
    y, h_fin = selective_scan(xf, dt, a, b_ssm, c_ssm, min(chunk, x.shape[1]))
    y = y + xf * p.d_skip
    y = y.to(x_in.dtype) * F.silu(z)
    out = apply_dense_rows(p.out_proj, y, plan, seq_out)

    cache = None
    if cache_len:
        dc = mc.d_conv
        if kv_len is not None:
            idx = (kv_len[:, None].long() - (dc - 1)
                   + torch.arange(dc - 1, device=x_all.device)).clamp_min(0)
            tail = x_all[torch.arange(x_all.shape[0], device=x_all.device)[:, None],
                         idx]
        else:
            tail = x_all[:, -(dc - 1):]
        cache = {"conv": tail.contiguous(),
                 "ssm": all_gather(h_fin, sharded_axis(p.conv_w, 1), 1)}
    return out, cache


def mamba_decode(cfg: ModelConfig, p: Mamba, x_in: torch.Tensor, cache: dict,
                 *, plan=None):
    """x_in: [B, 1, d]; cache {"conv" [B, dc - 1, d_in], "ssm" [B, d_in,
    N]}.  Returns (y [B, 1, d], the new cache)."""
    n = cfg.mamba.d_state
    ax = sharded_axis(p.conv_w, 1)
    x_all, _, z = _in_proj(p, x_in[:, 0])
    window = torch.cat([cache["conv"], x_all[:, None]], dim=1)
    xc = torch.einsum("bcd,cd->bd", local_chunk(window, ax, 2).float(),
                      p.conv_w.float()) + p.conv_b.float()
    x = F.silu(xc).to(x_in.dtype)
    dt, b_ssm, c_ssm = _selective_inputs(p, x, n)           # [B,d_in],[B,N]x2
    a = -torch.exp(p.a_log)
    abar = torch.exp(dt[..., None] * a)                      # [B, d_in, N]
    bx = (dt * x.float())[..., None] * b_ssm[:, None, :]
    h = abar * local_chunk(cache["ssm"], ax, 1) + bx
    y = torch.einsum("bdn,bn->bd", h, c_ssm)
    y = y + x.float() * p.d_skip
    y = y.to(x_in.dtype) * F.silu(z)
    out = apply_dense_rows(p.out_proj, y, plan)
    return out[:, None], {"conv": window[:, 1:], "ssm": all_gather(h, ax, 1)}
