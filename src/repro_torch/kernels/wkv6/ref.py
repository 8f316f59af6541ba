"""Plain PyTorch versions of the RWKV-6 WKV recurrence.  Per head, with
key-dim i and value-dim j:

    out_t[j] = sum_i r_t[i] * (S_{t-1}[i,j] + u[i] * k_t[i] * v_t[j])
    S_t[i,j] = w_t[i] * S_{t-1}[i,j] + k_t[i] * v_t[j]

``wkv6_chunked`` is the chunk schedule of ``repro/kernels/wkv6/xla.py``
(the pairwise log-space decay, every exponent <= 0; the exclusive
cumulative decay taken directly rather than as cw - lw): the CPU path of the
``wkv6`` op and the kernel's yardstick on the card.  ``wkv6_sequential``
is the oracle of ``repro/kernels/wkv6/ref.py`` (tests only), ``wkv6_step``
the decode step of ``xla.py``.
"""
from __future__ import annotations

from typing import Optional

import torch


def _state0(b, h, d, dv, s0, device):
    if s0 is None:
        return torch.zeros((b, h, d, dv), dtype=torch.float32, device=device)
    return s0.float()


def wkv6_sequential(r, k, v, w, u, s0: Optional[torch.Tensor] = None):
    """r, k, w [B, T, H, D]; v [B, T, H, Dv]; u [H, D]; s0 [B, H, D, Dv].
    Returns (out [B, T, H, Dv] in r's dtype, final state f32)."""
    b, t, h, d = r.shape
    rf, kf, vf, wf = (x.float() for x in (r, k, v, w))
    uf = u.float()
    s = _state0(b, h, d, v.shape[-1], s0, r.device)
    outs = []
    for i in range(t):
        kv = kf[:, i, :, :, None] * vf[:, i, :, None, :]          # [B,H,D,Dv]
        outs.append(torch.einsum("bhd,bhdv->bhv", rf[:, i],
                                 s + uf[None, :, :, None] * kv))
        s = wf[:, i, :, :, None] * s + kv
    return torch.stack(outs, 1).to(r.dtype), s


def _chunk_body(u, s, r, k, v, lw):
    """s: [B,H,D,Dv]; r/k/lw: [B,C,H,D], v: [B,C,H,Dv] (f32)."""
    c = r.shape[1]
    cw = torch.cumsum(lw, dim=1)                   # inclusive cumulative log decay
    # exclusive (up to t-1): the inclusive sum shifted by one, as the kernel
    # takes it.  The reference's cw - lw cancels when |cw| >> |lw| and
    # doubles this version's error against a float64 oracle at T = 1024.
    cwx = torch.cat([torch.zeros_like(cw[:, :1]), cw[:, :-1]], dim=1)
    # inter-chunk: decayed query against the carried state
    out = torch.einsum("bchd,bhdv->bchv", r * torch.exp(cwx), s)
    # intra-chunk: pairwise decay tensor [B, C, C, H, D], exponents <= 0
    dec = torch.exp(cwx[:, :, None] - cw[:, None, :])
    mask = (torch.arange(c, device=r.device)[:, None]
            > torch.arange(c, device=r.device)[None, :])[None, :, :, None, None]
    dec = torch.where(mask, dec, 0.0)
    a = torch.einsum("bthd,btshd,bshd->bths", r, dec, k)
    out = out + torch.einsum("bths,bshv->bthv", a, v)
    # current-token bonus
    diag = torch.einsum("bthd,hd,bthd->bth", r, u, k)
    out = out + diag[..., None] * v
    # state update
    decay_all = torch.exp(cw[:, -1])               # [B,H,D]
    k_dec = k * torch.exp(cw[:, -1:] - cw)
    s_new = decay_all[..., None] * s + torch.einsum("bchd,bchv->bhdv", k_dec, v)
    return s_new, out


def wkv6_chunked(r, k, v, w, u, s0: Optional[torch.Tensor] = None, *,
                 chunk: int = 32):
    """The chunked recurrence over chunks of ``min(chunk, T)`` positions,
    T padded up to a multiple with r = k = v = 0 and log w = 0 (no
    contribution, state unchanged).  Same arguments and results as
    ``wkv6_sequential``."""
    b, t, h, d = r.shape
    dv = v.shape[-1]
    rf, kf, vf = (x.float() for x in (r, k, v))
    lw = torch.log(torch.clip(w.float(), 1e-12, 1.0))
    uf = u.float()
    s = _state0(b, h, d, dv, s0, r.device)
    c = min(chunk, t)
    t_p = -(-t // c) * c
    if t_p != t:
        pad = (0, 0, 0, 0, 0, t_p - t)
        rf, kf, vf, lw = (torch.nn.functional.pad(x, pad)
                          for x in (rf, kf, vf, lw))
    outs = []
    for c0 in range(0, t_p, c):
        blk = (x[:, c0:c0 + c] for x in (rf, kf, vf, lw))
        s, out = _chunk_body(uf, s, *blk)
        outs.append(out)
    return torch.cat(outs, 1)[:, :t].to(r.dtype), s


def wkv6_step(r, k, v, w, u, s):
    """Single decode step.  r/k/w: [B,H,D], v: [B,H,Dv], s: [B,H,D,Dv]."""
    rf, kf, vf, wf = (x.float() for x in (r, k, v, w))
    kv = kf[..., :, None] * vf[..., None, :]
    out = torch.einsum("bhd,bhdv->bhv", rf,
                       s + u.float()[None, :, :, None] * kv)
    s_new = wf[..., :, None] * s + kv
    return out.to(r.dtype), s_new
