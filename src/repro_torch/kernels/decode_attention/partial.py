"""Partial-softmax decode attention and its merge: the primitives of the
sequence-sharded (flash-decoding) decode.  Port of
``decode_attention_partial`` and ``combine_partials`` of
``repro/kernels/decode_attention/xla.py``, which the reference runs in XLA,
outside any Pallas kernel; so they are torch ops here, on every device.

Each shard of a KV cache gives (acc, m, l): the unnormalised output, the
largest score and the sum of exp(score - m) over its valid rows.  A shard
with no valid row gives m = NEG_INF (finite) and l = 0, so a merge weighs
it exp(NEG_INF - m_max) = 0 and never sees a NaN.  ``combine_partials``
merges over a mesh axis (or tuple of axes) of the current mesh, or over a
stacked dimension.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.distributed.collectives import pmax, psum
from repro_torch.sharding.mesh import Axes

NEG_INF = -1e30


def decode_attention_partial(
    q: torch.Tensor,            # [B, H, D]
    k: torch.Tensor,            # [B, S_loc, KV, D]
    v: torch.Tensor,            # [B, S_loc, KV, Dv]
    kv_len: torch.Tensor,       # [B] valid rows *within this shard*
    *,
    softcap: Optional[float] = None,
    window: Optional[int] = None,
    window_lo: Optional[torch.Tensor] = None,  # [B] absolute low cutoff
    pos_offset: int | torch.Tensor = 0,        # absolute position of row 0
    scale: Optional[float] = None,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Returns (acc [B, H, Dv] unnormalised f32, m [B, H], l [B, H])."""
    b, h, d = q.shape
    _, s, kv, dv = v.shape
    group = h // kv
    scale = scale if scale is not None else d ** -0.5
    # K/V stay in their storage dtype, products accumulate in f32
    qg = (q.float() * scale).to(k.dtype).reshape(b, kv, group, d)
    logits = torch.einsum("bkgd,bskd->bkgs", qg, k).float()
    if softcap is not None:
        logits = softcap * torch.tanh(logits / softcap)
    pos = torch.arange(s, device=q.device)[None, :]
    kl = kv_len.to(q.device)[:, None]
    mask = pos < kl
    if window_lo is not None:
        mask &= (pos + pos_offset) >= window_lo.to(q.device)[:, None]
    elif window is not None:
        mask &= pos > kl - 1 - window
    mask = mask[:, None, None, :]
    logits = logits.masked_fill(~mask, NEG_INF)
    m = logits.amax(dim=-1)
    p = torch.exp(logits - m[..., None]).masked_fill(~mask, 0.0)
    l = p.sum(dim=-1)
    acc = torch.einsum("bkgs,bskd->bkgd", p.to(v.dtype), v).float()
    return acc.reshape(b, h, dv), m.reshape(b, h), l.reshape(b, h)


def combine_partials(acc: torch.Tensor, m: torch.Tensor, l: torch.Tensor, *,
                     axis_name: Axes = None,
                     stack_dim: Optional[int] = None) -> torch.Tensor:
    """Merge flash-decoding partials, across ``axis_name`` of the current
    mesh or across the stacked dimension ``stack_dim``; returns the
    normalised output (f32)."""
    if axis_name is not None:
        m_max = pmax(m, axis_name)
        w = torch.exp(m - m_max)
        num = psum(acc * w[..., None], axis_name)
        den = psum(l * w, axis_name)
    else:
        if stack_dim is None:
            raise ValueError("combine_partials: give axis_name or stack_dim")
        m_max = m.amax(dim=stack_dim, keepdim=True)
        w = torch.exp(m - m_max)
        num = (acc * w[..., None]).sum(dim=stack_dim)
        den = (l * w).sum(dim=stack_dim)
    return num / den.clamp_min(1e-30)[..., None]
