"""Plain PyTorch version of flash attention: multi-head attention with GQA,
causal/sliding-window masking and tanh softcap, softmax in fp32 with -1e30
for masked scores.  Mirrors ``repro/kernels/flash_attention/ref.py``.
O(Sq*Skv) memory: the CPU path and the kernel's yardstick on the card."""
from __future__ import annotations

from typing import Optional

import torch

NEG_INF = -1e30


def attention_mask(sq: int, skv: int, *, causal: bool, window: Optional[int],
                   q_offset: int, device=None) -> torch.Tensor:
    """[sq, skv] boolean mask, True = attend.  Query i sits at absolute
    position q_offset + i; keys at 0..skv-1."""
    q_pos = q_offset + torch.arange(sq, device=device)[:, None]
    k_pos = torch.arange(skv, device=device)[None, :]
    mask = torch.ones((sq, skv), dtype=torch.bool, device=device)
    if causal:
        mask &= k_pos <= q_pos
    if window is not None:
        mask &= k_pos > q_pos - window
    return mask


def flash_attention_reference(
    q: torch.Tensor,            # [B, Sq, H, D]
    k: torch.Tensor,            # [B, Skv, KV, D]
    v: torch.Tensor,            # [B, Skv, KV, Dv]
    *,
    causal: bool = True,
    window: Optional[int] = None,
    softcap: Optional[float] = None,
    q_offset: int = 0,
    scale: Optional[float] = None,
) -> torch.Tensor:
    b, sq, h, d = q.shape
    _, skv, kv, dv = v.shape
    group = h // kv
    scale = scale if scale is not None else d ** -0.5
    qf = q.float() * scale
    kf = k.float().repeat_interleave(group, dim=2)
    vf = v.float().repeat_interleave(group, dim=2)
    logits = torch.einsum("bqhd,bkhd->bhqk", qf, kf)
    if softcap is not None:
        logits = softcap * torch.tanh(logits / softcap)
    mask = attention_mask(sq, skv, causal=causal, window=window,
                          q_offset=q_offset, device=q.device)
    logits = logits.masked_fill(~mask[None, None], NEG_INF)
    probs = torch.exp(logits - logits.amax(dim=-1, keepdim=True))
    probs = probs / probs.sum(dim=-1, keepdim=True)
    out = torch.einsum("bhqk,bkhd->bqhd", probs, vf)
    return out.to(q.dtype)
