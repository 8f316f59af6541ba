"""Plain PyTorch version of decode attention: one query token per sequence
against a KV cache with per-sequence valid lengths, optional window and
tanh softcap, softmax in fp32 with -1e30 for masked scores.  Mirrors
``repro/kernels/decode_attention/ref.py``, except that a row with no valid
key (``kv_len`` 0) is 0, as in the reference's serving backends
(``decode_attention_xla`` and the Pallas kernel) and the CUDA kernels, not
the mean of V: the CPU path and the kernel's yardstick on the card."""
from __future__ import annotations

from typing import Optional

import torch

NEG_INF = -1e30


def decode_attention_reference(
    q: torch.Tensor,            # [B, H, D]  (one new token)
    k: torch.Tensor,            # [B, S, KV, D]  cache (possibly overallocated)
    v: torch.Tensor,            # [B, S, KV, Dv]
    kv_len: torch.Tensor,       # [B] int — number of valid cache entries
    *,
    softcap: Optional[float] = None,
    window: Optional[int] = None,
    scale: Optional[float] = None,
) -> torch.Tensor:
    b, h, d = q.shape
    _, s, kv, dv = v.shape
    group = h // kv
    scale = scale if scale is not None else d ** -0.5
    kf = k.float().repeat_interleave(group, dim=2)
    vf = v.float().repeat_interleave(group, dim=2)
    logits = torch.einsum("bhd,bshd->bhs", q.float() * scale, kf)
    if softcap is not None:
        logits = softcap * torch.tanh(logits / softcap)
    pos = torch.arange(s, device=q.device)[None, :]
    kv_len = kv_len.to(q.device)[:, None]
    mask = pos < kv_len
    if window is not None:
        mask &= pos > kv_len - 1 - window   # query sits at kv_len
    logits = logits.masked_fill(~mask[:, None, :], NEG_INF)
    probs = torch.exp(logits - logits.amax(dim=-1, keepdim=True))
    probs = probs.masked_fill(~mask[:, None, :], 0.0)
    probs = probs / probs.sum(dim=-1, keepdim=True).clamp_min(1e-30)
    out = torch.einsum("bhs,bshd->bhd", probs, vf)
    return out.to(q.dtype)
