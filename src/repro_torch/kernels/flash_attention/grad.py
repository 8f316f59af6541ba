"""The gradient of flash attention, in PyTorch ops.

The reference trains on its default ``"xla"`` backend, so its attention
gradient is XLA's autodiff of the blocked attention
(``repro/kernels/flash_attention/xla.py``), outside any Pallas kernel: no
TPU kernel has a backward kernel.  Here the backward of the card's K2
forward is written in torch ops the same way, from the saved q, k, v and
output o, in chunks of query rows so that the [B, KV, group, chunk, keys]
scores bound its memory:

    s = scale * q k^T (f32), s_c = c * tanh(s / c) under a softcap,
    masked scores -1e30, P = softmax(s_c), dP = dO v^T,
    delta = rowsum(dO * O), dS = P * (dP - delta) * (1 - (s_c / c)^2),
    dQ = scale * dS k, dK = scale * dS^T q, dV = P^T dO,

dK and dV summed over the query heads of each KV head.  A chunk reads only
the keys one of its rows may see (causal and window limits), unless a row
of the chunk sees none: the plain version's softmax then spreads it evenly
over every key, and so does this one.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels.flash_attention.ref import NEG_INF, attention_mask

# f32 elements of one chunk's [B, KV, group, rows, keys] scores
CHUNK_ELEMENTS = 1 << 26


def _key_range(rows: range, skv: int, *, causal: bool, window: Optional[int],
               q_offset: int) -> tuple[int, int, bool]:
    """(lo, hi, blind): the keys [lo, hi) the query rows ``rows`` may see,
    and whether one of them sees none.  The last row sees the fewest (a
    causal row before the last key sees itself), so ``blind`` is its test;
    a blind chunk reads every key."""
    first, last = q_offset + rows.start, q_offset + rows.stop - 1
    hi = min(skv, last + 1) if causal else skv
    if window is None:
        return 0, hi, hi <= 0
    if hi <= max(0, last - window + 1):
        return 0, skv, True
    return max(0, first - window + 1), hi, False


def flash_attention_grad(
    q: torch.Tensor,            # [B, Sq, H, D]
    k: torch.Tensor,            # [B, Skv, KV, D]
    v: torch.Tensor,            # [B, Skv, KV, Dv]
    o: torch.Tensor,            # [B, Sq, H, Dv] the forward's output
    do: torch.Tensor,           # [B, Sq, H, Dv] the output's gradient
    *,
    causal: bool = True,
    window: Optional[int] = None,
    softcap: Optional[float] = None,
    q_offset: int = 0,
    scale: Optional[float] = None,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(dq, dk, dv) of flash attention at (q, k, v), in f32 inside and the
    inputs' dtypes out."""
    b, sq, h, d = q.shape
    _, skv, kv, dv = v.shape
    g = h // kv
    scale = scale if scale is not None else d ** -0.5
    kf, vf = k.float(), v.float()
    dq = torch.empty((b, sq, h, d), dtype=torch.float32, device=q.device)
    dk = torch.zeros((b, skv, kv, d), dtype=torch.float32, device=q.device)
    dvf = torch.zeros((b, skv, kv, dv), dtype=torch.float32, device=q.device)
    chunk = max(1, min(sq, CHUNK_ELEMENTS // max(1, b * h * skv)))
    for c0 in range(0, sq, chunk):
        rows = range(c0, min(sq, c0 + chunk))
        lo, hi, blind = _key_range(rows, skv, causal=causal, window=window,
                                   q_offset=q_offset)
        if blind:
            lo, hi = 0, skv
        n = len(rows)
        qc = q[:, rows.start:rows.stop].float().reshape(b, n, kv, g, d)
        doc = do[:, rows.start:rows.stop].float().reshape(b, n, kv, g, dv)
        oc = o[:, rows.start:rows.stop].float().reshape(b, n, kv, g, dv)
        kc, vc = kf[:, lo:hi], vf[:, lo:hi]
        s = torch.einsum("bqngd,bknd->bngqk", qc * scale, kc)
        if softcap is not None:
            s = softcap * torch.tanh(s / softcap)
        mask = attention_mask(n, skv, causal=causal, window=window,
                              q_offset=q_offset + rows.start,
                              device=q.device)[:, lo:hi]
        p = s.masked_fill(~mask, NEG_INF)
        p = torch.exp(p - p.amax(dim=-1, keepdim=True))
        p = p / p.sum(dim=-1, keepdim=True)
        delta = (doc * oc).sum(-1).permute(0, 2, 3, 1)[..., None]  # [b,n,g,q,1]
        ds = p * (torch.einsum("bqngv,bknv->bngqk", doc, vc) - delta)
        if softcap is not None:
            ds = ds * (1.0 - (s / softcap) ** 2)
        if blind:       # a masked score is a constant: no gradient
            ds = ds.masked_fill(~mask, 0.0)
        dq[:, rows.start:rows.stop] = (scale * torch.einsum(
            "bngqk,bknd->bqngd", ds, kc)).reshape(b, n, h, d)
        dk[:, lo:hi] += scale * torch.einsum("bngqk,bqngd->bknd", ds, qc)
        dvf[:, lo:hi] += torch.einsum("bngqk,bqngv->bknv", p, doc)
    return dq.to(q.dtype), dk.to(k.dtype), dvf.to(v.dtype)
