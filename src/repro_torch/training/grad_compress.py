"""Gradient compression, single-device pieces.  Port of
``repro/training/grad_compress.py``: int8 quantization (per-tensor absmax
scale) and top-k sparsification with its error-feedback residual.  The
data-parallel mean over compressed gradients (``dp_mean_compressed``)
needs a process group and comes with the multi-device slice.
"""
from __future__ import annotations

import torch


def quantize_int8(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    scale = x.abs().max().clamp_min(1e-12) / 127.0
    q = torch.clamp(torch.round(x / scale), -127, 127).to(torch.int8)
    return q, scale


def dequantize_int8(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return q.float() * scale


def topk_sparsify(g: torch.Tensor, frac: float = 0.01):
    """Keep the top-|frac| entries by magnitude (flat); returns ((values,
    indices, shape) for transport, the error-feedback residual)."""
    flat = g.reshape(-1)
    k = max(1, int(flat.shape[0] * frac))
    idx = torch.topk(flat.abs(), k).indices
    kept = flat[idx]
    residual = flat.clone()
    residual[idx] = 0.0
    return (kept, idx, tuple(g.shape)), residual.reshape(g.shape)


def topk_densify(payload, dtype=torch.float32) -> torch.Tensor:
    kept, idx, shape = payload
    n = 1
    for s in shape:
        n *= s
    out = torch.zeros((n,), dtype=dtype, device=kept.device)
    out[idx] = kept.to(dtype)
    return out.reshape(shape)
