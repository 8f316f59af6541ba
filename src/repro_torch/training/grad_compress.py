"""Gradient compression.  Port of ``repro/training/grad_compress.py``:
int8 quantization (per-tensor absmax scale), the data-parallel mean over
int8-compressed gradients (``dp_mean_compressed``, over an axis of the
current mesh), and top-k sparsification with its error-feedback residual.
"""
from __future__ import annotations

import torch

from repro_torch.distributed.collectives import pmax, psum
from repro_torch.sharding.mesh import Axes, axis_size


def quantize_int8(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    scale = x.abs().max().clamp_min(1e-12) / 127.0
    q = torch.clamp(torch.round(x / scale), -127, 127).to(torch.int8)
    return q, scale


def dequantize_int8(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return q.float() * scale


@torch.no_grad()
def dp_mean_compressed(grads: dict, axis: Axes) -> dict:
    """The mean of each gradient over the ranks of ``axis``, sent as int8:
    each rank quantizes its gradient (its own absmax scale), the int8
    payloads are psummed as int32, and the sum is dequantized with the
    largest of the ranks' scales (pmax) and divided by their number.  The
    reference's body under ``shard_map``, with the gradients replicated
    over the other axes."""
    n = axis_size(axis)

    def one(g):
        q, s = quantize_int8(g.float())
        total = psum(q.to(torch.int32), axis)
        s_max = pmax(s, axis)
        return (total.float() * s_max / n).to(g.dtype)

    return {k: one(g) for k, g in grads.items()}


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
