"""GQA attention with prefill and decode paths.  Port of
``repro/models/attention.py``, plain-GQA contiguous-cache branches only.

Prefill runs the flash-attention kernel; decode writes the new token's K/V
into the cache in place and runs the flash-decoding kernel.  The sliding
window ring cache, MLA, prefix continuation and sharded branches raise
``NotImplementedError`` until their slices land.
"""
from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from repro_torch.configs.base import LayerSpec, ModelConfig
from repro_torch.kernels.decode_attention import decode_attention
from repro_torch.kernels.flash_attention import flash_attention
from repro_torch.models.common import Dense, apply_dense, apply_rope


class Attention(nn.Module):
    def __init__(self, cfg: ModelConfig, generator: torch.Generator,
                 dtype=torch.float32):
        super().__init__()
        d, h, kv, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim_eff
        kw = dict(generator=generator, dtype=dtype)
        self.q = Dense(d, h * hd, bias=cfg.qkv_bias, **kw)
        self.k = Dense(d, kv * hd, bias=cfg.qkv_bias, **kw)
        self.v = Dense(d, kv * cfg.v_head_dim_eff, bias=cfg.qkv_bias, **kw)
        self.o = Dense(h * cfg.v_head_dim_eff, d, **kw)


def _check_supported(cfg: ModelConfig, spec: LayerSpec, plan) -> None:
    if spec.attn == "window" and cfg.sliding_window:
        raise NotImplementedError(
            "sliding-window attention (ring cache) is not ported yet")
    if cfg.rope == "mrope":
        raise NotImplementedError("M-RoPE is not ported yet")
    if plan is not None:
        raise NotImplementedError("sharded attention plans are not ported yet")


def _qkv(cfg: ModelConfig, p: Attention, x: torch.Tensor,
         positions: torch.Tensor):
    """Project + rope.  x: [B, S, d] -> q [B,S,H,hd], k [B,S,KV,hd], v."""
    b, s, _ = x.shape
    h, kv, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim_eff
    q = apply_dense(p.q, x).reshape(b, s, h, hd)
    k = apply_dense(p.k, x).reshape(b, s, kv, hd)
    v = apply_dense(p.v, x).reshape(b, s, kv, cfg.v_head_dim_eff)
    if cfg.rope == "rope":
        q = apply_rope(q, positions, cfg.rope_theta)
        k = apply_rope(k, positions, cfg.rope_theta)
    return q, k, v


def _pad_seq(x: torch.Tensor, target: int) -> torch.Tensor:
    s = x.shape[1]
    if s == target:
        return x
    if s > target:
        return x[:, s - target:].contiguous()     # keep the most recent entries
    pad = x.new_zeros((x.shape[0], target - s) + tuple(x.shape[2:]))
    return torch.cat([x, pad], dim=1)


def attn_prefill(cfg: ModelConfig, spec: LayerSpec, p: Attention,
                 x: torch.Tensor, *, positions: torch.Tensor, plan=None,
                 causal: bool = True, cache_len: int = 0,
                 kv_len: Optional[torch.Tensor] = None,
                 prefix: Optional[dict] = None):
    """Full-sequence attention.  Returns (y, cache entry or None);
    ``cache_len`` > 0 allocates a cache {"k", "v"} [B, cache_len, KV, hd].
    Right-padded rows attend causally like every other row (no length
    mask): their outputs are never read."""
    if prefix is not None:
        raise NotImplementedError(
            "prefix-continuation prefill is not ported yet (paged-engine slice)")
    _check_supported(cfg, spec, plan)
    q, k, v = _qkv(cfg, p, x, positions)
    b, s = q.shape[:2]
    out = flash_attention(q, k, v, causal=causal, softcap=cfg.attn_softcap)
    y = apply_dense(p.o, out.reshape(b, s, -1))
    cache = None
    if cache_len:
        cache = {"k": _pad_seq(k, cache_len), "v": _pad_seq(v, cache_len)}
    return y, cache


def _write_slot(buf: torch.Tensor, new: torch.Tensor,
                idx: torch.Tensor) -> None:
    """buf [B, S, ...][b, idx[b]] <- new [B, ...], in place.  An index past
    the last slot writes the last slot, as the reference's clamped
    ``dynamic_update_slice`` does."""
    rows = torch.arange(buf.shape[0], device=buf.device)
    buf[rows, idx.clamp(0, buf.shape[1] - 1)] = new


def attn_decode(cfg: ModelConfig, spec: LayerSpec, p: Attention,
                x: torch.Tensor, cache: dict, kv_len: torch.Tensor, *,
                plan=None):
    """One-token decode.  x: [B, 1, d]; cache entry from attn_prefill;
    kv_len: [B] int32 current lengths (the new token's position).  The
    cache is updated in place — the reference returns a new array, here the
    write saves a copy of the whole cache per layer and step.  Returns
    (y, cache)."""
    _check_supported(cfg, spec, plan)
    b = x.shape[0]
    q, k, v = _qkv(cfg, p, x, kv_len[:, None])
    _write_slot(cache["k"], k[:, 0], kv_len)
    _write_slot(cache["v"], v[:, 0], kv_len)
    out = decode_attention(q[:, 0], cache["k"], cache["v"], kv_len + 1,
                           softcap=cfg.attn_softcap)
    y = apply_dense(p.o, out.reshape(b, -1))
    return y.reshape(b, 1, -1), cache
