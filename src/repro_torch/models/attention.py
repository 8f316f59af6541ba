"""GQA attention with prefill, decode and paged-decode paths.  Port of
``repro/models/attention.py``, plain-GQA branches only.

Prefill (and its prefix-continuation form) runs the flash-attention kernel;
decode writes the new token's K/V into the contiguous cache in place and
runs the flash-decoding kernel; paged decode and the speculative verify
window write into one layer's block pool in place and run the paged
attention kernel.  The sliding window ring cache, MLA and sharded branches
raise ``NotImplementedError`` until their slices land.
"""
from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from repro_torch.configs.base import LayerSpec, ModelConfig
from repro_torch.kernels.decode_attention import decode_attention
from repro_torch.kernels.flash_attention import flash_attention
from repro_torch.kernels.paged_attention import (paged_decode_attention,
                                                 paged_window_attention)
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
    mask): their outputs are never read.

    ``prefix`` ({"k": [B, P, KV, hd], "v": [B, P, KV, dv]}) switches to
    continuation prefill: x holds only the uncached suffix (``positions``
    already offset by P), and the queries attend over the prefix K/V
    concatenated with the suffix's, causal at absolute positions through
    the kernel's ``q_offset``.  The returned cache covers the suffix only."""
    _check_supported(cfg, spec, plan)
    q, k, v = _qkv(cfg, p, x, positions)
    b, s = q.shape[:2]
    if prefix is not None:
        out = flash_attention(q, torch.cat([prefix["k"].to(k.dtype), k], dim=1),
                              torch.cat([prefix["v"].to(v.dtype), v], dim=1),
                              causal=causal, softcap=cfg.attn_softcap,
                              q_offset=prefix["k"].shape[1])
    else:
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


def attn_paged_decode(cfg: ModelConfig, spec: LayerSpec, p: Attention,
                      x: torch.Tensor, pool: dict, block_tables: torch.Tensor,
                      kv_len: torch.Tensor, *, plan=None):
    """One-token decode against one layer's paged pool {"k": [N, bs, KV, hd],
    "v": [N, bs, KV, dv]}.  x: [B, 1, d]; block_tables [B, nb] int32 (rows
    padded with a valid null block); kv_len [B] int32 current lengths.  The
    new token's K/V is written into slot ``kv_len`` of its sequence's table
    in place — the reference returns a new pool — then attention reads
    through the table.  Returns (y, pool)."""
    _check_supported(cfg, spec, plan)
    b = x.shape[0]
    q, k, v = _qkv(cfg, p, x, kv_len[:, None])
    bs = pool["k"].shape[1]
    rows = torch.arange(b, device=x.device)
    blk = block_tables[rows, (kv_len // bs).long()].long()
    off = (kv_len % bs).long()
    pool["k"][blk, off] = k[:, 0]
    pool["v"][blk, off] = v[:, 0]
    out = paged_decode_attention(q[:, 0], pool["k"], pool["v"], block_tables,
                                 kv_len + 1, softcap=cfg.attn_softcap)
    y = apply_dense(p.o, out.reshape(b, -1))
    return y.reshape(b, 1, -1), pool


def attn_paged_spec(cfg: ModelConfig, spec: LayerSpec, p: Attention,
                    x: torch.Tensor, pool: dict, block_tables: torch.Tensor,
                    kv_len: torch.Tensor, blk: torch.Tensor, off: torch.Tensor,
                    *, plan=None):
    """Multi-token decode (speculative verification) against a paged pool.
    x: [B, T, d] — the current input token plus T-1 drafts per sequence;
    kv_len [B] history length before the window; blk/off [B, T] the
    engine's scatter targets for each window position's K/V (the null block
    where a position is invalid).  All T positions' K/V are written in one
    in-place scatter, then attention reads through the table, causal within
    the window.  Returns (y [B, T, d], pool)."""
    _check_supported(cfg, spec, plan)
    b, t, _ = x.shape
    positions = kv_len[:, None] + torch.arange(t, device=x.device)[None, :]
    q, k, v = _qkv(cfg, p, x, positions)
    blk, off = blk.long(), off.long()
    pool["k"][blk, off] = k
    pool["v"][blk, off] = v
    out = paged_window_attention(q, pool["k"], pool["v"], block_tables, kv_len,
                                 softcap=cfg.attn_softcap)
    return apply_dense(p.o, out.reshape(b, t, -1)), pool
