"""GQA attention (with sliding-window layers) and MLA (MiniCPM3-style
latent attention), with prefill, decode and paged-decode paths.  Port of
``repro/models/attention.py``, single-device branches.

Prefill (and its prefix-continuation form) runs the flash-attention kernel;
decode writes the new token's K/V into the contiguous cache in place and
runs the flash-decoding kernel; paged decode and the speculative verify
window write into one layer's block pool in place and run the paged
attention kernel.  A window layer whose window is shorter than the cache
keeps a ring of ``window`` slots (slot = position % window) and decodes
over it through the flash-decoding kernel as well (``attn_decode``).  An
MLA layer caches the compressed latent and the rope key, expands them for
the prefill's flash attention and decodes in the latent space with torch
ops (``_mla_decode_absorbed``), as the reference does outside any Pallas
kernel.  M-RoPE layers rotate q and k by three position streams; a decode
path's single positions are broadcast to the three.  An encoder-decoder's
cross-attention runs the flash-attention kernel non-causally over the
projected encoder memory at prefill and keeps that memory's K/V as its
cache; each decode step runs the flash-decoding kernel over all of it.

Under a sharding plan (per-rank tensors, ``repro_torch.sharding``), chosen
per call as the reference's ``_run_flash`` chooses:

* prefill: head-TP when the KV heads divide the model axis (``_head_spec``;
  q, k, v column-parallel, the kernel on this rank's heads, ``o``
  row-parallel); otherwise sequence-parallel when the sequence divides the
  model axis (``_seq_parallel_prefill``: this rank's S/n query rows, all
  heads, over all S keys at ``q_offset`` = its index x S/n), else the
  kernel on all heads.  Where q is head-sharded but K/V are not, q's heads
  are gathered first; the output's sequence is gathered back and ``o``
  takes this rank's heads.  MLA follows its query heads.
* decode: head-TP is local to the head shard (the decode kernel on this
  rank's heads); a cache sequence-sharded over ``plan.seq_axes`` decodes
  flash-decoding style (``_sharded_decode``: each shard's partial
  softmax, merged with a pmax and two psums), its new K/V written by the
  one rank whose slot range holds the position; otherwise the kernel on
  all heads of a replicated cache.  An MLA latent cache that is
  sequence-sharded is gathered for the step and decoded on this rank's
  heads.
* caches take ``specs.cache_spec``'s layout, which rides on each cache
  tensor as ``shard_spec``.
* cross-attention is head-parallel as self-attention is: K2 over the
  memory and K3 over its cache on this rank's heads (the cache [B, F, KV,
  hd] head-sharded); a cache whose F rows ``cache_spec`` shards over the
  sequence axes raises at decode.
* paged decode and verify, batch-only plans alone: every rank holds the
  whole block pool (it has no batch dimension, so the reference's GSPMD
  keeps one copy on each device).  This rank's rows run q/k/v and
  attention; their new K/V are all-gathered over the batch axes and every
  row is written into every rank's pool, so the pools stay equal.  A
  batch the axes do not divide runs whole on every rank.
Prefix continuation and paged decode under model or sequence axes raise,
as in the reference.
"""
from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from repro_torch.configs.base import LayerSpec, ModelConfig
from repro_torch.distributed.collectives import (all_gather, axis_index,
                                                 local_chunk)
from repro_torch.kernels.decode_attention import (
    combine_partials, decode_attention, decode_attention_partial)
from repro_torch.kernels.flash_attention import flash_attention
from repro_torch.kernels.paged_attention import (paged_decode_attention,
                                                 paged_window_attention)
from repro_torch.models.common import (Dense, apply_dense, apply_dense_rows,
                                      apply_mrope, apply_rope, cache_layout,
                                      sharded_axis, softcap)
from repro_torch.sharding.mesh import axis_size, divisible
from repro_torch.sharding.plan import ShardingPlan, splits_batch


class Attention(nn.Module):
    def __init__(self, cfg: ModelConfig, generator: torch.Generator,
                 dtype=torch.float32):
        super().__init__()
        d, h, kv, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim_eff
        kw = dict(generator=generator, dtype=dtype)
        if cfg.mla is not None:
            m = cfg.mla
            self.q_down = Dense(d, m.q_lora_rank, **kw)
            self.q_up = Dense(m.q_lora_rank, h * m.qk_head_dim, **kw)
            self.kv_down = Dense(d, m.kv_lora_rank + m.qk_rope_head_dim, **kw)
            self.kv_up = Dense(m.kv_lora_rank,
                               h * (m.qk_nope_head_dim + m.v_head_dim), **kw)
            self.o = Dense(h * m.v_head_dim, d, **kw)
            return
        self.q = Dense(d, h * hd, bias=cfg.qkv_bias, **kw)
        self.k = Dense(d, kv * hd, bias=cfg.qkv_bias, **kw)
        self.v = Dense(d, kv * cfg.v_head_dim_eff, bias=cfg.qkv_bias, **kw)
        self.o = Dense(h * cfg.v_head_dim_eff, d, **kw)


def _model_sharded(plan) -> bool:
    return plan is not None and (plan.model_axis is not None
                                 or bool(plan.seq_axes))


def _check_paged(cfg: ModelConfig, spec: LayerSpec, plan) -> None:
    """The paged paths' gates, as the reference's (the serving runtime
    checks ``api.paged_compatible`` first)."""
    if cfg.mla is not None:
        raise NotImplementedError("paged decode: MLA uses the latent cache")
    if spec.attn == "window" and cfg.sliding_window:
        raise NotImplementedError("paged decode: window layers use ring cache")
    if _model_sharded(plan):
        raise NotImplementedError(
            "paged decode: model/seq-sharded plans are not supported yet")


def _paged_rows(plan, block_tables: torch.Tensor, kv_len: torch.Tensor):
    """(split, this rank's block_tables and kv_len) of a paged step whose
    inputs are the whole batch's: its rows under a batch-only plan whose
    axes divide them (``splits_batch``), else all of them."""
    split = splits_batch(plan, kv_len.shape[0])
    if split:
        return (split, local_chunk(block_tables, plan.batch_axes, 0),
                local_chunk(kv_len, plan.batch_axes, 0))
    return split, block_tables, kv_len


def _paged_write(pool: dict, k: torch.Tensor, v: torch.Tensor,
                 blk: torch.Tensor, off: torch.Tensor, plan,
                 split: bool) -> None:
    """pool[blk, off] <- the new K/V, in place; blk/off [B, ...] are the
    whole batch's targets.  When the rows were split, this rank's K and V
    ([B/n, ..., KV, hd] each) are first gathered over the batch axes in one
    collective, so every rank writes every row and the pools stay equal on
    all ranks (a sequence reads blocks that another rank's rows wrote once
    the prefix cache shares them)."""
    if split:
        kv = all_gather(torch.cat([k, v], dim=-1), plan.batch_axes, 0)
        k, v = kv.split([k.shape[-1], v.shape[-1]], dim=-1)
    pool["k"][blk, off] = k
    pool["v"][blk, off] = v


def _qkv(cfg: ModelConfig, p: Attention, x: torch.Tensor,
         positions: torch.Tensor):
    """Project + rope.  x: [B, S, d] -> q [B,S,H,hd], k [B,S,KV,hd], v
    (this rank's heads of each head-sharded projection).  positions [B, S],
    or for M-RoPE [3, B, S] (a [B, S] one is broadcast to the three
    streams, as every decode path's is)."""
    b, s, _ = x.shape
    hd = cfg.head_dim_eff
    q = apply_dense(p.q, x).reshape(b, s, -1, hd)
    k = apply_dense(p.k, x).reshape(b, s, -1, hd)
    v = apply_dense(p.v, x).reshape(b, s, -1, cfg.v_head_dim_eff)
    if cfg.rope == "rope":
        q = apply_rope(q, positions, cfg.rope_theta)
        k = apply_rope(k, positions, cfg.rope_theta)
    elif cfg.rope == "mrope":
        pos3 = positions if positions.dim() == 3 else \
            positions.expand(3, *positions.shape)
        q = apply_mrope(q, pos3, cfg.rope_theta, cfg.mrope_sections)
        k = apply_mrope(k, pos3, cfg.rope_theta, cfg.mrope_sections)
    return q, k, v


def _mla_qkv(cfg: ModelConfig, p: Attention, x: torch.Tensor,
             positions: torch.Tensor):
    """MLA projections.  Returns (q [B,S,H,dn+dr], latent c_kv [B,S,r],
    k_rope [B,S,dr])."""
    m = cfg.mla
    b, s, _ = x.shape
    q = apply_dense(p.q_up, apply_dense(p.q_down, x))
    q_nope, q_rope = q.reshape(b, s, -1, m.qk_head_dim).split(
        [m.qk_nope_head_dim, m.qk_rope_head_dim], dim=-1)
    q = torch.cat([q_nope, apply_rope(q_rope, positions, cfg.rope_theta)], dim=-1)
    c_kv, k_rope = apply_dense(p.kv_down, x).split(
        [m.kv_lora_rank, m.qk_rope_head_dim], dim=-1)
    k_rope = apply_rope(k_rope[:, :, None, :], positions, cfg.rope_theta)[:, :, 0]
    return q, c_kv.contiguous(), k_rope


def _mla_expand(cfg: ModelConfig, p: Attention, c_kv: torch.Tensor,
                k_rope: torch.Tensor):
    """Latent -> full K [B,S,H,dn+dr], V [B,S,H,dv].  c_kv [B,S,r],
    k_rope [B,S,dr] (one rope key shared by every head)."""
    m = cfg.mla
    b, s, _ = c_kv.shape
    k_nope, v = apply_dense(p.kv_up, c_kv).reshape(
        b, s, -1, m.qk_nope_head_dim + m.v_head_dim).split(
        [m.qk_nope_head_dim, m.v_head_dim], dim=-1)
    h = k_nope.shape[2]
    k = torch.cat([k_nope, k_rope[:, :, None, :].expand(
        b, s, h, m.qk_rope_head_dim)], dim=-1)
    return k, v.contiguous()


def _pad_seq(x: torch.Tensor, target: int) -> torch.Tensor:
    s = x.shape[1]
    if s == target:
        return x
    if s > target:
        return x[:, s - target:].contiguous()     # keep the most recent entries
    pad = x.new_zeros((x.shape[0], target - s) + tuple(x.shape[2:]))
    return torch.cat([x, pad], dim=1)


def _head_spec(plan: Optional[ShardingPlan], n: int):
    """The model axis when ``n`` heads divide it (head-TP), else None."""
    if plan is None or plan.model_axis is None:
        return None
    return plan.model_axis if divisible(n, plan.model_axis) else None


def _all_heads(w: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    """t [..., heads, D] of a projection with weight w: all heads, gathered
    over the model axis when w's columns (heads) are sharded."""
    ax = sharded_axis(w, 1)
    return all_gather(t, ax, t.dim() - 2) if ax is not None else t


def _o_proj(cfg: ModelConfig, p: Attention, out: torch.Tensor, plan,
            seq_out: bool = False) -> torch.Tensor:
    """out [B, S, heads, dv] -> [B, S, d].  Under a plan ``o`` is
    row-parallel when its rows (heads) are sharded: an all-heads ``out``
    is cut to this rank's heads, and the product reduced
    (``common.reduce_rows``)."""
    b, s = out.shape[:2]
    if plan is None:
        return apply_dense(p.o, out.reshape(b, s, -1))
    ax = sharded_axis(p.o.w, 0)
    if ax is not None and out.shape[2] == cfg.n_heads:
        out = local_chunk(out, ax, 2)
    return apply_dense_rows(p.o, out.reshape(b, s, -1), plan, seq_out)


def _seq_parallel_prefill(plan: ShardingPlan, q, k, v, *, causal, window,
                          softcap) -> torch.Tensor:
    """Context-parallel flash attention: this rank's S/n query rows (all
    heads) over all S keys, causal at their absolute positions through the
    kernel's ``q_offset``.  Returns [B, S/n, H, dv]."""
    ax = plan.model_axis
    s_loc = q.shape[1] // axis_size(ax)
    return flash_attention(local_chunk(q, ax, 1), k, v, causal=causal,
                           window=window, softcap=softcap,
                           q_offset=axis_index(ax) * s_loc)


def _run_flash(cfg: ModelConfig, plan, q, k, v, *, causal, window,
               softcap):
    """Prefill attention, distributed as the reference's: head-TP when the
    KV heads (MLA: the heads) divide the model axis, with q, k, v this
    rank's heads; otherwise, with all heads, sequence-parallel when the
    sequence divides the model axis (the output's sequence gathered back),
    else the whole attention on every rank.  [B, S, heads, dv]."""
    hs = _head_spec(plan, cfg.n_kv_heads if cfg.mla is None else cfg.n_heads)
    if hs is None and plan is not None and plan.model_axis is not None:
        n = axis_size(plan.model_axis)
        if n > 1 and q.shape[1] % n == 0:
            out = _seq_parallel_prefill(plan, q, k, v, causal=causal,
                                        window=window, softcap=softcap)
            return all_gather(out, plan.model_axis, 1)
    return flash_attention(q, k, v, causal=causal, window=window,
                           softcap=softcap)


def _seq_axes(t: torch.Tensor):
    """The axes a cache tensor's sequence is sharded over, or None."""
    spec = getattr(t, "shard_spec", None)
    return spec[1] if spec and len(spec) > 1 else None


def attn_prefill(cfg: ModelConfig, spec: LayerSpec, p: Attention,
                 x: torch.Tensor, *, positions: torch.Tensor, plan=None,
                 causal: bool = True, cache_len: int = 0,
                 kv_len: Optional[torch.Tensor] = None,
                 prefix: Optional[dict] = None, seq_out: bool = False):
    """Full-sequence attention.  Returns (y, cache entry or None);
    ``cache_len`` > 0 allocates a cache: {"k", "v"} [B, cache_len, KV, hd],
    or on a window layer whose window is shorter than ``cache_len`` a ring
    {"k", "v"} [B, window, KV, hd] (``build_window_cache``; ``kv_len`` [B]
    gives each sequence's valid length, else the full sequence), or on an
    MLA layer {"c_kv" [B, cache_len, r], "k_rope" [B, cache_len, dr]}.
    Right-padded rows attend causally like every other row (no length
    mask): their outputs are never read.  Under ``plan`` x is this rank's
    batch rows and the cache takes its layout (module docstring);
    ``seq_out`` returns y's sequence slice of this rank (a
    sequence-parallel residual).

    ``prefix`` ({"k": [B, P, KV, hd], "v": [B, P, KV, dv]}) switches to
    continuation prefill: x holds only the uncached suffix (``positions``
    already offset by P), and the queries attend over the prefix K/V
    concatenated with the suffix's, causal at absolute positions through
    the kernel's ``q_offset``.  The returned cache covers the suffix only.
    Plain GQA caches only: MLA and window layers raise, as do plans with
    model or sequence axes, as in the reference."""
    window = cfg.sliding_window if spec.attn == "window" else None
    if prefix is not None:
        if cfg.mla is not None or window is not None:
            raise NotImplementedError(
                "prefix-continuation prefill needs a plain GQA cache")
        if _model_sharded(plan):
            raise NotImplementedError(
                "prefix-continuation prefill: sharded plans not supported")
    if cfg.mla is not None:
        q, c_kv, k_rope = _mla_qkv(cfg, p, x, positions)
        k, v = _mla_expand(cfg, p, c_kv, k_rope)
        out = _run_flash(cfg, plan, q, k, v, causal=causal, window=window,
                         softcap=cfg.attn_softcap)
        y = _o_proj(cfg, p, out, plan, seq_out)
        cache = None
        if cache_len:
            cache = cache_layout(cfg, plan, {
                "c_kv": _pad_seq(c_kv, cache_len),
                "k_rope": _pad_seq(k_rope, cache_len)})
        return y, cache

    q, k, v = _qkv(cfg, p, x, positions)
    b, s = q.shape[:2]
    if prefix is not None:
        out = flash_attention(q, torch.cat([prefix["k"].to(k.dtype), k], dim=1),
                              torch.cat([prefix["v"].to(v.dtype), v], dim=1),
                              causal=causal, softcap=cfg.attn_softcap,
                              q_offset=prefix["k"].shape[1])
    else:
        if sharded_axis(p.k.w, 1) is None:
            q = _all_heads(p.q.w, q)
        out = _run_flash(cfg, plan, q, k, v, causal=causal, window=window,
                         softcap=cfg.attn_softcap)
    y = _o_proj(cfg, p, out, plan, seq_out)
    cache = None
    if cache_len:
        if window is not None and window < cache_len:
            ln = kv_len if kv_len is not None else \
                torch.full((b,), s, dtype=torch.int32, device=x.device)
            cache = {"k": build_window_cache(k, ln, window),
                     "v": build_window_cache(v, ln, window)}
        else:
            cache = {"k": _pad_seq(k, cache_len), "v": _pad_seq(v, cache_len)}
        cache = cache_layout(cfg, plan, cache)
    return y, cache


def build_window_cache(k: torch.Tensor, kv_len: torch.Tensor,
                       w: int) -> torch.Tensor:
    """Re-lay full-sequence K/V [B, S, ...] into a ring [B, w, ...] with
    slot = position % w, keeping each sequence's newest w entries (kv_len
    [B] = its valid length; a slot no position reached takes the clamped
    position, as the reference's)."""
    b, s = k.shape[:2]
    slots = torch.arange(w, device=k.device)[None, :]
    ln = kv_len.to(k.device).long()[:, None]
    # largest position p <= ln-1 with p % w == slot (at least the slot)
    pos = slots + w * torch.div(ln - 1 - slots, w, rounding_mode="floor").clamp_min(0)
    pos = pos.clamp(0, s - 1)
    return k[torch.arange(b, device=k.device)[:, None], pos]


def _write_slot(buf: torch.Tensor, new: torch.Tensor,
                idx: torch.Tensor) -> None:
    """buf [B, S, ...][b, idx[b]] <- new [B, ...], in place.  An index past
    the last slot writes the last slot, as the reference's clamped
    ``dynamic_update_slice`` does.  On a sequence-sharded cache only the
    rank whose slot range holds the index writes (the others write back
    what they hold, so no step waits for the host)."""
    rows = torch.arange(buf.shape[0], device=buf.device)
    axes = _seq_axes(buf)
    if axes is None:
        buf[rows, idx.clamp(0, buf.shape[1] - 1)] = new
        return
    s_loc = buf.shape[1]
    local = idx.clamp(0, s_loc * axis_size(axes) - 1) - axis_index(axes) * s_loc
    own = ((local >= 0) & (local < s_loc)).reshape((-1,) + (1,) * (new.dim() - 1))
    local = local.clamp(0, s_loc - 1)
    buf[rows, local] = torch.where(own, new.to(buf.dtype), buf[rows, local])


def _gather_seq(t: torch.Tensor) -> torch.Tensor:
    """The whole sequence of a cache tensor (gathered when it is sharded)."""
    axes = _seq_axes(t)
    return all_gather(t, axes, 1) if axes is not None else t


def _sharded_decode(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    kv_len: torch.Tensor, axes, *, softcap,
                    window) -> torch.Tensor:
    """Flash-decoding over a KV cache sequence-sharded over ``axes``: this
    rank's rows start at its index (row-major over the axes) x S_loc; its
    partial softmax over the valid ones, merged across the axes
    (``combine_partials``).  q [B, H, D] all heads; kv_len [B] the valid
    length (the query's position + 1).  Returns [B, H, Dv]."""
    s_loc = k.shape[1]
    start = axis_index(axes) * s_loc
    local_len = (kv_len - start).clamp(0, s_loc)
    window_lo = (kv_len - window).clamp_min(0) if window is not None else None
    acc, m, l = decode_attention_partial(q, k, v, local_len, softcap=softcap,
                                         window_lo=window_lo, pos_offset=start)
    return combine_partials(acc, m, l, axis_name=axes).to(q.dtype)


def attn_decode(cfg: ModelConfig, spec: LayerSpec, p: Attention,
                x: torch.Tensor, cache: dict, kv_len: torch.Tensor, *,
                plan=None):
    """One-token decode.  x: [B, 1, d]; cache entry from attn_prefill;
    kv_len: [B] int32 current lengths (the new token's position).  The
    cache is updated in place — the reference returns a new array, here the
    write saves a copy of the whole cache per layer and step.  Returns
    (y, cache).

    A window layer whose cache is no wider than its window is a ring (slot
    = position % w), decoded by ``ring_decode_attention``.  An MLA layer
    decodes in the latent space (``_mla_decode_absorbed``) unless the plan
    asks for the expanded path (``mla_absorbed=False``: the latent
    expanded to K/V, then the decode kernel), as in the reference.  Under
    a plan, x is this rank's batch rows (module docstring)."""
    window = cfg.sliding_window if spec.attn == "window" else None
    if cfg.mla is not None:
        q, c_kv, k_rope = _mla_qkv(cfg, p, x, kv_len[:, None])
        _write_slot(cache["c_kv"], c_kv[:, 0], kv_len)
        _write_slot(cache["k_rope"], k_rope[:, 0], kv_len)
        lat = {n: _gather_seq(cache[n]) for n in ("c_kv", "k_rope")}
        if plan is None or plan.mla_absorbed:
            out = _mla_decode_absorbed(cfg, p, q[:, 0], lat, kv_len + 1)
        else:
            k, v = _mla_expand(cfg, p, lat["c_kv"], lat["k_rope"])
            out = decode_attention(q[:, 0], k, v, kv_len + 1,
                                   softcap=cfg.attn_softcap, window=window)
        return _o_proj(cfg, p, out[:, None], plan), cache
    q, k, v = _qkv(cfg, p, x, kv_len[:, None])
    if sharded_axis(p.k.w, 1) is None:
        q = _all_heads(p.q.w, q)
    axes = _seq_axes(cache["k"])
    w = cache["k"].shape[1]
    use_ring = axes is None and window is not None and w <= window
    slot = kv_len % w if use_ring else kv_len
    _write_slot(cache["k"], k[:, 0], slot)
    _write_slot(cache["v"], v[:, 0], slot)
    if use_ring:
        out = ring_decode_attention(q[:, 0], cache["k"], cache["v"], kv_len,
                                    softcap=cfg.attn_softcap)
    elif axes is not None:
        out = _sharded_decode(q[:, 0], cache["k"], cache["v"], kv_len + 1,
                              axes, softcap=cfg.attn_softcap, window=window)
    else:
        out = decode_attention(q[:, 0], cache["k"], cache["v"], kv_len + 1,
                               softcap=cfg.attn_softcap, window=window)
    return _o_proj(cfg, p, out[:, None], plan), cache


def ring_lengths(kv_len: torch.Tensor, w: int) -> torch.Tensor:
    """The ring slots a query at position kv_len [B] attends to, as a
    length: min(kv_len + 1, w).  Slot s of a ring of w holds position
    kv_len - ((kv_len - s) mod w), which lies inside the window (w is the
    window or a cache no wider than it) whenever it is >= 0, so the valid
    slots are exactly s < min(kv_len + 1, w)."""
    return (kv_len + 1).clamp(max=w)


def ring_decode_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          kv_len: torch.Tensor, softcap=None) -> torch.Tensor:
    """Decode attention over a ring cache k, v [B, w, KV, D] for q [B, H, D]
    at position kv_len [B], through the flash-decoding kernel over the
    first ``ring_lengths`` slots with no window: softmax does not depend on
    the keys' order, so this computes the reference's ``_ring_decode``
    (``ring_decode`` here, its plain version)."""
    return decode_attention(q, k, v, ring_lengths(kv_len, k.shape[1]),
                            softcap=softcap)


def ring_decode(cfg: ModelConfig, q: torch.Tensor, cache: dict,
                kv_len: torch.Tensor, window: int) -> torch.Tensor:
    """Plain version of decode attention over a ring cache (slot = pos %
    w), the reference's ``_ring_decode``: q [B, H, D] at position kv_len
    [B]; slot s holds position kv_len - ((kv_len - s) mod w), masked to
    the window.  The yardstick of ``ring_decode_attention``, which runs
    the flash-decoding kernel instead."""
    b, h, d = q.shape
    k, v = cache["k"], cache["v"]
    w, kv = k.shape[1], k.shape[2]
    qg = (q.float() * d ** -0.5).to(k.dtype).reshape(b, kv, h // kv, d)
    logits = softcap(torch.einsum("bkgd,bskd->bkgs", qg, k).float(),
                     cfg.attn_softcap)
    slots = torch.arange(w, device=q.device)[None, :]
    kl = kv_len.to(q.device).long()[:, None]
    pos = kl - (kl - slots) % w
    valid = (pos >= 0) & (pos > kl - window)
    logits = logits.masked_fill(~valid[:, None, None, :], -1e30)
    probs = torch.softmax(logits, dim=-1)
    out = torch.einsum("bkgs,bskd->bkgd", probs.to(v.dtype), v).float()
    return out.reshape(b, h, -1).to(q.dtype)


def _mla_decode_absorbed(cfg: ModelConfig, p: Attention, q: torch.Tensor,
                         cache: dict, kv_len: torch.Tensor) -> torch.Tensor:
    """Matmul-absorbed MLA decode: attention runs in the compressed latent
    space, W_uk absorbed into the query and W_uv into the output, so no
    step expands the latent cache to K/V:

        score_i = (W_uk^T q_nope)·c_i + q_rope·k_rope_i
        out     = (softmax(score) @ C) @ W_uv

    q: [B, H, dn+dr]; cache c_kv [B, S, r], k_rope [B, S, dr]; kv_len [B]
    valid entries.  Returns [B, H, dv]."""
    m = cfg.mla
    b, h, _ = q.shape
    s = cache["c_kv"].shape[1]
    q_nope, q_rope = q.split([m.qk_nope_head_dim, m.qk_rope_head_dim], dim=-1)
    # kv_up weight [r, H*(dn+dv)] -> U_k [r, H, dn], U_v [r, H, dv]
    u_k, u_v = p.kv_up.w.reshape(
        m.kv_lora_rank, h, m.qk_nope_head_dim + m.v_head_dim).split(
        [m.qk_nope_head_dim, m.v_head_dim], dim=-1)
    q_lat = torch.einsum("bhd,rhd->bhr", q_nope.float(), u_k.float())
    scale = m.qk_head_dim ** -0.5
    c, kr = cache["c_kv"], cache["k_rope"]
    logits = (torch.einsum("bhr,bsr->bhs", (q_lat * scale).to(c.dtype), c).float()
              + torch.einsum("bhd,bsd->bhs", (q_rope.float() * scale).to(kr.dtype),
                             kr).float())
    mask = torch.arange(s, device=q.device)[None, :] < kv_len[:, None]
    probs = torch.softmax(logits.masked_fill(~mask[:, None, :], -1e30), dim=-1)
    o_lat = torch.einsum("bhs,bsr->bhr", probs.to(c.dtype), c).float()
    out = torch.einsum("bhr,rhd->bhd", o_lat, u_v.float())
    return out.to(q.dtype)


def attn_paged_decode(cfg: ModelConfig, spec: LayerSpec, p: Attention,
                      x: torch.Tensor, pool: dict, block_tables: torch.Tensor,
                      kv_len: torch.Tensor, *, plan=None):
    """One-token decode against one layer's paged pool {"k": [N, bs, KV, hd],
    "v": [N, bs, KV, dv]}.  x: [B, 1, d]; block_tables [B, nb] int32 (rows
    padded with a valid null block); kv_len [B] int32 current lengths.  The
    new token's K/V is written into slot ``kv_len`` of its sequence's table
    in place — the reference returns a new pool — then attention reads
    through the table.  Returns (y, pool).

    Under a batch-only plan every rank holds the whole pool, and
    block_tables and kv_len are the whole batch's; x is this rank's rows
    when the batch axes divide the batch (``_paged_rows``), else all rows.
    Every row's K/V is written on every rank (``_paged_write``); attention
    runs on this rank's rows."""
    _check_paged(cfg, spec, plan)
    split, tables, lens = _paged_rows(plan, block_tables, kv_len)
    b = x.shape[0]
    q, k, v = _qkv(cfg, p, x, lens[:, None])
    bs = pool["k"].shape[1]
    rows = torch.arange(kv_len.shape[0], device=x.device)
    blk = block_tables[rows, (kv_len // bs).long()].long()
    _paged_write(pool, k[:, 0], v[:, 0], blk, (kv_len % bs).long(), plan,
                 split)
    out = paged_decode_attention(q[:, 0], pool["k"], pool["v"], tables,
                                 lens + 1, softcap=cfg.attn_softcap)
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
    the window.  Returns (y [B, T, d], pool).  Under a batch-only plan as
    ``attn_paged_decode``: blk/off are the whole batch's."""
    _check_paged(cfg, spec, plan)
    split, tables, lens = _paged_rows(plan, block_tables, kv_len)
    b, t, _ = x.shape
    positions = lens[:, None] + torch.arange(t, device=x.device)[None, :]
    q, k, v = _qkv(cfg, p, x, positions)
    _paged_write(pool, k, v, blk.long(), off.long(), plan, split)
    out = paged_window_attention(q, pool["k"], pool["v"], tables, lens,
                                 softcap=cfg.attn_softcap)
    return apply_dense(p.o, out.reshape(b, t, -1)), pool


# ------------------------------------------------------------ cross-attention

def cross_attn_prefill(cfg: ModelConfig, p: Attention, x: torch.Tensor,
                       memory: torch.Tensor, *, plan=None,
                       seq_out: bool = False):
    """Decoder cross-attention over the encoder output.  x: [B, S, d];
    memory: [B, F, d].  Every query row (right-padded ones too, whose
    outputs are never read) attends to all F memory rows: the
    flash-attention kernel, non-causal.  Returns (y [B, S, d], cache
    {"ck": [B, F, KV, hd], "cv": [B, F, KV, dv]}, the memory's projected
    K/V).  Under ``plan`` x and memory are this rank's batch rows: q, k
    and v are column-parallel by heads and ``o`` row-parallel, as in
    self-attention, and the cache takes ``cache_spec``'s layout;
    ``seq_out`` returns y's sequence slice of this rank."""
    b, s, _ = x.shape
    f = memory.shape[1]
    hd = cfg.head_dim_eff
    q = apply_dense(p.q, x).reshape(b, s, -1, hd)
    k = apply_dense(p.k, memory).reshape(b, f, -1, hd)
    v = apply_dense(p.v, memory).reshape(b, f, -1, cfg.v_head_dim_eff)
    if sharded_axis(p.k.w, 1) is None:
        q = _all_heads(p.q.w, q)
    out = _run_flash(cfg, plan, q, k, v, causal=False, window=None,
                     softcap=None)
    y = _o_proj(cfg, p, out, plan, seq_out)
    return y, cache_layout(cfg, plan, {"ck": k, "cv": v})


def cross_attn_decode(cfg: ModelConfig, p: Attention, x: torch.Tensor,
                      cache: dict, *, plan=None) -> torch.Tensor:
    """One decode token's cross-attention over the cached memory K/V
    (``cross_attn_prefill``'s cache, read only): the flash-decoding kernel
    with every row's length the memory's F.  x: [B, 1, d] -> [B, 1, d].
    Under ``plan`` on a head-sharded cache the kernel runs on this rank's
    heads.  A cache whose F rows are sharded over the sequence axes (KV
    heads that do not divide the model axis) raises: its decode would need
    ``_sharded_decode``'s combine, which no configuration reaches."""
    if _seq_axes(cache["ck"]) is not None:
        raise NotImplementedError(
            "cross-attention decode over a sequence-sharded memory cache")
    b = x.shape[0]
    q = apply_dense(p.q, x).reshape(b, -1, cfg.head_dim_eff)
    if sharded_axis(p.k.w, 1) is None:
        q = _all_heads(p.q.w, q)
    mem_len = torch.full((b,), cache["ck"].shape[1], dtype=torch.int32,
                         device=x.device)
    out = decode_attention(q, cache["ck"], cache["cv"], mem_len)
    return _o_proj(cfg, p, out[:, None], plan)
