"""Decoder-only LM assembly.  Port of ``repro/models/transformer.py`` for
the attention block and the Mamba block (the Jamba hybrid's), each with a
dense or Mixture-of-Experts MLP, and the RWKV-6 time-mix + channel-mix
block.

The reference stacks layer groups and runs one ``lax.scan``; here the stack
is an ``nn.ModuleList`` of ``n_layers`` blocks run by a Python loop.  The
decode cache, the paged pools and a continuation prefill's prefix K/V are
each a list with one entry per layer: {"k", "v"} for attention ([B,
cache_len, ...], or a ring [B, window, ...] on a window layer whose window
is shorter than the cache), {"c_kv", "k_rope"} for MLA, {"conv" [B,
d_conv - 1, d_in], "ssm" [B, d_in, N] f32} for Mamba, {"shift", "state",
"cm_shift"} for RWKV-6.

Under a sharding plan (``repro_torch.sharding``; the caller sets the mesh)
prefill and decode take the whole batch on every rank and return the
whole batch's logits on every rank, with the cache this rank's shard:
the batch is split over ``plan.batch_axes`` when they divide it, and
otherwise runs whole on every rank, which only a dense model under a
batch-only plan allows (``batch_rows``); the embedding is
vocab-parallel (each rank looks up the ids of its vocab range, zeros
elsewhere, then a psum over the model axis); attention, MLP and MoE run
tensor-, sequence- and expert-parallel in their modules; the head is
vocab-parallel and its logits are gathered over the model axis, then over
the batch axes, so every rank samples the same token.  With
``plan.seq_parallel`` and a sequence the model axis divides, the residual
between blocks holds this rank's sequence slice: each mixer and MLP input
is all-gathered along the sequence and each output reduce-scattered
(``resid_spec``).  Weights that the plan's ``fsdp_axes`` shard are
gathered one block at a time (``common.gather_params``), and the embedding
and the head each before their use.  The paged decode and verify steps
take a batch-only plan: every rank holds the whole paged pools, and each
layer writes every row's new K/V into them (``attention``'s docstring).

The training loss under a plan (``lm_loss(plan=)``) takes the whole batch
on every rank and returns the global loss on every rank: this rank's rows
run as above, the logits stay vocab-sharded over the model axis and the
cross entropy is the vocab-parallel one (``nll_sum``), and the nll and
mask sums are psummed over the batch axes before the division.  With
``plan.remat`` each block runs under ``torch.utils.checkpoint`` (its
forward again in the backward, the reference's ``jax.checkpoint`` of the
scanned group).  Mamba and RWKV-6 blocks run under a plan (``mamba``
channel-parallel, ``rwkv`` head-parallel, the channel mix as the MLP),
their caches whole over the model axis as the reference's specs lay them
out; in the loss they keep no cache, so their state gathers do not run.
"""
from __future__ import annotations

import functools
import math
from typing import Optional

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import LayerSpec, ModelConfig
from repro_torch.device import resolve_device
from repro_torch.distributed.collectives import (all_gather, axis_index,
                                                 local_chunk, pmax, psum)
from repro_torch.models import attention as attn
from repro_torch.models import mamba as mamba_mod
from repro_torch.models import moe as moe_mod
from repro_torch.models import rwkv as rwkv_mod
from repro_torch.models.common import (Norm, apply_norm, cache_layout,
                                      gather_params, last_valid, randn,
                                      sharded_axis, softcap, unshard)
from repro_torch.models.mlp import (MLP, ChannelMix, channel_mix_apply,
                                    mlp_apply, token_shift)
from repro_torch.sharding.mesh import axis_size
from repro_torch.sharding.plan import ShardingPlan, resid_spec, splits_batch


class Block(nn.Module):
    def __init__(self, cfg: ModelConfig, spec: LayerSpec,
                 generator: torch.Generator, dtype=torch.float32):
        super().__init__()
        self.norm1 = Norm(cfg, dtype)
        self.norm2 = Norm(cfg, dtype)
        if spec.mixer == "rwkv6":
            self.mixer = rwkv_mod.RWKV(cfg, generator, dtype)
        elif spec.mixer == "mamba":
            self.mixer = mamba_mod.Mamba(cfg, generator, dtype)
        else:
            self.mixer = attn.Attention(cfg, generator, dtype)
        if spec.mlp == "moe":
            self.mlp = moe_mod.MoE(cfg, generator, dtype)
        elif spec.mixer == "rwkv6":
            self.mlp = ChannelMix(cfg, generator, dtype)
        else:
            self.mlp = MLP(cfg, generator, dtype)
        if cfg.post_block_norms:
            self.norm1_post = Norm(cfg, dtype)
            self.norm2_post = Norm(cfg, dtype)


class Transformer(nn.Module):
    """Parameters of the LM: ``embed.w`` [Vp, d], ``blocks.{i}.*``,
    ``final_norm``, and ``head.w`` [d, Vp] when embeddings are untied.
    Each part is drawn from ``generator`` on the CPU and moved to
    ``device`` before the next is drawn, so the host holds one block at a
    time; with no generator (a build on ``meta``) nothing is drawn."""

    def __init__(self, cfg: ModelConfig, generator: torch.Generator,
                 dtype=torch.float32, device: torch.device = torch.device("cpu")):
        super().__init__()
        self.cfg = cfg
        g = generator
        self.embed = nn.Module()
        self.embed.w = nn.Parameter(
            (randn(cfg.padded_vocab, cfg.d_model, generator=g)
             * 0.02).to(dtype).to(device), requires_grad=False)
        self.final_norm = Norm(cfg, dtype).to(device)
        self.blocks = nn.ModuleList(Block(cfg, spec, g, dtype).to(device)
                                    for spec in cfg.layer_plan())
        self.head = None
        if not cfg.tie_embeddings:
            self.head = nn.Module()
            self.head.w = nn.Parameter(
                (randn(cfg.d_model, cfg.padded_vocab, generator=g)
                 * cfg.d_model ** -0.5).to(dtype).to(device), requires_grad=False)


def init_params(cfg: ModelConfig, seed: int = 0, dtype=torch.float32,
                device: str | torch.device = "cuda",
                generator_device: str | torch.device = "cpu") -> Transformer:
    """Seeded random weights, the reference's shapes and scales, on the
    card unless ``device`` says otherwise.  They are drawn on the CPU and
    then moved, so a seed gives the same weights on every device;
    ``generator_device="cuda"`` draws them on the card instead (another
    random stream, and no host draw of the weights).  On ``device="meta"``
    every parameter has the reference's shape and dtype and nothing is
    drawn (the dry run, ``launch.dryrun``)."""
    device = resolve_device(device)
    if device.type == "meta":
        with torch.device("meta"):
            return Transformer(cfg, None, dtype, device)
    gen = torch.Generator(resolve_device(generator_device)).manual_seed(seed)
    return Transformer(cfg, gen, dtype, device)


def block_apply(cfg: ModelConfig, spec: LayerSpec, p: Block, x: torch.Tensor,
                *, positions, cache, kv_len, mode: str, cache_len: int,
                block_tables=None, spec_scatter=None, plan=None,
                seq_par: bool = False):
    """Returns (x, new cache entry or None).  With ``block_tables`` the
    decode reads and writes the layer's paged pool (``cache``), and
    ``spec_scatter`` ((blk, off) [B, T]) makes it the multi-token verify
    window.  In prefill mode a ``cache`` entry is a prefix K/V to continue
    from.  An MoE layer's aux metrics are dropped, as the reference's
    serve path drops them.  In train mode (the loss's forward: a prefill
    that keeps no cache) it returns (x, aux) instead: the MoE layer's
    {"lb_loss", "drop_frac"}, {} for a dense one.  Under ``plan`` x is
    this rank's batch rows, and with ``seq_par`` its sequence slice (the
    sequence-parallel residual); under a plan with fsdp axes its
    fsdp-sharded weights are gathered here."""
    if plan is not None and plan.fsdp_axes:
        p = gather_params(p)
    h = _seq_gather(apply_norm(cfg, p.norm1, x), plan, seq_par)
    if block_tables is not None and spec.mixer != "attn":
        raise NotImplementedError(
            f"paged decode only supports attention mixers, got {spec.mixer}")
    if spec.mixer == "rwkv6":
        if mode != "decode" and cache is not None:
            raise NotImplementedError(
                "prefix-continuation prefill: rwkv6 state is recurrent")
        if mode == "decode":
            mx, c = rwkv_mod.rwkv_decode(cfg, p.mixer, h, cache, plan=plan)
        else:
            mx, c = rwkv_mod.rwkv_prefill(cfg, p.mixer, h, cache_len=cache_len,
                                          kv_len=kv_len, plan=plan,
                                          seq_out=seq_par)
    elif spec.mixer == "mamba":
        if mode != "decode" and cache is not None:
            raise NotImplementedError(
                "prefix-continuation prefill: mamba state is recurrent")
        if mode == "decode":
            mx, c = mamba_mod.mamba_decode(cfg, p.mixer, h, cache, plan=plan)
        else:
            mx, c = mamba_mod.mamba_prefill(cfg, p.mixer, h,
                                            cache_len=cache_len, kv_len=kv_len,
                                            plan=plan, seq_out=seq_par)
    elif mode == "decode" and block_tables is not None \
            and spec_scatter is not None:
        mx, c = attn.attn_paged_spec(cfg, spec, p.mixer, h, cache,
                                     block_tables, kv_len, *spec_scatter,
                                     plan=plan)
    elif mode == "decode" and block_tables is not None:
        mx, c = attn.attn_paged_decode(cfg, spec, p.mixer, h, cache,
                                       block_tables, kv_len, plan=plan)
    elif mode == "decode":
        mx, c = attn.attn_decode(cfg, spec, p.mixer, h, cache, kv_len,
                                 plan=plan)
    else:
        mx, c = attn.attn_prefill(cfg, spec, p.mixer, h, positions=positions,
                                  cache_len=cache_len, kv_len=kv_len,
                                  prefix=cache, plan=plan, seq_out=seq_par)
    if cfg.post_block_norms:
        mx = apply_norm(cfg, p.norm1_post, mx)
    x = x + mx
    h2 = _seq_gather(apply_norm(cfg, p.norm2, x), plan, seq_par)
    aux = {}
    if spec.mlp == "moe":
        my, aux = moe_mod.moe_apply(cfg, p.mlp, h2, plan=plan, seq_out=seq_par)
    elif spec.mixer == "rwkv6":
        decode = mode == "decode"
        my = channel_mix_apply(
            cfg, p.mlp, h2,
            cache["cm_shift"][:, None] if decode else token_shift(h2),
            plan=plan, seq_out=seq_par)
        if c is not None:
            c["cm_shift"] = h2[:, 0] if decode else last_valid(h2, kv_len)
    else:
        my = mlp_apply(cfg, p.mlp, h2, plan=plan, seq_out=seq_par)
    if cfg.post_block_norms:
        my = apply_norm(cfg, p.norm2_post, my)
    if c is not None and spec.mixer != "attn":
        c = cache_layout(cfg, plan, c)
    return x + my, (aux if mode == "train" else c)


def apply_stack(cfg: ModelConfig, params: Transformer, x: torch.Tensor, *,
                positions, mode: str, cache: Optional[list] = None,
                kv_len=None, cache_len: int = 0, block_tables=None,
                spec_scatter=None, plan=None, seq_par: bool = False):
    """Run every block.  Returns (x, new cache list or None); in train mode
    (x, {"lb_loss": the MoE layers' load-balance losses summed, f32}).  In
    train mode under ``plan.remat`` each block is checkpointed: its
    activations are recomputed in the backward (the fsdp gathers too)."""
    specs = cfg.layer_plan()
    new_cache = []
    lb_loss = torch.zeros((), dtype=torch.float32, device=x.device)
    remat = mode == "train" and plan is not None and plan.remat
    for i, blk in enumerate(params.blocks):
        run = functools.partial(
            block_apply, cfg, specs[i], blk, positions=positions,
            cache=cache[i] if cache is not None else None, kv_len=kv_len,
            mode=mode, cache_len=cache_len, block_tables=block_tables,
            spec_scatter=spec_scatter, plan=plan, seq_par=seq_par)
        x, c = checkpoint(run, x, use_reentrant=False) if remat else run(x)
        if mode == "train":
            if "lb_loss" in c:
                lb_loss = lb_loss + c["lb_loss"]
        else:
            new_cache.append(c)
    if mode == "train":
        return x, {"lb_loss": lb_loss}
    return x, (new_cache if any(c is not None for c in new_cache) else None)


def embed_tokens(cfg: ModelConfig, params: Transformer,
                 tokens: torch.Tensor) -> torch.Tensor:
    """Token embeddings; vocab-parallel when the table's rows are sharded
    (each rank's rows looked up, zeros elsewhere, psummed)."""
    w = unshard(params.embed.w)
    ax = sharded_axis(w, 0)
    if ax is None:
        x = w[tokens]
    else:
        ids = tokens - axis_index(ax) * w.shape[0]
        ok = (ids >= 0) & (ids < w.shape[0])
        x = psum(torch.where(ok[..., None], w[ids.clamp(0, w.shape[0] - 1)],
                             0), ax)
    if cfg.scale_embeddings:
        x = x * math.sqrt(cfg.d_model)
    return x


def _head_weight(cfg: ModelConfig, params: Transformer):
    """The head's weight [d, Vp] (the tied table's transpose), gathered
    over fsdp axes, and the axis its vocab is sharded over (or None)."""
    if cfg.tie_embeddings:
        w = unshard(params.embed.w)
        return w.T, sharded_axis(w, 0)
    w = unshard(params.head.w)
    return w, sharded_axis(w, 1)


def lm_head(cfg: ModelConfig, params: Transformer, x: torch.Tensor) -> torch.Tensor:
    """Logits [..., Vp] f32; vocab-parallel when the head's (or the tied
    table's) vocab is sharded, the slices gathered over the model axis."""
    w, ax = _head_weight(cfg, params)
    logits = x @ w
    if ax is not None:
        logits = all_gather(logits, ax, logits.dim() - 1)
    return softcap(logits.float(), cfg.final_softcap)


def batch_rows(cfg: ModelConfig, plan: Optional[ShardingPlan],
               rows: int) -> bool:
    """Whether a call's ``rows`` are split over ``plan``'s batch axes
    (``plan.splits_batch``); a batch they do not divide runs whole on
    every rank.  An MoE block splits its rows under the reference's
    ``shard_map``, which rejects such a batch: ValueError here too."""
    split = splits_batch(plan, rows)
    if not split and cfg.moe is not None and plan is not None \
            and axis_size(plan.batch_axes) > 1:
        raise ValueError(
            f"{cfg.name}: the MoE block splits its {rows} rows over the "
            f"batch axes {plan.batch_axes} ({axis_size(plan.batch_axes)} "
            "shards), which do not divide them")
    return split


def split_batch(plan: Optional[ShardingPlan], split: bool, *xs):
    """This rank's rows of each tensor (None passes) when ``split``
    (``batch_rows``), else the tensors whole."""
    if not split:
        return xs
    return tuple(None if x is None else local_chunk(x, plan.batch_axes, 0)
                 for x in xs)


def gather_batch(plan: Optional[ShardingPlan], split: bool,
                 x: torch.Tensor) -> torch.Tensor:
    """All rows of a per-rank batch tensor, on every rank (``x`` itself
    when its rows were not split)."""
    return all_gather(x, plan.batch_axes, 0) if split else x


def _seq_par(plan: Optional[ShardingPlan], shape) -> bool:
    """Whether the residual of global ``shape`` is sequence-sharded."""
    spec = resid_spec(plan, tuple(shape))
    return plan is not None and len(spec) > 1 and spec[1] is not None


def _seq_gather(h: torch.Tensor, plan, seq_par: bool) -> torch.Tensor:
    return all_gather(h, plan.model_axis, 1) if seq_par else h


def default_positions(cfg: ModelConfig, b: int, s: int, offset: int = 0,
                      device=None) -> torch.Tensor:
    """Positions offset..offset+s-1 of every row, [B, S]; for M-RoPE the
    text mode's three equal streams (t = h = w), [3, B, S]."""
    pos = offset + torch.arange(s, device=device)[None, :].expand(b, s)
    if cfg.rope == "mrope":
        return pos.expand(3, b, s)
    return pos


def lm_forward(cfg: ModelConfig, params: Transformer, tokens: torch.Tensor, *,
               embeds: Optional[torch.Tensor] = None,
               positions: Optional[torch.Tensor] = None):
    """Training / scoring forward: tokens [B, S] (or ``embeds`` [B, S, d])
    -> (logits [B, S, Vp] f32, {"lb_loss"})."""
    x = embeds if embeds is not None else embed_tokens(cfg, params, tokens)
    b, s = x.shape[:2]
    if positions is None:
        positions = default_positions(cfg, b, s, device=x.device)
    x, aux = apply_stack(cfg, params, x, positions=positions, mode="train")
    x = apply_norm(cfg, params.final_norm, x)
    return lm_head(cfg, params, x), aux


def nll_sum(cfg: ModelConfig, params, x: torch.Tensor, labels: torch.Tensor,
            mask: torch.Tensor) -> torch.Tensor:
    """Summed masked cross entropy of the final-normed x [B, S, d] (one
    sequence chunk, the reference's ``_nll_chunk``); the padded
    vocabulary's columns are masked to -1e30.  When the head's vocab is
    sharded (under a plan's model axis) the logits stay this rank's
    columns and the log-softmax is vocab-parallel: the max is the pmax of
    the shards' (detached) maxima, the exponentials' sum a psum, and the
    label's logit comes from the rank whose columns hold it, psummed; the
    result is then the same on every rank of the model axis."""
    w, ax = _head_weight(cfg, params)
    logits = softcap((x @ w).float(), cfg.final_softcap)
    v_loc = logits.shape[-1]
    start = axis_index(ax) * v_loc if ax is not None else 0
    col = start + torch.arange(v_loc, device=x.device)
    logits = torch.where(col < cfg.vocab_size, logits,
                         torch.full_like(logits, -1e30))
    if ax is None:
        logp = torch.log_softmax(logits, dim=-1)
        nll = -torch.gather(logp, -1, labels[..., None].long())[..., 0]
        return (nll * mask).sum()
    m = pmax(logits.detach().amax(dim=-1, keepdim=True), ax)
    lse = m[..., 0] + torch.log(psum(torch.exp(logits - m).sum(-1), ax))
    ids = labels.long() - start
    mine = (ids >= 0) & (ids < v_loc)
    picked = torch.gather(logits, -1, ids.clamp(0, v_loc - 1)[..., None])[..., 0]
    label_logit = psum(torch.where(mine, picked, torch.zeros_like(picked)), ax)
    return ((lse - label_logit) * mask).sum()


def lm_loss(cfg: ModelConfig, params: Transformer, batch: dict, *,
            plan: Optional[ShardingPlan] = None, loss_chunk: int = 2048):
    """batch: {"tokens" [B, S] (or "embeds" [B, S, d]), "labels" [B, S]
    (the next tokens), "mask" [B, S] (optional)}.  The cross entropy is
    summed over sequence chunks of ``loss_chunk`` (the whole sequence when
    it does not divide), the [B, chunk, Vp] logits computed a chunk at a
    time, and divided by the mask's sum; an MoE model adds 0.01 x its
    summed load-balance loss / n_layers.  Returns (loss, {"nll",
    "lb_loss"}).  Under ``plan`` (a mesh set; module docstring) the batch
    is the whole batch on every rank and so are the results."""
    labels, mask = batch["labels"], batch.get("mask")
    mask = torch.ones(labels.shape, dtype=torch.float32, device=labels.device) \
        if mask is None else mask.float()
    split = batch_rows(cfg, plan, labels.shape[0])
    tokens, x, labels, mask = split_batch(plan, split, batch.get("tokens"),
                                          batch.get("embeds"), labels, mask)
    if x is None:
        x = embed_tokens(cfg, params, tokens)
    b, s = x.shape[:2]
    positions = default_positions(cfg, b, s, device=x.device)
    seq_par = _seq_par(plan, x.shape)
    if seq_par:
        x = local_chunk(x, plan.model_axis, 1)
    x, aux = apply_stack(cfg, params, x, positions=positions, mode="train",
                         plan=plan, seq_par=seq_par)
    x = apply_norm(cfg, params.final_norm, _seq_gather(x, plan, seq_par))
    c = min(loss_chunk, s)
    if s % c:
        c = s
    total = sum(nll_sum(cfg, params, x[:, i:i + c], labels[:, i:i + c],
                        mask[:, i:i + c]) for i in range(0, s, c))
    count = mask.sum()
    if plan is not None:
        total, count = psum(total, plan.batch_axes), psum(count, plan.batch_axes)
    loss = total / count.clamp_min(1.0)
    if cfg.moe is not None:
        loss = loss + 0.01 * aux["lb_loss"] / max(cfg.n_layers, 1)
    return loss, {"nll": loss, "lb_loss": aux["lb_loss"]}


def lm_prefill(cfg: ModelConfig, params: Transformer, tokens: torch.Tensor, *,
               cache_len: int, kv_len: Optional[torch.Tensor] = None,
               embeds: Optional[torch.Tensor] = None,
               prefix_kv: Optional[list] = None, plan=None):
    """Prompt processing.  tokens [B, S]; kv_len [B] valid prompt lengths of
    the right-padded rows; ``embeds`` [B, S, d] (the vision stub's patch
    embeddings) in place of the tokens' embeddings.  Returns (logits [B,
    Vp] of each row's last valid token, cache).

    ``prefix_kv`` (one {"k": [B, P, KV, hd], "v": ...} per layer) switches
    to continuation prefill: ``tokens`` holds only the uncached suffix at
    positions P.., the prefix K/V is attended through, the returned cache
    covers the suffix only, and ``kv_len`` counts valid suffix tokens.
    Under ``plan`` (module docstring) the inputs and
    logits are the whole batch's and the cache is this rank's."""
    rows = (tokens if embeds is None else embeds).shape[0]
    split = batch_rows(cfg, plan, rows)
    tokens, kv_len, embeds = split_batch(plan, split, tokens, kv_len, embeds)
    if prefix_kv is not None and split:
        prefix_kv = [{n: split_batch(plan, split, t)[0] for n, t in e.items()}
                     for e in prefix_kv]
    x = embeds if embeds is not None else embed_tokens(cfg, params, tokens)
    b, s = x.shape[:2]
    p_len = prefix_kv[0]["k"].shape[1] if prefix_kv is not None else 0
    positions = default_positions(cfg, b, s, p_len, device=x.device)
    seq_par = _seq_par(plan, x.shape)
    if seq_par:
        x = local_chunk(x, plan.model_axis, 1)
    x, cache = apply_stack(cfg, params, x, positions=positions, mode="prefill",
                           kv_len=kv_len, cache_len=cache_len, cache=prefix_kv,
                           plan=plan, seq_par=seq_par)
    x = apply_norm(cfg, params.final_norm, _seq_gather(x, plan, seq_par))
    return gather_batch(plan, split,
                        lm_head(cfg, params, last_valid(x, kv_len))), cache


def lm_decode_step(cfg: ModelConfig, params: Transformer, tokens: torch.Tensor,
                   cache: list, kv_len: torch.Tensor, *, plan=None):
    """One decode step.  tokens [B, 1]; kv_len [B] int32 current lengths.
    Returns (logits [B, Vp], cache) — the cache is updated in place.  Under
    ``plan`` tokens, kv_len and logits are the whole batch's, the cache
    this rank's."""
    split = batch_rows(cfg, plan, tokens.shape[0])
    tokens, kv_len = split_batch(plan, split, tokens, kv_len)
    x = embed_tokens(cfg, params, tokens)
    x, cache = apply_stack(cfg, params, x, positions=None, mode="decode",
                           cache=cache, kv_len=kv_len, plan=plan)
    x = apply_norm(cfg, params.final_norm, x)
    return gather_batch(plan, split, lm_head(cfg, params, x[:, 0])), cache


def lm_paged_decode_step(cfg: ModelConfig, params: Transformer,
                         tokens: torch.Tensor, pools: list,
                         block_tables: torch.Tensor, kv_len: torch.Tensor, *,
                         plan=None):
    """One decode step against the paged pools (one {"k", "v"} per layer,
    written in place).  tokens [B, 1]; block_tables [B, nb] int32; kv_len
    [B] int32.  Returns (logits [B, Vp], pools).  Under a batch-only
    ``plan`` the inputs and logits are the whole batch's and every rank
    holds the whole pools: this rank's rows run the step (``batch_rows``:
    all rows when the batch axes do not divide them) and every row's new
    K/V is written into every rank's pools
    (``attention.attn_paged_decode``)."""
    split = batch_rows(cfg, plan, tokens.shape[0])
    x = embed_tokens(cfg, params, split_batch(plan, split, tokens)[0])
    x, pools = apply_stack(cfg, params, x, positions=None, mode="decode",
                           cache=pools, kv_len=kv_len,
                           block_tables=block_tables, plan=plan)
    x = apply_norm(cfg, params.final_norm, x)
    return gather_batch(plan, split, lm_head(cfg, params, x[:, 0])), pools


def lm_paged_spec_step(cfg: ModelConfig, params: Transformer,
                       tokens: torch.Tensor, pools: list,
                       block_tables: torch.Tensor, kv_len: torch.Tensor,
                       blk: torch.Tensor, off: torch.Tensor, *, plan=None):
    """Multi-token (speculative-verification) step against the paged pools.
    tokens [B, T] = current input token + T-1 drafts; kv_len [B] history
    before the window; blk/off [B, T] per-position scatter targets.  Returns
    (logits [B, T, Vp], pools); logits[:, t] scores the token after window
    position t.  Under a batch-only ``plan`` as ``lm_paged_decode_step``."""
    split = batch_rows(cfg, plan, tokens.shape[0])
    x = embed_tokens(cfg, params, split_batch(plan, split, tokens)[0])
    x, pools = apply_stack(cfg, params, x, positions=None, mode="decode",
                           cache=pools, kv_len=kv_len,
                           block_tables=block_tables,
                           spec_scatter=(blk, off), plan=plan)
    x = apply_norm(cfg, params.final_norm, x)
    return gather_batch(plan, split, lm_head(cfg, params, x)), pools
