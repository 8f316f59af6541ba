"""Encoder-decoder assembly (the Whisper backbone).  Port of
``repro/models/encdec.py``.

The conv/mel frontend is a stub, as in the reference: callers give
precomputed frame embeddings [B, F, d].  Both stacks add the reference's
sinusoidal positions (its documented departure from Whisper's learned
decoder positions).  The encoder runs the flash-attention kernel
non-causally over the frames; each decoder block runs causal
self-attention, cross-attention over the encoder memory and a plain MLP.
The cross-attention K/V are projected once from the memory at prefill and
cached; a decode step reads them unchanged.

The reference stacks each stack's blocks and runs ``lax.scan``; here each
is an ``nn.ModuleList`` run by a Python loop.  The decode cache is a list
with one {"self": {"k", "v"} [B, cache_len, KV, hd], "cross": {"ck",
"cv"} [B, F, KV, hd]} per decoder layer; the self part is updated in place
at each step.

Under a sharding plan (a mesh set; ``models.transformer``'s docstring)
the entry points take the whole batch on every rank and return the whole
batch's logits, or the global loss, on every rank: this rank's rows of
the frames and tokens run both stacks; self- and cross-attention are
head-parallel and the MLP Megatron's (``attention``, ``mlp``); the
embedding and head are vocab-parallel; with a sequence-parallel residual
each stack carries this rank's sequence slice between blocks; under fsdp
axes each block's weights are gathered before it runs.  Each cache tensor
takes ``specs.cache_spec``'s layout: the self and cross K/V head-sharded
under head-TP.  The reference runs no remat here, and neither does the
port.
"""
from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from repro_torch.configs.base import LayerSpec, ModelConfig
from repro_torch.device import resolve_device
from repro_torch.models import attention as attn
from repro_torch.distributed.collectives import local_chunk, psum
from repro_torch.models import transformer as T
from repro_torch.models.common import (Norm, apply_norm, gather_params,
                                       last_valid, randn, sinusoidal_positions)
from repro_torch.models.mlp import MLP, mlp_apply
from repro_torch.models.transformer import embed_tokens, lm_head, nll_sum

_FULL = LayerSpec(mixer="attn", attn="full", mlp="dense")


class EncBlock(nn.Module):
    def __init__(self, cfg: ModelConfig, generator: torch.Generator,
                 dtype=torch.float32):
        super().__init__()
        self.norm1 = Norm(cfg, dtype)
        self.norm2 = Norm(cfg, dtype)
        self.attn = attn.Attention(cfg, generator, dtype)
        self.mlp = MLP(cfg, generator, dtype)


class DecBlock(nn.Module):
    def __init__(self, cfg: ModelConfig, generator: torch.Generator,
                 dtype=torch.float32):
        super().__init__()
        self.norm1 = Norm(cfg, dtype)
        self.norm2 = Norm(cfg, dtype)
        self.norm3 = Norm(cfg, dtype)
        self.self_attn = attn.Attention(cfg, generator, dtype)
        self.cross_attn = attn.Attention(cfg, generator, dtype)
        self.mlp = MLP(cfg, generator, dtype)


class EncDec(nn.Module):
    """Parameters of the encoder-decoder: ``embed.w`` [Vp, d] (the tied
    head), ``enc_blocks.{i}.*``, ``dec_blocks.{i}.*``, ``enc_norm`` and
    ``final_norm``.  Each part is drawn from ``generator`` on the CPU and
    moved to ``device`` before the next is drawn, so the host holds one
    block at a time; with no generator (a build on ``meta``) nothing is
    drawn."""

    def __init__(self, cfg: ModelConfig, generator: torch.Generator,
                 dtype=torch.float32, device: torch.device = torch.device("cpu")):
        super().__init__()
        self.cfg = cfg
        g = generator
        self.embed = nn.Module()
        self.embed.w = nn.Parameter(
            (randn(cfg.padded_vocab, cfg.d_model, generator=g) * 0.02)
            .to(dtype).to(device), requires_grad=False)
        self.enc_blocks = nn.ModuleList(EncBlock(cfg, g, dtype).to(device)
                                        for _ in range(cfg.n_encoder_layers))
        self.dec_blocks = nn.ModuleList(DecBlock(cfg, g, dtype).to(device)
                                        for _ in range(cfg.n_layers))
        self.enc_norm = Norm(cfg, dtype).to(device)
        self.final_norm = Norm(cfg, dtype).to(device)


def init_params(cfg: ModelConfig, seed: int = 0, dtype=torch.float32,
                device: str | torch.device = "cuda",
                generator_device: str | torch.device = "cpu") -> EncDec:
    """Seeded random weights, the reference's shapes and scales, on the
    card unless ``device`` says otherwise; drawn on the CPU and then moved,
    so a seed gives the same weights on every device (``generator_device=
    "cuda"`` draws them on the card: another stream).  On ``device=
    "meta"`` nothing is drawn, as ``transformer.init_params``."""
    device = resolve_device(device)
    if device.type == "meta":
        with torch.device("meta"):
            return EncDec(cfg, None, dtype, device)
    gen = torch.Generator(resolve_device(generator_device)).manual_seed(seed)
    return EncDec(cfg, gen, dtype, device)


def encode(cfg: ModelConfig, params: EncDec, frames: torch.Tensor, *,
           plan=None) -> torch.Tensor:
    """frames: [B, F, d] stubbed frame embeddings -> memory [B, F, d].
    Under ``plan`` frames are this rank's rows; with a sequence-parallel
    residual (``transformer._seq_par``) the blocks carry this rank's
    frame slice and the memory is gathered whole at the end."""
    f = frames.shape[1]
    x = frames + sinusoidal_positions(
        torch.arange(f, device=frames.device), cfg.d_model).to(frames.dtype)[None]
    seq_par = T._seq_par(plan, x.shape)
    if seq_par:
        x = local_chunk(x, plan.model_axis, 1)
    for bp in params.enc_blocks:
        if plan is not None and plan.fsdp_axes:
            bp = gather_params(bp)
        h = T._seq_gather(apply_norm(cfg, bp.norm1, x), plan, seq_par)
        y, _ = attn.attn_prefill(cfg, _FULL, bp.attn, h, positions=None,
                                 plan=plan, causal=False, seq_out=seq_par)
        x = x + y
        h = T._seq_gather(apply_norm(cfg, bp.norm2, x), plan, seq_par)
        x = x + mlp_apply(cfg, bp.mlp, h, plan=plan, seq_out=seq_par)
    return apply_norm(cfg, params.enc_norm, T._seq_gather(x, plan, seq_par))


def _dec_stack(cfg: ModelConfig, params: EncDec, x: torch.Tensor,
               memory: Optional[torch.Tensor], *, mode: str,
               cache: Optional[list] = None, kv_len=None, cache_len: int = 0,
               plan=None):
    """Every decoder block.  Prefill (``memory`` given) builds each layer's
    {"self", "cross"} cache when ``cache_len`` > 0; decode reads and
    updates ``cache`` (self part in place, cross part passed through).
    Returns (final-normed x, cache list or None).  Under ``plan`` x is
    this rank's rows, with a sequence-parallel residual in prefill and
    train mode as ``transformer.lm_loss`` runs it; the returned x is the
    whole sequence."""
    seq_par = mode != "decode" and T._seq_par(plan, x.shape)
    if seq_par:
        x = local_chunk(x, plan.model_axis, 1)
    new_cache = []
    for i, bp in enumerate(params.dec_blocks):
        if plan is not None and plan.fsdp_axes:
            bp = gather_params(bp)
        nc = {}
        h = T._seq_gather(apply_norm(cfg, bp.norm1, x), plan, seq_par)
        if mode == "decode":
            y, c = attn.attn_decode(cfg, _FULL, bp.self_attn, h,
                                    cache[i]["self"], kv_len, plan=plan)
        else:
            y, c = attn.attn_prefill(cfg, _FULL, bp.self_attn, h,
                                     positions=None, cache_len=cache_len,
                                     kv_len=kv_len, plan=plan,
                                     seq_out=seq_par)
        if c is not None:
            nc["self"] = c
        x = x + y
        h = T._seq_gather(apply_norm(cfg, bp.norm2, x), plan, seq_par)
        if mode == "decode":
            y = attn.cross_attn_decode(cfg, bp.cross_attn, h,
                                       cache[i]["cross"], plan=plan)
            nc["cross"] = cache[i]["cross"]
        else:
            y, cc = attn.cross_attn_prefill(cfg, bp.cross_attn, h, memory,
                                            plan=plan, seq_out=seq_par)
            if cache_len:
                nc["cross"] = cc
        x = x + y
        h = T._seq_gather(apply_norm(cfg, bp.norm3, x), plan, seq_par)
        x = x + mlp_apply(cfg, bp.mlp, h, plan=plan, seq_out=seq_par)
        new_cache.append(nc or None)
    cache_out = new_cache if any(c is not None for c in new_cache) else None
    x = T._seq_gather(x, plan, seq_par)
    return apply_norm(cfg, params.final_norm, x), cache_out


def _dec_embed(cfg: ModelConfig, params: EncDec,
               tokens: torch.Tensor) -> torch.Tensor:
    x = embed_tokens(cfg, params, tokens)
    pos = torch.arange(tokens.shape[1], device=tokens.device)
    return x + sinusoidal_positions(pos, cfg.d_model).to(x.dtype)[None]


def encdec_loss(cfg: ModelConfig, params: EncDec, batch: dict, *, plan=None):
    """batch: {"frames" [B, F, d], "tokens" [B, S], "labels" [B, S],
    "mask" [B, S] (optional)}: the decoder's masked cross entropy over the
    encoded frames, the padded vocabulary's columns masked to -1e30.
    Returns (loss, {"nll"}).  Under ``plan`` (a mesh set) the batch is the
    whole batch on every rank and the loss the global one, as
    ``transformer.lm_loss`` makes it: this rank's rows, the vocab-parallel
    cross entropy, the sums psummed over the batch axes."""
    labels, mask = batch["labels"], batch.get("mask")
    mask = torch.ones(labels.shape, dtype=torch.float32, device=labels.device) \
        if mask is None else mask.float()
    split = T.batch_rows(cfg, plan, labels.shape[0])
    frames, tokens, labels, mask = T.split_batch(
        plan, split, batch["frames"], batch["tokens"], labels, mask)
    memory = encode(cfg, params, frames, plan=plan)
    x = _dec_embed(cfg, params, tokens)
    x, _ = _dec_stack(cfg, params, x, memory, mode="train", plan=plan)
    total, count = nll_sum(cfg, params, x, labels, mask), mask.sum()
    if plan is not None:
        total, count = psum(total, plan.batch_axes), psum(count, plan.batch_axes)
    loss = total / count.clamp_min(1.0)
    return loss, {"nll": loss}


def encdec_prefill(cfg: ModelConfig, params: EncDec, frames: torch.Tensor,
                   tokens: torch.Tensor, *, cache_len: int,
                   kv_len: Optional[torch.Tensor] = None, plan=None):
    """Encode the frames [B, F, d], then run the right-padded decoder
    prompts tokens [B, S] (``kv_len`` [B] valid lengths).  Returns (logits
    [B, Vp] of each row's last valid token, cache).  Under ``plan`` (a mesh
    set) the inputs and logits are the whole batch's on every rank, the
    cache this rank's rows in ``cache_spec``'s layout."""
    split = T.batch_rows(cfg, plan, tokens.shape[0])
    frames, tokens, kv_len = T.split_batch(plan, split, frames, tokens, kv_len)
    memory = encode(cfg, params, frames, plan=plan)
    x = _dec_embed(cfg, params, tokens)
    x, cache = _dec_stack(cfg, params, x, memory, mode="prefill",
                          kv_len=kv_len, cache_len=cache_len, plan=plan)
    logits = lm_head(cfg, params, last_valid(x, kv_len))
    return T.gather_batch(plan, split, logits), cache


def encdec_decode_step(cfg: ModelConfig, params: EncDec, tokens: torch.Tensor,
                       cache: list, kv_len: torch.Tensor, *, plan=None):
    """One decode step.  tokens [B, 1]; kv_len [B] int32, the new token's
    position.  Returns (logits [B, Vp], cache) — the self caches are
    updated in place.  Under ``plan`` tokens, kv_len and logits are the
    whole batch's, the cache this rank's."""
    split = T.batch_rows(cfg, plan, tokens.shape[0])
    tokens, kv_len = T.split_batch(plan, split, tokens, kv_len)
    x = embed_tokens(cfg, params, tokens)
    x = x + sinusoidal_positions(kv_len, cfg.d_model)[:, None].to(x.dtype)
    x, cache = _dec_stack(cfg, params, x, None, mode="decode",
                          cache=cache, kv_len=kv_len, plan=plan)
    return T.gather_batch(plan, split, lm_head(cfg, params, x[:, 0])), cache
