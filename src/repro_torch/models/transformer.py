"""Decoder-only LM assembly.  Port of ``repro/models/transformer.py`` for
the attention + dense-MLP block.

The reference stacks layer groups and runs one ``lax.scan``; here the stack
is an ``nn.ModuleList`` of ``n_layers`` blocks run by a Python loop, and the
decode cache is a list with one {"k", "v"} entry per layer.
"""
from __future__ import annotations

import math
from typing import Optional

import torch
from torch import nn

from repro_torch.configs.base import LayerSpec, ModelConfig
from repro_torch.device import resolve_device
from repro_torch.models import attention as attn
from repro_torch.models.common import Norm, apply_norm, softcap
from repro_torch.models.mlp import MLP, mlp_apply


class Block(nn.Module):
    def __init__(self, cfg: ModelConfig, generator: torch.Generator,
                 dtype=torch.float32):
        super().__init__()
        self.norm1 = Norm(cfg, dtype)
        self.norm2 = Norm(cfg, dtype)
        self.mixer = attn.Attention(cfg, generator, dtype)
        self.mlp = MLP(cfg, generator, dtype)
        if cfg.post_block_norms:
            self.norm1_post = Norm(cfg, dtype)
            self.norm2_post = Norm(cfg, dtype)


class Transformer(nn.Module):
    """Parameters of the LM: ``embed.w`` [Vp, d], ``blocks.{i}.*``,
    ``final_norm``, and ``head.w`` [d, Vp] when embeddings are untied."""

    def __init__(self, cfg: ModelConfig, generator: torch.Generator,
                 dtype=torch.float32):
        super().__init__()
        self.cfg = cfg
        g = generator
        self.embed = nn.Module()
        self.embed.w = nn.Parameter(
            (torch.randn(cfg.padded_vocab, cfg.d_model, generator=g)
             * 0.02).to(dtype), requires_grad=False)
        self.final_norm = Norm(cfg, dtype)
        self.blocks = nn.ModuleList(Block(cfg, g, dtype)
                                    for _ in range(cfg.n_layers))
        self.head = None
        if not cfg.tie_embeddings:
            self.head = nn.Module()
            self.head.w = nn.Parameter(
                (torch.randn(cfg.d_model, cfg.padded_vocab, generator=g)
                 * cfg.d_model ** -0.5).to(dtype), requires_grad=False)


def init_params(cfg: ModelConfig, seed: int = 0, dtype=torch.float32,
                device: str | torch.device = "cuda") -> Transformer:
    """Seeded random weights, the reference's shapes and scales, on the
    card unless ``device`` says otherwise.  They are drawn on the CPU and
    then moved, so a seed gives the same weights on every device."""
    device = resolve_device(device)
    gen = torch.Generator().manual_seed(seed)
    return Transformer(cfg, gen, dtype).to(device)


def block_apply(cfg: ModelConfig, spec: LayerSpec, p: Block, x: torch.Tensor,
                *, positions, cache, kv_len, mode: str, cache_len: int):
    """Returns (x, new cache entry or None)."""
    h = apply_norm(cfg, p.norm1, x)
    if mode == "decode":
        mx, c = attn.attn_decode(cfg, spec, p.mixer, h, cache, kv_len)
    else:
        mx, c = attn.attn_prefill(cfg, spec, p.mixer, h, positions=positions,
                                  cache_len=cache_len, kv_len=kv_len)
    if cfg.post_block_norms:
        mx = apply_norm(cfg, p.norm1_post, mx)
    x = x + mx
    my = mlp_apply(cfg, p.mlp, apply_norm(cfg, p.norm2, x))
    if cfg.post_block_norms:
        my = apply_norm(cfg, p.norm2_post, my)
    return x + my, c


def apply_stack(cfg: ModelConfig, params: Transformer, x: torch.Tensor, *,
                positions, mode: str, cache: Optional[list] = None,
                kv_len=None, cache_len: int = 0):
    """Run every block.  Returns (x, new cache list or None)."""
    specs = cfg.layer_plan()
    new_cache = []
    for i, blk in enumerate(params.blocks):
        x, c = block_apply(cfg, specs[i], blk, x, positions=positions,
                           cache=cache[i] if cache is not None else None,
                           kv_len=kv_len, mode=mode, cache_len=cache_len)
        new_cache.append(c)
    return x, (new_cache if any(c is not None for c in new_cache) else None)


def embed_tokens(cfg: ModelConfig, params: Transformer,
                 tokens: torch.Tensor) -> torch.Tensor:
    x = params.embed.w[tokens]
    if cfg.scale_embeddings:
        x = x * math.sqrt(cfg.d_model)
    return x


def lm_head(cfg: ModelConfig, params: Transformer, x: torch.Tensor) -> torch.Tensor:
    w = params.embed.w.T if cfg.tie_embeddings else params.head.w
    return softcap((x @ w).float(), cfg.final_softcap)


def lm_prefill(cfg: ModelConfig, params: Transformer, tokens: torch.Tensor, *,
               cache_len: int, kv_len: Optional[torch.Tensor] = None):
    """Prompt processing.  tokens [B, S]; kv_len [B] valid prompt lengths of
    the right-padded rows.  Returns (logits [B, Vp] of each row's last valid
    token, cache)."""
    b, s = tokens.shape
    x = embed_tokens(cfg, params, tokens)
    positions = torch.arange(s, device=tokens.device)[None, :].expand(b, s)
    x, cache = apply_stack(cfg, params, x, positions=positions, mode="prefill",
                           kv_len=kv_len, cache_len=cache_len)
    x = apply_norm(cfg, params.final_norm, x)
    if kv_len is not None:
        last = x[torch.arange(b, device=x.device), (kv_len - 1).clamp_min(0)]
    else:
        last = x[:, -1]
    return lm_head(cfg, params, last), cache


def lm_decode_step(cfg: ModelConfig, params: Transformer, tokens: torch.Tensor,
                   cache: list, kv_len: torch.Tensor):
    """One decode step.  tokens [B, 1]; kv_len [B] int32 current lengths.
    Returns (logits [B, Vp], cache) — the cache is updated in place."""
    x = embed_tokens(cfg, params, tokens)
    x, cache = apply_stack(cfg, params, x, positions=None, mode="decode",
                           cache=cache, kv_len=kv_len)
    x = apply_norm(cfg, params.final_norm, x)
    return lm_head(cfg, params, x[:, 0]), cache
