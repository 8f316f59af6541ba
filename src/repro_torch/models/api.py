"""Model API of the port: init / train loss / prefill / decode, dispatched
on the family (decoder-only, or encoder-decoder, whose loss and prefill
take the audio stub's frame embeddings), and the paged decode and verify
steps of the decoder-only family (the vision stub's prefill takes
embeddings), and the dry run's input and cache specs.  Port of
``repro/models/api.py``.  ``loss_fn``, ``prefill``, ``decode_step`` and the paged
steps (batch-only plans) take a sharding plan (``models.transformer``'s and
``models.encdec``'s docstrings): ``loss_fn``, ``prefill`` and
``decode_step`` run every family under one, Mamba and RWKV-6 blocks and
encoder-decoder models included."""
from __future__ import annotations

import torch

from repro_torch.configs.base import ModelConfig, ShapeConfig
from repro_torch.device import resolve_device
from repro_torch.models import encdec as E
from repro_torch.models import transformer as T
from repro_torch.models.encdec import EncDec
from repro_torch.models.transformer import Transformer


def init_params(cfg: ModelConfig, seed: int = 0, dtype=torch.float32,
                device: str | torch.device = "cuda",
                generator_device: str | torch.device = "cpu"
                ) -> Transformer | EncDec:
    """Seeded weights on ``device``, drawn by a generator on
    ``generator_device`` (the CPU: the same weights on every device)."""
    if cfg.is_encdec:
        return E.init_params(cfg, seed, dtype, device, generator_device)
    return T.init_params(cfg, seed, dtype, device, generator_device)


def loss_fn(cfg: ModelConfig, params: Transformer | EncDec, batch: dict, *,
            plan=None):
    """The training loss and its metrics; autograd runs through it (no
    ``inference_mode``).  batch: {"tokens", "labels", "mask"} (+ "frames"
    for an encoder-decoder, + "embeds" for the vision stub).  Under
    ``plan`` (a mesh set) the batch is the whole batch on every rank, and
    the loss and metrics are the global ones on every rank."""
    if cfg.is_encdec:
        return E.encdec_loss(cfg, params, batch, plan=plan)
    return T.lm_loss(cfg, params, batch, plan=plan)


@torch.inference_mode()
def prefill(cfg: ModelConfig, params: Transformer | EncDec, batch: dict, *,
            cache_len: int, kv_len=None, prefix_kv=None, plan=None):
    """batch: {"tokens": [B, S]} (+ "embeds" [B, S, d] for the vision
    stub, used in place of the token embeddings; + "frames" [B, F, d], the
    audio stub's frame embeddings, which an encoder-decoder needs).
    Returns (logits [B, Vp], cache).  ``prefix_kv`` (per-layer K/V of an
    already computed prompt prefix) requests continuation prefill of the
    uncached suffix — see T.lm_prefill.  Under ``plan`` (a mesh set) the
    batch and logits are whole on every rank, the cache this rank's."""
    if cfg.is_encdec:
        if prefix_kv is not None:
            raise NotImplementedError(
                "prefix-continuation prefill: enc-dec uses cross caches")
        return E.encdec_prefill(cfg, params, batch["frames"], batch["tokens"],
                                cache_len=cache_len, kv_len=kv_len, plan=plan)
    return T.lm_prefill(cfg, params, batch["tokens"], cache_len=cache_len,
                        kv_len=kv_len, embeds=batch.get("embeds"),
                        prefix_kv=prefix_kv, plan=plan)


@torch.inference_mode()
def decode_step(cfg: ModelConfig, params: Transformer | EncDec, tokens, cache,
                kv_len, *, plan=None):
    """tokens [B, 1]; kv_len [B] int32.  Returns (logits [B, Vp], cache)."""
    if cfg.is_encdec:
        return E.encdec_decode_step(cfg, params, tokens, cache, kv_len,
                                    plan=plan)
    return T.lm_decode_step(cfg, params, tokens, cache, kv_len, plan=plan)


@torch.inference_mode()
def paged_decode_step(cfg: ModelConfig, params: Transformer, tokens, pools,
                      block_tables, kv_len, *, plan=None):
    """Decode one token per sequence against the paged pools (updated in
    place).  tokens [B, 1]; block_tables [B, nb] int32; kv_len [B] int32.
    Returns (logits [B, Vp], pools).  Under a batch-only ``plan`` (a mesh
    set) the inputs and logits are the whole batch's and every rank holds
    the whole pools (``T.lm_paged_decode_step``); model and sequence axes
    raise, as in the reference."""
    if cfg.is_encdec:
        raise NotImplementedError("paged decode: enc-dec uses cross caches")
    return T.lm_paged_decode_step(cfg, params, tokens, pools, block_tables,
                                  kv_len, plan=plan)


@torch.inference_mode()
def paged_spec_step(cfg: ModelConfig, params: Transformer, tokens, pools,
                    block_tables, kv_len, blk, off, *, plan=None):
    """Speculative-verification step: score T tokens per sequence (the
    current input token plus T-1 drafts) against the paged pools in one
    pass.  tokens [B, T]; blk/off [B, T] scatter targets (the null block
    where a position is invalid); kv_len [B] history before the window.
    Returns (logits [B, T, Vp], pools).  ``plan`` as in
    ``paged_decode_step``."""
    if cfg.is_encdec:
        raise NotImplementedError("paged decode: enc-dec uses cross caches")
    return T.lm_paged_spec_step(cfg, params, tokens, pools, block_tables,
                                kv_len, blk, off, plan=plan)


def paged_compatible(cfg: ModelConfig) -> tuple[bool, str]:
    """Whether the architecture's decode cache can live in paged KV blocks:
    every mixer a full-attention GQA layer (no MLA latents, no
    sliding-window ring buffers, no mamba or rwkv recurrent state, no
    enc-dec cross cache), whatever its MLP (dense or MoE)."""
    if cfg.is_encdec:
        return False, "enc-dec cross-attention cache is not paged"
    if cfg.mla is not None:
        return False, "MLA decodes from the compressed latent cache"
    for spec in cfg.layer_plan():
        if spec.mixer != "attn":
            return False, f"{spec.mixer} state is recurrent, not a KV cache"
        if spec.attn == "window" and cfg.sliding_window:
            return False, "sliding-window layers use the ring cache"
    return True, ""


def init_paged_pools(cfg: ModelConfig, n_blocks: int, block_size: int,
                     dtype=torch.float32, device: str | torch.device = "cuda"
                     ) -> list[dict]:
    """Zeroed paged K/V pools, one {"k": [n_blocks, bs, KV, hd], "v": ...}
    per layer: the physical (n_blocks, block_size) axes every sequence
    shares, in the place of the decode cache's per-sequence (B, S)."""
    ok, why = paged_compatible(cfg)
    if not ok:
        raise ValueError(f"{cfg.name}: {why}")
    device = resolve_device(device)
    kv, hd, dv = cfg.n_kv_heads, cfg.head_dim_eff, cfg.v_head_dim_eff
    return [{"k": torch.zeros((n_blocks, block_size, kv, hd), dtype=dtype,
                              device=device),
             "v": torch.zeros((n_blocks, block_size, kv, dv), dtype=dtype,
                              device=device)}
            for _ in range(cfg.n_layers)]


# ----------------------------------------------------------------- dry-run IO

def _frames_len(cfg: ModelConfig, shape: ShapeConfig) -> int:
    """The audio stub's frames of a cell: seq_len for train and prefill,
    the fixed ``cross_kv_len`` memory for decode
    (``repro/models/api.py:122``)."""
    return shape.seq_len if shape.kind != "decode" else cfg.cross_kv_len


def _dec_prompt_len(cfg: ModelConfig, shape: ShapeConfig) -> int:
    """An encoder-decoder prefill's decoder prompt: seq_len / 8, at least
    8 (``repro/models/api.py:128``)."""
    return max(shape.seq_len // 8, 8)


def _meta(shape, dtype) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, device="meta")


def input_specs(cfg: ModelConfig, shape: ShapeConfig,
                dtype=torch.bfloat16) -> dict:
    """Meta tensors of every model input of the (arch x shape) cell, with
    the reference's shapes and dtypes (``repro/models/api.py:133``):
    train {"batch": {tokens, labels, mask} (+ frames / embeds)}; prefill
    {"batch": {tokens} (+ frames / embeds), "kv_len"}; decode {"tokens"
    [B, 1], "cache" (``cache_specs``), "kv_len"}."""
    b, s = shape.global_batch, shape.seq_len
    i32 = torch.int32
    if shape.kind == "train":
        batch = {"tokens": _meta((b, s), i32), "labels": _meta((b, s), i32),
                 "mask": _meta((b, s), torch.float32)}
        if cfg.is_encdec:
            batch["frames"] = _meta((b, _frames_len(cfg, shape), cfg.d_model),
                                    dtype)
        if cfg.frontend == "vision_stub":
            batch["embeds"] = _meta((b, s, cfg.d_model), dtype)
        return {"batch": batch}
    if shape.kind == "prefill":
        if cfg.is_encdec:
            batch = {"frames": _meta((b, _frames_len(cfg, shape), cfg.d_model),
                                     dtype),
                     "tokens": _meta((b, _dec_prompt_len(cfg, shape)), i32)}
        elif cfg.frontend == "vision_stub":
            batch = {"tokens": _meta((b, s), i32),
                     "embeds": _meta((b, s, cfg.d_model), dtype)}
        else:
            batch = {"tokens": _meta((b, s), i32)}
        return {"batch": batch, "kv_len": _meta((b,), i32)}
    return {"tokens": _meta((b, 1), i32),
            "cache": cache_specs(cfg, b, s, dtype=dtype),
            "kv_len": _meta((b,), i32)}


def cache_specs(cfg: ModelConfig, b: int, s_max: int,
                dtype=torch.bfloat16) -> list[dict]:
    """The decode cache of ``b`` sequences of capacity ``s_max`` as meta
    tensors, in the port's layout (one entry a layer, ``models.
    transformer``'s docstring) with the reference's shapes and dtypes
    (``repro/models/api.py:165``, its stacked leading dimension dropped):
    a window layer's ring holds the window, Mamba's ``ssm`` and RWKV-6's
    ``state`` are f32."""
    kv, hd, dv = cfg.n_kv_heads, cfg.head_dim_eff, cfg.v_head_dim_eff
    f32 = torch.float32

    def attn_entry(spec) -> dict:
        if cfg.mla is not None:
            m = cfg.mla
            return {"c_kv": _meta((b, s_max, m.kv_lora_rank), dtype),
                    "k_rope": _meta((b, s_max, m.qk_rope_head_dim), dtype)}
        ln = s_max
        if spec.attn == "window" and cfg.sliding_window \
                and cfg.sliding_window < s_max:
            ln = cfg.sliding_window
        return {"k": _meta((b, ln, kv, hd), dtype),
                "v": _meta((b, ln, kv, dv), dtype)}

    if cfg.is_encdec:
        return [{"self": attn_entry(cfg.layer_plan()[0]),
                 "cross": {"ck": _meta((b, cfg.cross_kv_len, kv, hd), dtype),
                           "cv": _meta((b, cfg.cross_kv_len, kv, dv), dtype)}}
                for _ in range(cfg.n_layers)]
    out = []
    for spec in cfg.layer_plan():
        if spec.mixer == "attn":
            out.append(attn_entry(spec))
        elif spec.mixer == "mamba":
            mc = cfg.mamba
            d_in = mc.expand * cfg.d_model
            out.append({"conv": _meta((b, mc.d_conv - 1, d_in), dtype),
                        "ssm": _meta((b, d_in, mc.d_state), f32)})
        else:
            rc = cfg.rwkv
            h = cfg.d_model // rc.head_size
            out.append({"shift": _meta((b, cfg.d_model), dtype),
                        "state": _meta((b, h, rc.head_size, rc.head_size), f32),
                        "cm_shift": _meta((b, cfg.d_model), dtype)})
    return out
