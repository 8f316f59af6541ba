"""Model API of the port: init / prefill / decode for the decoder-only
family.  Port of ``repro/models/api.py`` (the encoder-decoder dispatch, the
paged steps and the dry-run specs come with their slices)."""
from __future__ import annotations

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import transformer as T
from repro_torch.models.transformer import Transformer


def init_params(cfg: ModelConfig, seed: int = 0, dtype=torch.float32,
                device: str | torch.device = "cuda") -> Transformer:
    return T.init_params(cfg, seed, dtype, device)


@torch.inference_mode()
def prefill(cfg: ModelConfig, params: Transformer, batch: dict, *,
            cache_len: int, kv_len=None, prefix_kv=None):
    """batch: {"tokens": [B, S]}.  Returns (logits [B, Vp], cache)."""
    if prefix_kv is not None:
        raise NotImplementedError(
            "prefix-continuation prefill is not ported yet (paged-engine slice)")
    return T.lm_prefill(cfg, params, batch["tokens"], cache_len=cache_len,
                        kv_len=kv_len)


@torch.inference_mode()
def decode_step(cfg: ModelConfig, params: Transformer, tokens, cache, kv_len):
    """tokens [B, 1]; kv_len [B] int32.  Returns (logits [B, Vp], cache)."""
    return T.lm_decode_step(cfg, params, tokens, cache, kv_len)
