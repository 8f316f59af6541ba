"""Token sampling for the serving engine.  Port of the greedy sampler of
``repro/serving/sampling.py``."""
from __future__ import annotations

import torch


def greedy(logits: torch.Tensor, vocab_size: int) -> torch.Tensor:
    """logits [B, Vp] -> [B] int32 token ids, restricted to the real vocab
    (padded ids >= vocab_size are masked before the argmax)."""
    ids = torch.arange(logits.shape[-1], device=logits.device)
    masked = logits.masked_fill(ids >= vocab_size, float("-inf"))
    return masked.argmax(-1).to(torch.int32)
