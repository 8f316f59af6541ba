"""Speculative decoding: drafters proposing K tokens per engine iteration.
Own copy of ``repro/serving/speculative.py``.

A drafter proposes K cheap candidate tokens, the target model scores all K+1
positions in one verify pass (``kernels.paged_attention.
paged_window_attention``), and the engine accepts the longest prefix of
drafts that match the target's own greedy choices — so the emitted stream
is the sequential greedy stream and speculation is a latency lever only.

* ``NGramDrafter`` — prompt-lookup decoding (deterministic, model-free):
  the continuation of the most recent earlier occurrence of the current
  trailing n-gram in (prompt + generated).
* ``ModelDrafter`` — a small draft LM proposing greedy continuations with
  the port's ``api.prefill`` / ``api.decode_step``.
"""
from __future__ import annotations

from typing import Protocol, runtime_checkable

import torch

from repro_torch.models import api
from repro_torch.serving.sampling import greedy


@runtime_checkable
class Drafter(Protocol):
    """Proposes up to ``k`` draft tokens to verify in one engine iteration.

    ``history`` is the full token stream so far (prompt + generated, the
    engine's pending input token last).  The proposal is a list of 0..k
    token ids; ``release`` is called when a slot's sequence finishes or is
    preempted."""

    name: str

    def propose(self, slot: int, history: list, k: int) -> list: ...

    def release(self, slot: int) -> None: ...


class NGramDrafter:
    """Prompt-lookup decoding: match the trailing ``n``-gram (longest first)
    against earlier history and propose the tokens that followed its most
    recent occurrence.  Stateless and deterministic."""

    name = "ngram"

    def __init__(self, max_ngram: int = 3, min_ngram: int = 1):
        if min_ngram < 1 or max_ngram < min_ngram:
            raise ValueError(f"bad ngram range [{min_ngram}, {max_ngram}]")
        self.max_ngram = max_ngram
        self.min_ngram = min_ngram

    def propose(self, slot: int, history: list, k: int) -> list:
        ln = len(history)
        for n in range(self.max_ngram, self.min_ngram - 1, -1):
            if ln < n + 1:
                continue
            tail = history[-n:]
            # most recent earlier occurrence with a non-empty continuation
            for i in range(ln - n - 1, -1, -1):
                if history[i:i + n] == tail:
                    # read the continuation cyclically with period p (the
                    # match distance), so a sequence looping with period p
                    # extends through the loop instead of stopping at p
                    p = ln - n - i
                    return [history[i + n + (j % p)] for j in range(k)]
        return []

    def release(self, slot: int) -> None:
        pass


class ModelDrafter:
    """Greedy draft proposals from a small LM (its own parameters and a
    contiguous cache, on the device its parameters live on).  Each proposal
    prefills the slot's history and decodes ``k`` greedy tokens: O(history)
    work per iteration, fine for draft models much smaller than the
    target."""

    name = "model"

    def __init__(self, cfg, params, *, max_len: int = 1024):
        self.cfg = cfg
        self.params = params
        self.max_len = max_len
        self.device = params.embed.w.device

    def propose(self, slot: int, history: list, k: int) -> list:
        hist = history[-self.max_len:]
        ln = len(hist)
        if ln == 0 or k <= 0:
            return []
        toks = torch.tensor([[t % self.cfg.vocab_size for t in hist]],
                            dtype=torch.long, device=self.device)
        kv_len = torch.tensor([ln], dtype=torch.int32, device=self.device)
        logits, cache = api.prefill(self.cfg, self.params, {"tokens": toks},
                                    cache_len=ln + k, kv_len=kv_len)
        out: list = []
        for _ in range(k):
            tok = greedy(logits, self.cfg.vocab_size)
            out.append(int(tok[0]))
            if len(out) == k:
                break
            logits, cache = api.decode_step(self.cfg, self.params,
                                            tok[:, None].long(), cache, kv_len)
            kv_len = kv_len + 1
        return out

    def release(self, slot: int) -> None:
        pass


def get_drafter(name: str, *, draft_cfg=None, draft_params=None) -> Drafter:
    """Factory behind ``serve.py --drafter`` / ``PagedEngine``.  A model
    drafter without ``draft_params`` gets seeded random weights (seed 7) on
    the card."""
    if name == "ngram":
        return NGramDrafter()
    if name == "model":
        if draft_cfg is None:
            raise ValueError("model drafter needs draft_cfg (+ params)")
        if draft_params is None:
            draft_params = api.init_params(draft_cfg, seed=7)
        return ModelDrafter(draft_cfg, draft_params)
    raise ValueError(f"unknown drafter {name!r} (ngram | model)")
