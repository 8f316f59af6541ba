"""Inference engine of the port.  Port of ``repro/serving/engine.py``.

Two batching modes:

* ``run_batch`` — the paper's semantics (§4.2): a batch is prefilled
  together, right-padded to the max prompt, decoded until every sequence
  emits EOS or hits its budget.  This is what SLO-ODBS composes batches for.
* ``run_continuous`` — beyond-paper mode: fixed decode slots; finished
  sequences free their slot, which is refilled from the queue between steps
  (per-slot kv_len, right-padded prefill per admission wave).

Both drive the same prefill and decode ops, so both run the same two
attention kernels.  The decode step writes the KV cache in place.
"""
from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Optional

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core.types import Batch, Request
from repro_torch.models import api
from repro_torch.models.transformer import Transformer
from repro_torch.serving.sampling import greedy


@dataclass
class EngineConfig:
    max_batch: int = 8
    cache_len: int = 256
    max_new_tokens: int = 128
    eos_id: int = 1


@dataclass
class BatchResult:
    outputs: dict[int, list[int]] = field(default_factory=dict)   # rid -> tokens
    prefill_s: float = 0.0
    decode_s: float = 0.0
    steps: int = 0


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


class InferenceEngine:
    """Serves on the device its parameters live on."""

    def __init__(self, cfg: ModelConfig, params: Transformer,
                 engine_cfg: EngineConfig):
        self.cfg = cfg
        self.params = params
        self.ecfg = engine_cfg
        self.device = params.embed.w.device

    def _prefill(self, toks, kv_len):
        return api.prefill(self.cfg, self.params, {"tokens": toks},
                           cache_len=self.ecfg.cache_len, kv_len=kv_len)

    def _decode(self, toks, cache, kv_len):
        return api.decode_step(self.cfg, self.params, toks, cache, kv_len)

    def _pad_prompts(self, prompts: list[list[int]]):
        """Right-padded token rows [B, S] and their lengths [B] (int32)."""
        s = max(len(p) for p in prompts)
        toks = np.zeros((len(prompts), s), np.int32)
        for i, p in enumerate(prompts):
            toks[i, :len(p)] = p
        kv_len = np.array([len(p) for p in prompts], np.int32)
        return (torch.as_tensor(toks, dtype=torch.long, device=self.device),
                torch.as_tensor(kv_len, device=self.device))

    # ----------------------------------------------------------------- padded
    def run_batch(self, batch: Batch, *, max_new: Optional[int] = None,
                  true_lens: Optional[dict[int, int]] = None) -> BatchResult:
        """Paper-mode execution of one scheduled batch.  When ``true_lens``
        is given (simulation of EOS), sequence i stops after that many new
        tokens; otherwise EOS/eos_id or the budget stops it."""
        prompts = [r.tokens for r in batch.requests]
        rids = [r.rid for r in batch.requests]
        res = BatchResult()
        toks, kv_len = self._pad_prompts(prompts)
        t0 = time.perf_counter()
        logits, cache = self._prefill(toks, kv_len)
        _sync(self.device)
        res.prefill_s = time.perf_counter() - t0

        b = len(prompts)
        budget = max_new or self.ecfg.max_new_tokens
        stop_at = np.array([min(true_lens.get(r, budget), budget) if true_lens
                            else budget for r in rids])
        outs = [[] for _ in range(b)]
        done = np.zeros(b, bool)
        t0 = time.perf_counter()
        step = 0
        while not done.all() and step < budget:
            nxt = greedy(logits, self.cfg.vocab_size)
            nxt_np = nxt.cpu().numpy()
            for i in range(b):
                if not done[i]:
                    outs[i].append(int(nxt_np[i]))
                    if len(outs[i]) >= stop_at[i] or \
                            (true_lens is None and nxt_np[i] == self.ecfg.eos_id):
                        done[i] = True
            logits, cache = self._decode(nxt[:, None].long(), cache,
                                         kv_len + step)
            step += 1
        _sync(self.device)
        res.decode_s = time.perf_counter() - t0
        res.steps = step
        res.outputs = dict(zip(rids, outs))
        return res

    # ------------------------------------------------------------- continuous
    def run_continuous(self, requests: list[Request], *,
                       max_new: Optional[int] = None) -> BatchResult:
        """Beyond-paper continuous batching: B slots, refilled on completion.
        Prompts are (re)prefilled per admission wave into their slots."""
        res = BatchResult()
        queue = list(requests)
        b = self.ecfg.max_batch
        budget = max_new or self.ecfg.max_new_tokens
        active: list[Optional[Request]] = [None] * b
        outs: dict[int, list[int]] = {}
        cache = kv_len = logits = None
        t0 = time.perf_counter()

        def admit():
            nonlocal cache, kv_len, logits
            newly = []
            for i in range(b):
                if active[i] is None and queue:
                    active[i] = queue.pop(0)
                    newly.append(i)
            if not newly:
                return
            # re-prefill the whole slot set (simple wave admission); slots
            # already decoding carry their generated tokens into the prompt so
            # their state is reconstructed exactly
            prompts = []
            for i in range(b):
                r = active[i]
                prompts.append([0] if r is None
                               else list(r.tokens) + outs.get(r.rid, []))
            toks, kv_len = self._pad_prompts(prompts)
            logits, cache = self._prefill(toks, kv_len)

        admit()
        steps = 0
        while any(a is not None for a in active):
            nxt = greedy(logits, self.cfg.vocab_size)
            nxt_np = nxt.cpu().numpy()
            freed = False
            for i in range(b):
                r = active[i]
                if r is None:
                    continue
                outs.setdefault(r.rid, []).append(int(nxt_np[i]))
                if len(outs[r.rid]) >= min(r.true_output_len, budget):
                    active[i] = None
                    freed = True
            logits, cache = self._decode(nxt[:, None].long(), cache, kv_len)
            kv_len = kv_len + 1
            steps += 1
            if freed and queue:
                admit()
        _sync(self.device)
        res.decode_s = time.perf_counter() - t0
        res.steps = steps
        res.outputs = outs
        return res
