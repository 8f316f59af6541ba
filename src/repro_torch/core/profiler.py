"""Resource profiler (paper §4.1): output-length prediction and resource
profiling.

Port of ``repro/core/profiler.py``.  ``LengthPredictor`` is a tiny bucket
classifier (token embedding -> mean+max pool -> 2-layer MLP -> bucket
logits) over S³-style log-spaced length buckets, fitted offline with a
hand-rolled Adam and updated online with one SGD step per mispredicted
request (the monitor's feedback).  Gradients come from ``torch.autograd``.

``ResourceProfiler.profile`` attaches the predicted bucket/length and the
KV-cache byte estimate (the paper §1 cost model via ModelConfig).
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch
from torch import nn

from repro_torch.configs.base import ModelConfig
from repro_torch.core.types import Request
from repro_torch.device import resolve_device


def make_buckets(n_buckets: int, max_len: int) -> np.ndarray:
    """Upper edges, log-spaced: [.., max_len]."""
    return np.unique(np.round(np.logspace(
        np.log10(8), np.log10(max_len), n_buckets)).astype(int))


@dataclass
class PredictorConfig:
    vocab: int = 1024
    d: int = 64
    n_buckets: int = 10
    max_len: int = 1024
    lr: float = 3e-3
    online_lr: float = 1e-3


class PredictorNet(nn.Module):
    """Embedding -> masked mean+max pool -> relu MLP -> bucket logits."""

    def __init__(self, vocab: int, d: int, n_buckets: int,
                 generator: torch.Generator):
        super().__init__()
        g = generator
        self.embed = nn.Parameter(torch.randn(vocab, d, generator=g) * 0.1)
        self.w1 = nn.Parameter(torch.randn(2 * d, 2 * d, generator=g)
                               * (2 * d) ** -0.5)
        self.b1 = nn.Parameter(torch.zeros(2 * d))
        self.w2 = nn.Parameter(torch.randn(2 * d, n_buckets, generator=g)
                               * (2 * d) ** -0.5)
        self.b2 = nn.Parameter(torch.zeros(n_buckets))

    def forward(self, toks: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
        emb = self.embed[toks] * mask[..., None]           # [B, S, d]
        denom = mask.sum(-1, keepdim=True).clamp_min(1.0)
        mean = emb.sum(1) / denom
        mx = (emb + (mask[..., None] - 1.0) * 1e9).amax(dim=1)
        h = torch.relu(torch.cat([mean, mx], -1) @ self.w1 + self.b1)
        return h @ self.w2 + self.b2


class LengthPredictor:
    """Conservative length estimate = the predicted bucket's upper edge (S³).

    ``device`` defaults to the card; tests pass ``device="cpu"``.  The
    weights are drawn on the CPU from ``seed`` and then moved, so a seed
    gives the same predictor on every device."""

    def __init__(self, cfg: PredictorConfig = PredictorConfig(), seed: int = 0,
                 *, device: str | torch.device = "cuda"):
        self.cfg = cfg
        self.device = resolve_device(device)
        self.buckets = make_buckets(cfg.n_buckets, cfg.max_len)
        gen = torch.Generator().manual_seed(seed)
        self.net = PredictorNet(cfg.vocab, cfg.d, len(self.buckets),
                                gen).to(self.device)
        self.opt_m = {n: torch.zeros_like(p)
                      for n, p in self.net.named_parameters()}
        self.opt_v = {n: torch.zeros_like(p)
                      for n, p in self.net.named_parameters()}
        self._step = 0

    # ------------------------------------------------------------- model fns
    def _tensors(self, toks: np.ndarray):
        toks = torch.as_tensor(np.asarray(toks) % self.cfg.vocab,
                               dtype=torch.long, device=self.device)
        return toks, (toks > 0).float()

    def _loss(self, toks, mask, labels) -> torch.Tensor:
        logp = torch.log_softmax(self.net(toks, mask), -1)
        return -logp.gather(1, labels[:, None]).mean()

    def _grads(self, toks, mask, labels) -> dict[str, torch.Tensor]:
        names, params = zip(*self.net.named_parameters())
        grads = torch.autograd.grad(self._loss(toks, mask, labels), params)
        return dict(zip(names, grads))

    def length_to_bucket(self, lens) -> np.ndarray:
        return np.searchsorted(self.buckets, np.asarray(lens), side="left").clip(
            0, len(self.buckets) - 1)

    @torch.no_grad()
    def _adam_step(self, grads: dict[str, torch.Tensor], lr: float) -> None:
        self._step += 1
        b1, b2, eps = 0.9, 0.999, 1e-8
        t = self._step
        for n, p in self.net.named_parameters():
            g = grads[n]
            m = self.opt_m[n].mul_(b1).add_((1 - b1) * g)
            v = self.opt_v[n].mul_(b2).add_((1 - b2) * g * g)
            mh = m / (1 - b1 ** t)
            vh = v / (1 - b2 ** t)
            p.sub_(lr * mh / (torch.sqrt(vh) + eps))

    # --------------------------------------------------------------- training
    def fit(self, toks: np.ndarray, lens: np.ndarray, *, epochs: int = 30,
            batch: int = 64, seed: int = 0) -> float:
        """Offline fine-tuning phase.  Returns final train accuracy."""
        labels = torch.as_tensor(self.length_to_bucket(lens), dtype=torch.long,
                                 device=self.device)
        toks_t, mask = self._tensors(toks)
        n = toks_t.shape[0]
        rng = np.random.default_rng(seed)
        for _ in range(epochs):
            order = rng.permutation(n)
            for i in range(0, n, batch):
                idx = torch.as_tensor(order[i:i + batch], device=self.device)
                self._adam_step(self._grads(toks_t[idx], mask[idx],
                                            labels[idx]), self.cfg.lr)
        return self.accuracy(toks, lens)

    @torch.no_grad()
    def accuracy(self, toks, lens) -> float:
        t, mask = self._tensors(toks)
        pred = self.net(t, mask).argmax(-1).cpu().numpy()
        return float((pred == self.length_to_bucket(lens)).mean())

    @staticmethod
    def _pad_rows(rows: list) -> np.ndarray:
        """Zero-pad token rows to the next power-of-two length (>= 8), as
        the reference does; padding is masked out, so logits are unchanged."""
        n = max(1, max(len(r) for r in rows))
        p = 8
        while p < n:
            p *= 2
        toks = np.zeros((len(rows), p), np.int32)
        for i, r in enumerate(rows):
            toks[i, :len(r)] = np.asarray(r, np.int32)
        return toks

    # ----------------------------------------------------------------- online
    def online_update(self, tokens: list[int], true_len: int) -> None:
        """One SGD step on a mispredicted request (backend monitor feedback)."""
        toks, mask = self._tensors(self._pad_rows([tokens]))
        label = torch.as_tensor(self.length_to_bucket([true_len]),
                                dtype=torch.long, device=self.device)
        grads = self._grads(toks, mask, label)
        with torch.no_grad():
            for n, p in self.net.named_parameters():
                p.sub_(self.cfg.online_lr * grads[n])

    # ---------------------------------------------------------------- predict
    @torch.no_grad()
    def predict(self, tokens: list[int]) -> tuple[int, int]:
        toks, mask = self._tensors(self._pad_rows([tokens]))
        b = int(self.net(toks, mask).argmax(-1)[0])
        return b, int(self.buckets[b])

    @torch.no_grad()
    def predict_batch(self, requests: list[Request]) -> None:
        if not requests:
            return
        toks, mask = self._tensors(self._pad_rows(
            [r.tokens[:r.input_len] for r in requests]))
        pred = self.net(toks, mask).argmax(-1).cpu().numpy()
        for r, b in zip(requests, pred):
            r.predicted_bucket = int(b)
            r.predicted_output_len = int(self.buckets[int(b)])


class ResourceProfiler:
    """Profiler front door: prediction + SLO intake + resource estimation."""

    def __init__(self, predictor: LengthPredictor, model_cfg: ModelConfig,
                 memory_adjust: float = 1.0):
        self.predictor = predictor
        self.model_cfg = model_cfg
        self.memory_adjust = memory_adjust      # tuned online by the monitor

    def profile(self, requests: list[Request]) -> list[Request]:
        self.predictor.predict_batch(requests)
        for r in requests:
            total = r.input_len + r.predicted_output_len
            r.kv_bytes_estimate = self.model_cfg.kv_cache_bytes(1, total) \
                * self.memory_adjust
        return requests
