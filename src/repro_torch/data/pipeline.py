"""Training data pipeline: deterministic, shardable, restartable.  The
port's own copy of ``repro/data/pipeline.py`` (numpy only), which gives
the same arrays.

* ``ByteTokenizer`` — dependency-free byte-level tokenizer (vocab 256 + pad),
  the stand-in for a production SentencePiece vocab.
* ``PackedDataset`` — documents tokenized, concatenated with EOS, and packed
  into fixed-length rows (no padding waste), with next-token labels and a
  loss mask that blanks cross-document boundaries.
* ``ShardedLoader`` — per-host slicing for multi-host training: host h of H
  takes batch rows [h·B/H, (h+1)·B/H) of a deterministic global shuffle
  keyed by (seed, epoch, step).  A restart at step k reproduces the exact
  stream (checkpoint stores only `step`).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Iterator, Sequence

import numpy as np


class ByteTokenizer:
    vocab_size = 258          # 256 bytes + BOS + EOS
    bos_id = 256
    eos_id = 257

    def encode(self, text: str) -> list[int]:
        return [self.bos_id] + list(text.encode("utf-8")) + [self.eos_id]

    def decode(self, ids: Sequence[int]) -> str:
        return bytes(i for i in ids if i < 256).decode("utf-8", "replace")


@dataclass
class PackedDataset:
    """Fixed-length packed rows from a document stream."""
    rows: np.ndarray          # [N, seq+1] int32
    boundary_mask: np.ndarray  # [N, seq] float32 — 0 where label crosses docs

    @classmethod
    def from_documents(cls, docs: Sequence[str], seq_len: int,
                       tokenizer: ByteTokenizer | None = None) -> "PackedDataset":
        tok = tokenizer or ByteTokenizer()
        stream: list[int] = []
        for d in docs:
            stream.extend(tok.encode(d))
        n = max(len(stream) - 1, 0) // seq_len
        if n == 0:
            raise ValueError("not enough tokens to build one packed row")
        arr = np.asarray(stream[:n * seq_len + 1], np.int32)
        rows = np.stack([arr[i * seq_len:(i + 1) * seq_len + 1]
                         for i in range(n)])
        labels = rows[:, 1:]
        mask = (labels != tok.bos_id).astype(np.float32)
        return cls(rows=rows, boundary_mask=mask)

    def __len__(self):
        return self.rows.shape[0]


@dataclass
class ShardedLoader:
    dataset: PackedDataset
    global_batch: int
    host_id: int = 0
    n_hosts: int = 1
    seed: int = 0

    def __post_init__(self):
        assert self.global_batch % self.n_hosts == 0
        self.local_batch = self.global_batch // self.n_hosts

    def _order(self, epoch: int) -> np.ndarray:
        rng = np.random.default_rng((self.seed, epoch))
        return rng.permutation(len(self.dataset))

    def batch_at(self, step: int) -> dict:
        """Deterministic batch for a global step (restart-safe)."""
        per_epoch = max(len(self.dataset) // self.global_batch, 1)
        epoch, idx = divmod(step, per_epoch)
        order = self._order(epoch)
        lo = idx * self.global_batch + self.host_id * self.local_batch
        sel = order[(lo + np.arange(self.local_batch)) % len(self.dataset)]
        rows = self.dataset.rows[sel]
        return {"tokens": rows[:, :-1],
                "labels": rows[:, 1:],
                "mask": self.dataset.boundary_mask[sel]}

    def __iter__(self) -> Iterator[dict]:
        step = 0
        while True:
            yield self.batch_at(step)
            step += 1
