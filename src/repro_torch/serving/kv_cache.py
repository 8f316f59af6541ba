"""Paged KV-cache manager: the host-side block allocator and a device-side
paged layout.  Own copy of ``repro/serving/kv_cache.py`` (plus
``kv_block_bytes`` of ``repro/serving/paged_engine.py``) on torch tensors.

* the pool is ``[n_blocks, block, KV, hd]`` per layer;
* each sequence references an ordered block list (the block table); blocks
  are **refcounted**, so a prompt prefix can be one physical block shared by
  many tables (serving.prefix_cache drives sharing + copy-on-write forks);
* allocation is O(1) from a free list; freeing a finished sequence drops
  references — blocks the prefix tree retains stay resident as evictable
  cache, the rest return to the free list.

The paged engine (serving.paged_engine) keeps its pools itself and reads
them through the paged-attention kernel; ``PagedKVCache`` is the one-layer
standalone form, with ``gather`` for a sequence's contiguous view.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.device import resolve_device


def kv_block_bytes(cfg: ModelConfig, block_size: int,
                   dtype_bytes: int = 4) -> int:
    """Bytes one physical block costs across all layers (K + V)."""
    per_tok = cfg.n_layers * cfg.n_kv_heads * \
        (cfg.head_dim_eff + cfg.v_head_dim_eff) * dtype_bytes
    return block_size * per_tok


@dataclass
class PagedKVConfig:
    n_blocks: int
    block_size: int = 16
    n_kv_heads: int = 1
    head_dim: int = 64
    dtype: torch.dtype = torch.float32


class BlockAllocator:
    """O(1) free-list allocator with per-**block** refcounts and per-sequence
    block tables.

    Ownership is refcount-based so one physical block can back the same
    prefix of several sequences at once (serving.prefix_cache):

    * ``alloc``   — pop fresh blocks from the free list (refcount 1);
    * ``share``   — add an existing block to another sequence's table
      (refcount +1, revives cached blocks);
    * ``cow``     — copy-on-write fork: a sequence about to *write* a block
      it does not exclusively own swaps in a fresh block (the caller copies
      the device contents);
    * ``free_seq``— idempotent; drops one reference per table entry.  A block
      reaching refcount zero returns to the free list — unless the prefix
      tree has ``retain``-ed it, in which case it parks in ``cached``
      (evictable) until the registered ``reclaimer`` evicts it LRU-first
      when the pool runs dry.
    """

    def __init__(self, n_blocks: int):
        self.n_blocks = n_blocks
        self.free: list[int] = list(range(n_blocks - 1, -1, -1))
        self.tables: dict[int, list[int]] = {}
        self.refcnt: dict[int, int] = {}
        self.retained: set[int] = set()    # blocks the prefix tree holds onto
        self.cached: set[int] = set()      # retained blocks with refcount 0
        self.reclaimer = None              # Callable[[int], int]: evict >= n

    # ---------------------------------------------------------- allocation
    @property
    def available(self) -> int:
        """Blocks obtainable right now: free plus evictable-cached."""
        return len(self.free) + (len(self.cached) if self.reclaimer else 0)

    def can_alloc(self, n: int) -> bool:
        return self.available >= n

    def _replenish(self, n: int) -> None:
        if len(self.free) < n and self.reclaimer is not None:
            self.reclaimer(n - len(self.free))

    def start_seq(self, seq_id: int) -> None:
        """Open a sequence's table; raises if the seq id is already live (a
        slot-recycling bug would otherwise silently merge two sequences)."""
        if seq_id in self.tables:
            raise ValueError(f"seq {seq_id} is already live")
        self.tables[seq_id] = []

    def alloc(self, seq_id: int, n: int = 1) -> list[int]:
        self._replenish(n)
        if len(self.free) < n:
            raise MemoryError("KV pool exhausted")
        blocks = [self.free.pop() for _ in range(n)]
        for b in blocks:
            self.refcnt[b] = 1
        self.tables.setdefault(seq_id, []).extend(blocks)
        return blocks

    def share(self, seq_id: int, blocks: list[int]) -> None:
        """Reference existing blocks from ``seq_id``'s table (prefix hits)."""
        for b in blocks:
            self.refcnt[b] = self.refcnt.get(b, 0) + 1
            self.cached.discard(b)
        self.tables.setdefault(seq_id, []).extend(blocks)

    def cow(self, seq_id: int, block: int) -> int:
        """Make ``block`` writable for ``seq_id``: if exclusively owned and
        not retained by the prefix tree, it is returned unchanged; otherwise
        a fresh block is swapped into the table (refcount of the shared one
        drops) and returned — the caller must copy the device contents."""
        if self.refcnt.get(block, 0) == 1 and block not in self.retained:
            return block
        self._replenish(1)
        if not self.free:
            raise MemoryError("KV pool exhausted (copy-on-write)")
        new = self.free.pop()
        self.refcnt[new] = 1
        t = self.tables[seq_id]
        t[t.index(block)] = new
        self._decref(block)
        return new

    # ------------------------------------------------------------ release
    def _decref(self, block: int) -> None:
        rc = self.refcnt.get(block, 0) - 1
        if rc > 0:
            self.refcnt[block] = rc
            return
        self.refcnt.pop(block, None)
        if block in self.retained:
            self.cached.add(block)
        else:
            self.free.append(block)

    def free_seq(self, seq_id: int) -> int:
        """Drop all of a sequence's references.  Idempotent: freeing a seq
        that is not live is a no-op returning 0."""
        blocks = self.tables.pop(seq_id, [])
        for b in blocks:
            self._decref(b)
        return len(blocks)

    def truncate(self, seq_id: int, n_blocks: int) -> int:
        """Drop a sequence's trailing table entries beyond ``n_blocks``
        (speculative-rejection rollback: the verify step grows the table to
        the full draft window up front; rejected tail blocks come back
        here).  Each dropped entry releases one reference through the same
        path as ``free_seq`` — a shared block survives under its other
        owners, a prefix-tree-retained block parks in ``cached`` — so
        rollback can never double-free or leak.  Returns entries dropped."""
        table = self.tables.get(seq_id, [])
        dropped = table[n_blocks:]
        if not dropped:
            return 0
        del table[n_blocks:]
        for b in dropped:
            self._decref(b)
        return len(dropped)

    # ------------------------------------------- prefix-tree cooperation
    def retain(self, block: int) -> None:
        """Mark a block as held by the prefix tree: at refcount zero it is
        parked in ``cached`` instead of returning to the free list."""
        self.retained.add(block)
        if self.refcnt.get(block, 0) == 0:
            self.cached.add(block)

    def release_cached(self, block: int) -> None:
        """Evict a cached block back to the free list (prefix-tree LRU)."""
        self.cached.discard(block)
        self.retained.discard(block)
        if self.refcnt.get(block, 0) == 0:
            self.free.append(block)

    # -------------------------------------------------------------- stats
    @property
    def used_blocks(self) -> int:
        """Distinct physical blocks referenced by live sequences."""
        return len(self.refcnt)

    def stats(self) -> dict:
        return {"total": self.n_blocks, "free": len(self.free),
                "used": self.used_blocks, "cached": len(self.cached)}

    def check(self, expect_used: Optional[int] = None) -> list[str]:
        """Leak audit: every physical block must be in exactly one of
        {free, referenced, cached}, per-table reference counts must agree
        with ``refcnt`` exactly, and no refcount may be non-positive.  With
        ``expect_used`` the audit also pins the number of live blocks (an
        engine that freed every slot should be down to its null block).
        Returns human-readable violations (empty = clean) so abort/crash
        paths can be gated on *proven* zero leakage, not absence of a
        MemoryError."""
        errs = []
        free_set = set(self.free)
        if len(free_set) != len(self.free):
            errs.append("free list contains duplicate blocks")
        referenced = set(self.refcnt)
        for name, a, b in (("free/referenced", free_set, referenced),
                           ("free/cached", free_set, self.cached),
                           ("referenced/cached", referenced, self.cached)):
            both = a & b
            if both:
                errs.append(f"blocks in both {name}: {sorted(both)}")
        union = free_set | referenced | self.cached
        missing = set(range(self.n_blocks)) - union
        if missing:
            errs.append(f"leaked blocks (in no set): {sorted(missing)}")
        extra = union - set(range(self.n_blocks))
        if extra:
            errs.append(f"unknown block ids: {sorted(extra)}")
        counts: dict[int, int] = {}
        for seq, table in self.tables.items():
            for b in table:
                counts[b] = counts.get(b, 0) + 1
        if counts != self.refcnt:
            errs.append(f"refcnt {self.refcnt} != table-derived {counts}")
        bad_rc = {b: rc for b, rc in self.refcnt.items() if rc <= 0}
        if bad_rc:
            errs.append(f"non-positive refcounts: {bad_rc}")
        if expect_used is not None and len(self.refcnt) != expect_used:
            errs.append(f"expected {expect_used} live blocks, "
                        f"found {len(self.refcnt)}: {sorted(self.refcnt)}")
        return errs


class PagedKVCache:
    """One layer's paged K/V pool + the allocator bookkeeping, on ``device``
    (the card unless the caller passes ``device="cpu"``)."""

    def __init__(self, cfg: PagedKVConfig, device="cuda"):
        self.cfg = cfg
        device = resolve_device(device)
        shape = (cfg.n_blocks, cfg.block_size, cfg.n_kv_heads, cfg.head_dim)
        self.k = torch.zeros(shape, dtype=cfg.dtype, device=device)
        self.v = torch.zeros(shape, dtype=cfg.dtype, device=device)
        self.alloc = BlockAllocator(cfg.n_blocks)
        self.lengths: dict[int, int] = {}

    def ensure_capacity(self, seq_id: int, new_len: int) -> None:
        bs = self.cfg.block_size
        have = len(self.alloc.tables.get(seq_id, [])) * bs
        need = new_len - have
        if need > 0:
            self.alloc.alloc(seq_id, -(-need // bs))

    def append(self, seq_id: int, k_new: torch.Tensor, v_new: torch.Tensor):
        """k_new/v_new: [T, KV, hd] appended at the sequence tail — one
        in-place scatter over (block, offset) index arrays."""
        t = k_new.shape[0]
        pos = self.lengths.get(seq_id, 0)
        self.ensure_capacity(seq_id, pos + t)
        bs = self.cfg.block_size
        table = np.asarray(self.alloc.tables[seq_id], np.int64)
        p = pos + np.arange(t)
        blk = torch.as_tensor(table[p // bs], device=self.k.device)
        off = torch.as_tensor(p % bs, device=self.k.device)
        self.k[blk, off] = k_new.to(self.k)
        self.v[blk, off] = v_new.to(self.v)
        self.lengths[seq_id] = pos + t

    def gather(self, seq_id: int) -> tuple[torch.Tensor, torch.Tensor, int]:
        """Contiguous [L, KV, hd] view of a sequence."""
        ln = self.lengths.get(seq_id, 0)
        idx = torch.as_tensor(self.alloc.tables.get(seq_id, []),
                              dtype=torch.long, device=self.k.device)
        shape = (-1, self.cfg.n_kv_heads, self.cfg.head_dim)
        return (self.k[idx].reshape(shape)[:ln],
                self.v[idx].reshape(shape)[:ln], ln)

    def release(self, seq_id: int) -> None:
        self.alloc.free_seq(seq_id)
        self.lengths.pop(seq_id, None)
