"""Prefix-sharing KV cache: a radix tree over token-block hashes.  Own copy
of ``repro/serving/prefix_cache.py`` (pure Python).

Real MLaaS traffic is massively prefix-redundant (system prompts, few-shot
templates, multi-turn chat).  The paged engine reads every K/V row through a
physical block id, so sharing a prefix across sequences needs **zero kernel
changes** — only a subsystem that decides which blocks are shareable.  That
subsystem is this file:

* ``RadixBlockTree`` — a radix tree whose edges are *whole KV blocks* (a
  tuple of ``block_size`` token ids); a path from the root spells a prompt
  prefix and each node pins the physical block holding that span's K/V.
  Block granularity (vs per-token) keeps the tree O(prompt/block) deep,
  makes every shared unit exactly one allocator object, and means a hit
  discounts admission demand by whole blocks — the same unit
  ``BlockAllocator.can_alloc`` charges.  Nodes may also carry *partial*
  leaves (< block_size tokens): the tail of a finished sequence, shareable
  via copy-on-write.
* ``PrefixCache`` — couples the tree to the refcounted ``BlockAllocator``:
  lookups return sharable physical blocks (``share`` increfs them), inserts
  ``retain`` a live sequence's blocks so they outlive it as *cached*
  (refcount-zero, evictable) entries, and the allocator's ``reclaimer``
  hook evicts least-recently-touched leaves when the pool runs dry.

The tree stores only **full-prefix** paths: a node's K/V is valid iff the
entire chain of ancestor blocks matches, which the radix walk guarantees.
Matches are capped at ``len(prompt) - 1`` tokens so at least one prompt
token is always prefilled — the engine needs its logits to emit the first
output token.
"""
from __future__ import annotations

import heapq
from dataclasses import dataclass, field
from typing import Optional

from repro_torch.serving.kv_cache import BlockAllocator


class RadixNode:
    """One KV block's worth of tokens on the path from the root."""
    __slots__ = ("key", "block", "children", "partials", "parent", "tick")

    def __init__(self, key: tuple, block: Optional[int], parent):
        self.key = key                      # token ids this block holds
        self.block = block                  # physical block id (None: accounting only)
        self.children: dict[tuple, RadixNode] = {}   # full-block edges
        self.partials: list[RadixNode] = []          # partial tail leaves
        self.parent = parent
        self.tick = 0

    @property
    def is_leaf(self) -> bool:
        return not self.children and not self.partials


@dataclass
class PrefixMatch:
    """Result of a tree walk over a prompt."""
    full: list[RadixNode] = field(default_factory=list)  # matched full blocks
    tail: Optional[RadixNode] = None       # matched partial leaf (COW-shared)
    tail_len: int = 0                      # valid tokens in the tail block

    @property
    def hit_tokens(self) -> int:
        return sum(len(n.key) for n in self.full) + self.tail_len

    def blocks(self) -> list[int]:
        out = [n.block for n in self.full]
        if self.tail is not None:
            out.append(self.tail.block)
        return out


class RadixBlockTree:
    """Radix tree over token blocks; standalone (``block=None``) it is a
    pure hit-accounting structure."""

    def __init__(self, block_size: int):
        self.block_size = block_size
        self.root = RadixNode((), None, None)
        self._clock = 0
        self.n_nodes = 0

    def _touch(self, node: RadixNode) -> None:
        self._clock += 1
        node.tick = self._clock

    # ------------------------------------------------------------- lookup
    def match(self, tokens: list, *, max_tokens: Optional[int] = None,
              touch: bool = True) -> PrefixMatch:
        """Longest cached prefix of ``tokens``, at most ``max_tokens`` long
        (default ``len(tokens) - 1``: always leave one token to prefill).
        Full blocks chain first; a partial leaf may extend the match into
        its tail."""
        bs = self.block_size
        limit = len(tokens) - 1 if max_tokens is None else max_tokens
        m = PrefixMatch()
        node, pos = self.root, 0
        while pos + bs <= limit:
            child = node.children.get(tuple(tokens[pos:pos + bs]))
            if child is None:
                break
            m.full.append(child)
            if touch:
                self._touch(child)
            node, pos = child, pos + bs
        best: Optional[RadixNode] = None
        for p in node.partials:
            if len(p.key) <= limit - pos \
                    and p.key == tuple(tokens[pos:pos + len(p.key)]) \
                    and (best is None or len(p.key) > len(best.key)):
                best = p
        if best is not None:
            m.tail, m.tail_len = best, len(best.key)
            if touch:
                self._touch(best)
        return m

    # ------------------------------------------------------------- insert
    def insert(self, tokens: list, blocks: Optional[list] = None,
               n_tokens: Optional[int] = None) -> list[RadixNode]:
        """Register ``tokens[:n_tokens]`` along the chain of ``blocks``.
        Existing nodes win (first writer pins the physical block; duplicate
        physical copies stay private to their sequence).  A non-block-aligned
        remainder becomes a partial leaf.  Returns the *newly created* nodes
        (whose blocks the caller should ``retain``)."""
        bs = self.block_size
        n = len(tokens) if n_tokens is None else n_tokens
        created: list[RadixNode] = []
        node, pos, bi = self.root, 0, 0
        while pos + bs <= n:
            key = tuple(tokens[pos:pos + bs])
            child = node.children.get(key)
            if child is None:
                child = RadixNode(key, None if blocks is None else blocks[bi],
                                  node)
                node.children[key] = child
                self.n_nodes += 1
                created.append(child)
            self._touch(child)
            node, pos, bi = child, pos + bs, bi + 1
        rem = n - pos
        if rem > 0:
            key = tuple(tokens[pos:pos + rem])
            if not any(p.key == key for p in node.partials):
                leaf = RadixNode(key, None if blocks is None else blocks[bi],
                                 node)
                node.partials.append(leaf)
                self.n_nodes += 1
                created.append(leaf)
                self._touch(leaf)
        return created

    # ------------------------------------------------------------- remove
    def remove(self, node: RadixNode) -> None:
        parent = node.parent
        if parent is None:
            return
        if len(node.key) == self.block_size and \
                parent.children.get(node.key) is node:
            del parent.children[node.key]
        elif node in parent.partials:
            parent.partials.remove(node)
        self.n_nodes -= 1

    def iter_nodes(self):
        stack = [self.root]
        while stack:
            n = stack.pop()
            if n is not self.root:
                yield n
            stack.extend(n.children.values())
            stack.extend(n.partials)


@dataclass
class PrefixCacheStats:
    lookups: int = 0
    hits: int = 0                  # lookups matching >= 1 token
    hit_tokens: int = 0            # prefill tokens served from cache
    hit_blocks: int = 0            # full blocks shared (demand discount)
    inserted_blocks: int = 0
    evicted_blocks: int = 0

    @property
    def hit_rate(self) -> float:
        return self.hits / self.lookups if self.lookups else 0.0


class PrefixCache:
    """Radix tree + refcounted allocator = prefix-sharing KV cache.

    Protocol (driven by ``PagedEngine``):

    1. admission probe: ``lookup(tokens, peek=True)`` — how many blocks
       would a hit save?  (``can_admit`` charges demand net of this.)
    2. prefill: ``lookup`` then ``share(seq_id, match)`` increfs the matched
       chain into the sequence's table; the engine prefills only the
       uncached suffix.  A matched *partial* tail is claimed via
       ``BlockAllocator.cow`` before the suffix scatter writes into it.
    3. publish: ``insert(tokens, table, n_tokens)`` retains the sequence's
       full blocks (at prefill: the prompt; at finish: prompt + generated,
       including the partial tail) so they survive ``free_seq`` as cached,
       evictable entries.
    4. pressure: the allocator's ``reclaimer`` hook calls ``evict`` — LRU
       leaves first, cascading upward as children disappear.
    """

    def __init__(self, alloc: BlockAllocator, block_size: int):
        self.alloc = alloc
        self.tree = RadixBlockTree(block_size)
        self.stats = PrefixCacheStats()
        alloc.reclaimer = self.evict

    # ------------------------------------------------------------- lookup
    def lookup(self, tokens: list, *, peek: bool = False,
               partial: bool = True) -> PrefixMatch:
        """``partial=False`` drops a matched tail leaf (hits stay block-
        aligned — PagedEngineConfig.share_partial_tails)."""
        m = self.tree.match(tokens, touch=not peek)
        if not partial:
            m.tail, m.tail_len = None, 0
        if not peek:
            self.stats.lookups += 1
            if m.hit_tokens:
                self.stats.hits += 1
            self.stats.hit_tokens += m.hit_tokens
            self.stats.hit_blocks += len(m.full)
        return m

    def share(self, seq_id: int, m: PrefixMatch) -> None:
        self.alloc.share(seq_id, m.blocks())

    # ------------------------------------------------------------- insert
    def insert(self, tokens: list, blocks: list[int],
               n_tokens: Optional[int] = None) -> int:
        """Publish a sequence's chain.  ``blocks`` is its block table (one
        physical id per block of ``tokens``); only newly created nodes
        retain their block — spans already in the tree keep the original
        owner's block and this sequence's copy stays private."""
        created = self.tree.insert(tokens, blocks, n_tokens)
        for node in created:
            self.alloc.retain(node.block)
        self.stats.inserted_blocks += len(created)
        return len(created)

    # ----------------------------------------------------------- eviction
    def evictable(self) -> int:
        return len(self.alloc.cached)

    def evict(self, n: int) -> int:
        """Free >= n cached blocks, least-recently-touched leaves first
        (an interior node only becomes evictable once its subtree is gone,
        so a hot deep chain keeps its ancestors resident).  One tree walk
        seeds a min-heap of evictable leaves; parents cascade into the heap
        as their subtrees disappear — O(nodes + n log nodes), not a rescan
        per freed block (this runs on the allocation hot path)."""
        heap = [(node.tick, id(node), node)
                for node in self.tree.iter_nodes()
                if node.is_leaf and node.block in self.alloc.cached]
        heapq.heapify(heap)
        freed = 0
        while freed < n and heap:
            _, _, victim = heapq.heappop(heap)
            parent = victim.parent
            self.alloc.release_cached(victim.block)
            self.tree.remove(victim)
            freed += 1
            self.stats.evicted_blocks += 1
            if parent is not self.tree.root and parent is not None \
                    and parent.is_leaf and parent.block in self.alloc.cached:
                heapq.heappush(heap, (parent.tick, id(parent), parent))
        return freed
