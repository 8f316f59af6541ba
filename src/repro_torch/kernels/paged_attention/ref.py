"""Plain PyTorch version of paged attention: gather the block-table view into
a contiguous cache and defer to the decode-attention plain version, one
query position at a time.  Mirrors ``repro/kernels/paged_attention/ref.py``:
the CPU path and the kernel's yardstick on the card."""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels.decode_attention.ref import decode_attention_reference


def gather_pool(pool: torch.Tensor, block_tables: torch.Tensor) -> torch.Tensor:
    """[N, bs, KV, d] pool + [B, nb] table -> contiguous [B, nb*bs, KV, d]."""
    b, nb = block_tables.shape
    _, bs, kv, d = pool.shape
    return pool[block_tables.long()].reshape(b, nb * bs, kv, d)


def paged_decode_attention_reference(
    q: torch.Tensor,             # [B, H, D]  (one new token)
    k_pool: torch.Tensor,        # [N, bs, KV, D]
    v_pool: torch.Tensor,        # [N, bs, KV, Dv]
    block_tables: torch.Tensor,  # [B, nb] int32
    kv_len: torch.Tensor,        # [B] int32 — valid entries incl. the query
    *,
    softcap: Optional[float] = None,
    scale: Optional[float] = None,
) -> torch.Tensor:
    return decode_attention_reference(
        q, gather_pool(k_pool, block_tables), gather_pool(v_pool, block_tables),
        kv_len, softcap=softcap, scale=scale)


def paged_window_attention_reference(
    q: torch.Tensor,             # [B, T, H, D] — the query window
    k_pool: torch.Tensor,        # [N, bs, KV, D]
    v_pool: torch.Tensor,        # [N, bs, KV, Dv]
    block_tables: torch.Tensor,  # [B, nb] int32
    kv_len: torch.Tensor,        # [B] int32 — history length BEFORE the window
    *,
    softcap: Optional[float] = None,
    scale: Optional[float] = None,
) -> torch.Tensor:
    """One single-token decode per window position: position t's K/V sits at
    ``kv_len + t``, so its valid length is ``kv_len + t + 1``."""
    k = gather_pool(k_pool, block_tables)
    v = gather_pool(v_pool, block_tables)
    outs = [decode_attention_reference(q[:, t], k, v, kv_len + t + 1,
                                       softcap=softcap, scale=scale)
            for t in range(q.shape[1])]
    return torch.stack(outs, dim=1)
