"""Paged attention: the hand-written CUDA kernel on a CUDA tensor, its plain
PyTorch version on a CPU tensor.  These are the symbols the model layers
call.

Replaces the TPU kernel ``_paged_window_core``
(``src/repro/kernels/paged_attention/paged_attention.py:137``) and its two
entry points: ``paged_decode_attention`` (one query token per sequence, the
continuous-batching decode step) and ``paged_window_attention`` (a window of
T query positions per sequence, the speculative verify step).  Both launch
the same kernel (``csrc/paged_attention.cu``); ``paged_window_attention.launches``
counts the launches of either.  On the H100 it is bound by the bytes of the
valid K/V rows, read through the block table.  The kernel splits each
sequence's logical pages across the blocks of a thread-block cluster
(``paged_splits``: a function of the table width and page size only, so a
row's result never depends on T), stages the pages' rows in shared memory
with ``cp.async``, and merges the blocks' (m, l, acc) partials through
distributed shared memory in the same launch — see the source for the
design.
"""
from __future__ import annotations

import ctypes
import functools
from typing import Optional

import torch

from repro_torch.kernels import build
from repro_torch.kernels.decode_attention.ops import (
    MAX_SPLITS, SPLIT_POSITIONS, check_vector_rows)
from repro_torch.kernels.paged_attention.ref import (
    paged_decode_attention_reference, paged_window_attention_reference)

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
MAX_HEAD_DIM = 256


def paged_splits(nb: int, bs: int) -> tuple[int, int]:
    """(splits, pages per split P) for a table of ``nb`` pages of ``bs``
    positions: ceil(nb * bs / 64) splits clamped to [1, 16], then as many
    as P = ceil(nb / splits) needs, so none is empty; split i covers the
    logical pages [i * P, min((i + 1) * P, nb)).  A function of nb and bs
    only."""
    want = max(1, min(MAX_SPLITS, -(-(nb * bs) // SPLIT_POSITIONS)))
    per = max(1, -(-nb // want))
    return max(1, -(-nb // per)), per


@functools.cache
def _kernel():
    fn = build.load("paged_attention").paged_attention_fwd
    fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 10 + [
        ctypes.c_float, ctypes.c_float, ctypes.c_int, ctypes.c_int,
        ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def _check(name: str, q, k_pool, v_pool, block_tables, kv_len, softcap) -> None:
    """Shape, dtype and device checks common to both entry points; q is
    [B, T, H, D] here."""
    if q.dim() != 4 or k_pool.dim() != 4 or v_pool.dim() != 4 \
            or block_tables.dim() != 2:
        raise ValueError(f"{name}: pools must be [N, bs, KV, dim] and "
                         "block_tables [B, nb]")
    b, _, h, d = q.shape
    n, bs, kv, dv = v_pool.shape
    if k_pool.shape != (n, bs, kv, d) or block_tables.shape[0] != b \
            or kv_len.shape != (b,):
        raise ValueError(f"{name}: shapes q {tuple(q.shape)} k_pool "
                         f"{tuple(k_pool.shape)} v_pool {tuple(v_pool.shape)} "
                         f"block_tables {tuple(block_tables.shape)} kv_len "
                         f"{tuple(kv_len.shape)} disagree")
    if kv == 0 or h % kv:
        raise ValueError(f"{name}: {h} query heads over {kv} KV heads")
    if not q.dtype == k_pool.dtype == v_pool.dtype or q.dtype not in _DTYPES:
        raise TypeError(f"{name}: q and the pools must share dtype float32 or "
                        f"bfloat16, got {q.dtype}, {k_pool.dtype}, {v_pool.dtype}")
    if d > MAX_HEAD_DIM or dv > MAX_HEAD_DIM:
        raise ValueError(f"{name}: head dims {d}/{dv} > {MAX_HEAD_DIM}")
    if softcap is not None and softcap <= 0:
        raise ValueError(f"{name}: softcap must be > 0, got {softcap}")
    if len({t.device for t in (q, k_pool, v_pool, block_tables, kv_len)}) != 1:
        raise ValueError(f"{name}: inputs on different devices")


def _launch(name: str, q, k_pool, v_pool, block_tables, kv_len, offset: int,
            softcap, scale) -> torch.Tensor:
    """The kernel on [B, T, H, D] queries whose row t attends positions
    ``<= kv_len + offset + t``; output [B, T, H, Dv]."""
    if q.device.type != "cuda":
        raise ValueError(f"{name}: no kernel for device {q.device}")
    build.check_no_grad(name, q, k_pool, v_pool)
    if kv_len.dtype != torch.int32 or block_tables.dtype != torch.int32:
        raise TypeError(f"{name}: block_tables and kv_len must be int32, got "
                        f"{block_tables.dtype}, {kv_len.dtype}")
    if not all(t.is_contiguous() for t in (q, k_pool, v_pool, block_tables, kv_len)):
        raise ValueError(f"{name}: q, pools, block_tables, kv_len must be "
                         "contiguous")
    b, t, h, d = q.shape
    _, bs, kv, dv = v_pool.shape
    nb = block_tables.shape[1]
    if kv > 65535 or b > 65535:
        raise ValueError(f"{name}: grid of {kv} KV heads x {b} batch too large")
    check_vector_rows(name, d, dv, k_pool, v_pool)
    scale = scale if scale is not None else d ** -0.5
    out = torch.empty((b, t, h, dv), dtype=q.dtype, device=q.device)
    if out.numel() == 0:
        return out
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = _kernel()(q.data_ptr(), k_pool.data_ptr(), v_pool.data_ptr(),
                        block_tables.data_ptr(), kv_len.data_ptr(),
                        out.data_ptr(), _DTYPES[q.dtype], b, t, h, kv, d, dv,
                        bs, nb, offset, float(softcap or 0.0), float(scale),
                        *paged_splits(nb, bs), stream)
    if err:
        raise RuntimeError(f"{name} kernel launch failed: CUDA error {err}")
    paged_window_attention.launches += 1
    return out


def paged_window_attention(
    q: torch.Tensor,             # [B, T, H, D] — the query window
    k_pool: torch.Tensor,        # [N, bs, KV, D]
    v_pool: torch.Tensor,        # [N, bs, KV, Dv]
    block_tables: torch.Tensor,  # [B, nb] int32
    kv_len: torch.Tensor,        # [B] int32 — history length BEFORE the window
    *,
    softcap: Optional[float] = None,
    scale: Optional[float] = None,
) -> torch.Tensor:
    """Window position t (absolute ``kv_len + t``, its K/V already in the
    pool) attends to positions ``<= kv_len + t``.  Returns [B, T, H, Dv] in
    q's dtype; a row with no valid key is 0."""
    _check("paged_window_attention", q, k_pool, v_pool, block_tables, kv_len,
           softcap)
    if q.device.type == "cpu":
        return paged_window_attention_reference(
            q, k_pool, v_pool, block_tables, kv_len, softcap=softcap,
            scale=scale)
    return _launch("paged_window_attention", q, k_pool, v_pool, block_tables,
                   kv_len, 0, softcap, scale)


def paged_decode_attention(
    q: torch.Tensor,             # [B, H, D]
    k_pool: torch.Tensor,        # [N, bs, KV, D]
    v_pool: torch.Tensor,        # [N, bs, KV, Dv]
    block_tables: torch.Tensor,  # [B, nb] int32
    kv_len: torch.Tensor,        # [B] int32 — valid entries incl. the query
    *,
    softcap: Optional[float] = None,
    scale: Optional[float] = None,
) -> torch.Tensor:
    """Single-token paged decode: the query sits at ``kv_len - 1`` (its K/V
    already in the pool), the T=1 window at base ``kv_len - 1``.  Returns
    [B, H, Dv] in q's dtype."""
    if q.dim() != 3:
        raise ValueError("paged_decode_attention: q must be [B, H, D]")
    _check("paged_decode_attention", q[:, None], k_pool, v_pool, block_tables,
           kv_len, softcap)
    if q.device.type == "cpu":
        return paged_decode_attention_reference(
            q, k_pool, v_pool, block_tables, kv_len, softcap=softcap,
            scale=scale)
    return _launch("paged_decode_attention", q[:, None], k_pool, v_pool,
                   block_tables, kv_len, -1, softcap, scale)[:, 0]


paged_window_attention.launches = 0   # K1 launches of both entry points
