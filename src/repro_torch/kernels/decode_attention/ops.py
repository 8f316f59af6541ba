"""Decode attention: the hand-written CUDA flash-decoding kernel on a CUDA
tensor, its plain PyTorch version on a CPU tensor.  This is the symbol the
model layers call.

Replaces the TPU kernel ``decode_attention_pallas``
(``src/repro/kernels/decode_attention/decode_attention.py:75``).  On the
H100 one-token decode is bound by the bytes of the valid K/V rows and, at
decode sizes, by how many of them are in flight.  The kernel
(``csrc/decode_attention.cu``) splits each sequence's valid range across
the blocks of a thread-block cluster (``decode_splits`` of them, from the
cache's capacity alone, so the host never reads ``kv_len``), stages K/V
tiles in shared memory with ``cp.async``, and merges the blocks' (m, l,
acc) partials through distributed shared memory in the same launch — see
the source for the design.

On ``meta`` tensors (the dry run) the wrapper checks its inputs as for the
card, raises under grad as there, and returns an output of the kernel's
shape and dtype on ``meta``, counted in ``meta_calls``; nothing is launched
and no plain version runs.
"""
from __future__ import annotations

import ctypes
import functools
from typing import Optional

import torch

from repro_torch.kernels import build
from repro_torch.kernels.decode_attention.ref import decode_attention_reference

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
MAX_HEAD_DIM = 256
SPLIT_POSITIONS = 64    # cache positions a split is sized for
MAX_SPLITS = 16         # blocks of one cluster (above 8: non-portable size)


def decode_splits(s: int) -> int:
    """Blocks that share one (batch, KV head, row chunk): ceil(S / 64)
    clamped to [1, 16].  A function of the cache's capacity S only: the
    valid lengths live on the card and reading them would synchronise."""
    return max(1, min(MAX_SPLITS, -(-s // SPLIT_POSITIONS)))


def check_vector_rows(name: str, d: int, dv: int, *pools: torch.Tensor) -> None:
    """The kernels copy K/V rows in 16-byte pieces: rows of D and Dv
    elements must be whole pieces and the K/V tensors 16-byte aligned."""
    size = pools[0].element_size()
    if (d * size) % 16 or (dv * size) % 16:
        raise ValueError(f"{name}: head dims {d}/{dv} of {pools[0].dtype} are "
                         "not a multiple of 16 bytes")
    if any(t.data_ptr() % 16 for t in pools):
        raise ValueError(f"{name}: K/V must be 16-byte aligned")


@functools.cache
def _kernel():
    fn = build.load("decode_attention").decode_attention_fwd
    fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 8 + [
        ctypes.c_float, ctypes.c_float, ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def decode_attention(
    q: torch.Tensor,            # [B, H, D]
    k: torch.Tensor,            # [B, S, KV, D]
    v: torch.Tensor,            # [B, S, KV, Dv]
    kv_len: torch.Tensor,       # [B] int32
    *,
    softcap: Optional[float] = None,
    window: Optional[int] = None,
    scale: Optional[float] = None,
) -> torch.Tensor:
    """Attention of one query token per sequence over its first ``kv_len``
    cache entries; output [B, H, Dv] in q's dtype."""
    if q.dim() != 3 or k.dim() != 4 or v.dim() != 4:
        raise ValueError("decode_attention: q must be [B, H, D] and k, v "
                         "[B, S, KV, dim]")
    b, h, d = q.shape
    _, s, kv, dv = v.shape
    if k.shape != (b, s, kv, d) or v.shape[0] != b or kv_len.shape != (b,):
        raise ValueError(f"decode_attention: shapes q {tuple(q.shape)} k "
                         f"{tuple(k.shape)} v {tuple(v.shape)} kv_len "
                         f"{tuple(kv_len.shape)} disagree")
    if kv == 0 or h % kv:
        raise ValueError(f"decode_attention: {h} query heads over {kv} KV heads")
    if not q.dtype == k.dtype == v.dtype or q.dtype not in _DTYPES:
        raise TypeError("decode_attention: q, k, v must share dtype float32 "
                        f"or bfloat16, got {q.dtype}, {k.dtype}, {v.dtype}")
    if d > MAX_HEAD_DIM or dv > MAX_HEAD_DIM:
        raise ValueError(f"decode_attention: head dims {d}/{dv} > {MAX_HEAD_DIM}")
    if window is not None and window <= 0:
        raise ValueError(f"decode_attention: window must be > 0, got {window}")
    if softcap is not None and softcap <= 0:
        raise ValueError(f"decode_attention: softcap must be > 0, got {softcap}")
    if not q.device == k.device == v.device == kv_len.device:
        raise ValueError("decode_attention: q, k, v, kv_len on different devices")
    if q.device.type == "cpu":
        return decode_attention_reference(q, k, v, kv_len, softcap=softcap,
                                          window=window, scale=scale)
    if q.device.type not in ("cuda", "meta"):
        raise ValueError(f"decode_attention: no kernel for device {q.device}")
    build.check_no_grad("decode_attention", q, k, v)
    if kv_len.dtype != torch.int32:
        raise TypeError(f"decode_attention: kv_len must be int32, got {kv_len.dtype}")
    if not all(t.is_contiguous() for t in (q, k, v, kv_len)):
        raise ValueError("decode_attention: q, k, v, kv_len must be contiguous")
    if kv > 65535 or b > 65535:
        raise ValueError(f"decode_attention: grid of {kv} KV heads x {b} "
                         "batch too large")
    check_vector_rows("decode_attention", d, dv, k, v)
    scale = scale if scale is not None else d ** -0.5
    out = torch.empty((b, h, dv), dtype=q.dtype, device=q.device)
    if q.device.type == "meta":
        decode_attention.meta_calls += 1
        return out
    if out.numel() == 0:
        return out
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = _kernel()(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                        kv_len.data_ptr(), out.data_ptr(), _DTYPES[q.dtype],
                        b, s, h, kv, d, dv, window or 0, float(softcap or 0.0),
                        float(scale), decode_splits(s), stream)
    if err:
        raise RuntimeError(f"decode_attention kernel launch failed: CUDA error {err}")
    decode_attention.launches += 1
    return out


decode_attention.launches = 0   # kernel launches, read by chip_smoke.py
decode_attention.meta_calls = 0  # calls on meta tensors (no launch)
