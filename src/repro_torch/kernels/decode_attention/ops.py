"""Decode attention: the hand-written CUDA flash-decoding kernel on a CUDA
tensor, its plain PyTorch version on a CPU tensor.  This is the symbol the
model layers call.

Replaces the TPU kernel ``decode_attention_pallas``
(``src/repro/kernels/decode_attention/decode_attention.py:75``).  On the
H100 one-token decode is bound by the bytes of the valid K/V rows; the
kernel (``csrc/decode_attention.cu``) reads each valid row once, with one
block per (batch, KV head) whose rows are the query heads of the group and
whose warps split the valid range — see the source for the design and what
comes next.
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


@functools.cache
def _kernel():
    fn = build.load("decode_attention").decode_attention_fwd
    fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 8 + [
        ctypes.c_float, ctypes.c_float, ctypes.c_void_p]
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
    if q.device.type != "cuda":
        raise ValueError(f"decode_attention: no kernel for device {q.device}")
    if kv_len.dtype != torch.int32:
        raise TypeError(f"decode_attention: kv_len must be int32, got {kv_len.dtype}")
    if not all(t.is_contiguous() for t in (q, k, v, kv_len)):
        raise ValueError("decode_attention: q, k, v, kv_len must be contiguous")
    if kv > 65535 or b > 65535:
        raise ValueError(f"decode_attention: grid of {kv} KV heads x {b} "
                         "batch too large")
    scale = scale if scale is not None else d ** -0.5
    out = torch.empty((b, h, dv), dtype=q.dtype, device=q.device)
    if out.numel() == 0:
        return out
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = _kernel()(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                        kv_len.data_ptr(), out.data_ptr(), _DTYPES[q.dtype],
                        b, s, h, kv, d, dv, window or 0, float(softcap or 0.0),
                        float(scale), stream)
    if err:
        raise RuntimeError(f"decode_attention kernel launch failed: CUDA error {err}")
    decode_attention.launches += 1
    return out


decode_attention.launches = 0   # kernel launches, read by chip_smoke.py
