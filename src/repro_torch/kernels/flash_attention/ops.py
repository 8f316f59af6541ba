"""Flash attention: the hand-written CUDA kernel on a CUDA tensor, its plain
PyTorch version on a CPU tensor.  This is the symbol the model layers call.

Replaces the TPU kernel ``flash_attention_pallas``
(``src/repro/kernels/flash_attention/flash_attention.py:92``).  On the H100
prefill attention is bound by operations (2*(D+Dv) per visible
(query, key) pair); the kernel (``csrc/flash_attention.cu``) tiles 64 query
rows x 64 keys per block in shared memory with fp32 FMA micro tiles and
skips KV tiles that the causal diagonal or the window hide — see the source
for the design and what comes next.
"""
from __future__ import annotations

import ctypes
import functools
from typing import Optional

import torch

from repro_torch.kernels import build
from repro_torch.kernels.flash_attention.ref import flash_attention_reference

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
MAX_HEAD_DIM = 256


@functools.cache
def _kernel():
    fn = build.load("flash_attention").flash_attention_fwd
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 9 + [
        ctypes.c_int, ctypes.c_float, ctypes.c_int, ctypes.c_float,
        ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def flash_attention(
    q: torch.Tensor,            # [B, Sq, H, D]
    k: torch.Tensor,            # [B, Skv, KV, D]
    v: torch.Tensor,            # [B, Skv, KV, Dv]
    *,
    causal: bool = True,
    window: Optional[int] = None,
    softcap: Optional[float] = None,
    q_offset: int = 0,
    scale: Optional[float] = None,
) -> torch.Tensor:
    """Attention of every query row over the keys it may see; output
    [B, Sq, H, Dv] in q's dtype."""
    if q.dim() != 4 or k.dim() != 4 or v.dim() != 4:
        raise ValueError("flash_attention: q, k, v must be 4-d [B, S, heads, dim]")
    b, sq, h, d = q.shape
    _, skv, kv, dv = v.shape
    if k.shape != (b, skv, kv, d) or v.shape[0] != b:
        raise ValueError(f"flash_attention: shapes q {tuple(q.shape)} "
                         f"k {tuple(k.shape)} v {tuple(v.shape)} disagree")
    if kv == 0 or h % kv:
        raise ValueError(f"flash_attention: {h} query heads over {kv} KV heads")
    if not q.dtype == k.dtype == v.dtype or q.dtype not in _DTYPES:
        raise TypeError("flash_attention: q, k, v must share dtype float32 "
                        f"or bfloat16, got {q.dtype}, {k.dtype}, {v.dtype}")
    if d > MAX_HEAD_DIM or dv > MAX_HEAD_DIM:
        raise ValueError(f"flash_attention: head dims {d}/{dv} > {MAX_HEAD_DIM}")
    if window is not None and window <= 0:
        raise ValueError(f"flash_attention: window must be > 0, got {window}")
    if softcap is not None and softcap <= 0:
        raise ValueError(f"flash_attention: softcap must be > 0, got {softcap}")
    if q_offset < 0:
        raise ValueError(f"flash_attention: q_offset must be >= 0, got {q_offset}")
    if not q.device == k.device == v.device:
        raise ValueError("flash_attention: q, k, v on different devices")
    if q.device.type == "cpu":
        return flash_attention_reference(q, k, v, causal=causal, window=window,
                                         softcap=softcap, q_offset=q_offset,
                                         scale=scale)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention: no kernel for device {q.device}")
    if not (q.is_contiguous() and k.is_contiguous() and v.is_contiguous()):
        raise ValueError("flash_attention: q, k, v must be contiguous")
    if h > 65535 or b > 65535:
        raise ValueError(f"flash_attention: grid of {h} heads x {b} batch too large")
    scale = scale if scale is not None else d ** -0.5
    out = torch.empty((b, sq, h, dv), dtype=q.dtype, device=q.device)
    if out.numel() == 0:
        return out
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = _kernel()(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                        out.data_ptr(), _DTYPES[q.dtype], b, sq, skv, h, kv,
                        d, dv, int(causal), window or 0, float(softcap or 0.0),
                        q_offset, float(scale), stream)
    if err:
        raise RuntimeError(f"flash_attention kernel launch failed: CUDA error {err}")
    flash_attention.launches += 1
    return out


flash_attention.launches = 0    # kernel launches, read by chip_smoke.py
