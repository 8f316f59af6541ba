"""The WKV6 op: the hand-written CUDA kernel on a CUDA tensor, its plain
PyTorch version (``wkv6_chunked``) on a CPU tensor.  This is the symbol the
RWKV-6 prefill calls; the decode step is the torch op ``wkv6_step``.

Replaces the TPU kernel ``wkv6_pallas`` (``src/repro/kernels/wkv6/wkv6.py:70``)
and, since it also takes an initial state, the whole ``wkv6`` op of
``repro/kernels/wkv6/ops.py``.  On the H100 the function is bound by the
bytes of r, k, v, w and out; the kernel (``csrc/wkv6.cu``) serves each
(batch, head) with a cluster of 4 blocks that split the value columns,
carries each block's columns of the state in shared memory across the
chunks, and builds the intra-chunk matrix from the pairwise log-space decay
once a cluster, shared through distributed shared memory — see the source
for the design.  One launch a call.

On ``meta`` tensors (the dry run) the wrapper checks its inputs as for the
card, raises under grad as there, and returns the output and final state
of the kernel's shapes and dtypes on ``meta``, counted in ``meta_calls``;
nothing is launched and no plain version runs.
"""
from __future__ import annotations

import ctypes
import functools
from typing import Optional

import torch

from repro_torch.kernels import build
from repro_torch.kernels.wkv6.ref import wkv6_chunked

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
MAX_CHUNK = 32
MAX_HEAD_DIM = 128


@functools.cache
def _kernel():
    fn = build.load("wkv6").wkv6_fwd
    fn.argtypes = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 7 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def wkv6(
    r: torch.Tensor,            # [B, T, H, D]
    k: torch.Tensor,            # [B, T, H, D]
    v: torch.Tensor,            # [B, T, H, Dv]
    w: torch.Tensor,            # [B, T, H, D] decay in (0, 1)
    u: torch.Tensor,            # [H, D] bonus
    s0: Optional[torch.Tensor] = None,   # [B, H, D, Dv] initial state
    *,
    chunk: int = 32,
) -> tuple[torch.Tensor, torch.Tensor]:
    """The WKV recurrence over T positions from ``s0`` (zeros if None).
    Returns (out [B, T, H, Dv] in r's dtype, final state [B, H, D, Dv]
    f32).  w is clipped to [1e-12, 1] before its log, as in the
    reference."""
    if r.dim() != 4 or v.dim() != 4:
        raise ValueError("wkv6: r, k, w must be [B, T, H, D] and v [B, T, H, Dv]")
    b, t, h, d = r.shape
    dv = v.shape[-1]
    if k.shape != r.shape or w.shape != r.shape or v.shape[:3] != (b, t, h) \
            or u.shape != (h, d) \
            or (s0 is not None and s0.shape != (b, h, d, dv)):
        raise ValueError(
            f"wkv6: shapes r {tuple(r.shape)} k {tuple(k.shape)} v "
            f"{tuple(v.shape)} w {tuple(w.shape)} u {tuple(u.shape)} s0 "
            f"{None if s0 is None else tuple(s0.shape)} disagree")
    if t == 0:
        raise ValueError("wkv6: T must be > 0")
    if chunk < 1:
        raise ValueError(f"wkv6: chunk must be >= 1, got {chunk}")
    if not r.dtype == k.dtype == v.dtype or r.dtype not in _DTYPES:
        raise TypeError("wkv6: r, k, v must share dtype float32 or bfloat16, "
                        f"got {r.dtype}, {k.dtype}, {v.dtype}")
    rest = (w, u) if s0 is None else (w, u, s0)
    if not all(x.is_floating_point() for x in rest):
        raise TypeError("wkv6: w, u and s0 must be floating point")
    if any(x.device != r.device for x in (k, v) + rest):
        raise ValueError("wkv6: r, k, v, w, u, s0 on different devices")
    if r.device.type == "cpu":
        return wkv6_chunked(r, k, v, w, u, s0, chunk=chunk)
    if r.device.type not in ("cuda", "meta"):
        raise ValueError(f"wkv6: no kernel for device {r.device}")
    build.check_no_grad("wkv6", r, k, v, w, u,
                        *(() if s0 is None else (s0,)))
    if chunk > MAX_CHUNK:
        raise ValueError(f"wkv6: chunk {chunk} > {MAX_CHUNK}")
    if d > MAX_HEAD_DIM or dv > MAX_HEAD_DIM:
        raise ValueError(f"wkv6: head dims {d}/{dv} > {MAX_HEAD_DIM}")
    if b > 65535:
        raise ValueError(f"wkv6: batch {b} too large for the grid")
    # the kernel reads w, u and s0 as float32 (no-ops for f32 inputs)
    w, u = w.float(), u.float()
    s0 = s0.float() if s0 is not None else None
    if not all(x.is_contiguous() for x in (r, k, v, w, u)
               + (() if s0 is None else (s0,))):
        raise ValueError("wkv6: r, k, v, w, u, s0 must be contiguous")
    out = torch.empty((b, t, h, dv), dtype=r.dtype, device=r.device)
    state = torch.empty((b, h, d, dv), dtype=torch.float32, device=r.device)
    if r.device.type == "meta":
        wkv6.meta_calls += 1
        return out, state
    with torch.cuda.device(r.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = _kernel()(r.data_ptr(), k.data_ptr(), v.data_ptr(), w.data_ptr(),
                        u.data_ptr(), s0.data_ptr() if s0 is not None else None,
                        out.data_ptr(), state.data_ptr(), _DTYPES[r.dtype],
                        b, t, h, d, dv, min(chunk, t), stream)
    if err:
        raise RuntimeError(f"wkv6 kernel launch failed: CUDA error {err}")
    wkv6.launches += 1
    return out, state


wkv6.launches = 0   # kernel launches, read by chip_smoke.py
wkv6.meta_calls = 0  # calls on meta tensors (no launch)
