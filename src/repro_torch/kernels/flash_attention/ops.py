"""Flash attention: the hand-written CUDA kernel on a CUDA tensor, its plain
PyTorch version on a CPU tensor.  This is the symbol the model layers call.

Replaces the TPU kernel ``flash_attention_pallas``
(``src/repro/kernels/flash_attention/flash_attention.py:92``).  On the H100
prefill attention is bound by operations (2*(D+Dv) per visible
(query, key) pair).  The kernel (``csrc/flash_attention.cu``) computes both
products on the tensor cores at fp32 accuracy (3xTF32 ``mma.sync``) for
D = Dv = 64 and 128, with the query heads of one KV head in one block and
K/V staged through a ``cp.async`` ring; other head dims, and K/V off a
16-byte boundary, take its general fp32 FMA instance.  See the source for
the design and what comes next.

On CUDA inputs that require grad (grad enabled), the launch is the forward
of an ``autograd.Function`` whose backward is ``flash_attention_grad``, in
torch ops, as the reference's gradient is XLA's autodiff outside any
Pallas kernel; on CPU tensors autograd runs through the plain version.
Under ``no_grad`` or ``inference_mode`` the kernel is launched alone.

On ``meta`` tensors (the dry run, ``launch.dryrun``) the wrapper checks its
inputs as for the card and returns an output of the kernel's shape and
dtype on ``meta``: nothing is launched and no plain version runs; the call
is counted in ``meta_calls`` (``launches`` does not move).  Under grad the
``autograd.Function`` is the same as on the card, so its backward runs
``flash_attention_grad`` on meta tensors (counted in
``meta_backward_calls``).  Dispatch is on the device alone: ``cpu`` runs
the plain version, ``cuda`` the kernel, ``meta`` gives shapes, any other
device raises.
"""
from __future__ import annotations

import ctypes
import functools
from typing import Optional

import torch

from repro_torch.kernels import build
from repro_torch.kernels.flash_attention.grad import flash_attention_grad
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
    if q.device.type not in ("cuda", "meta"):
        raise ValueError(f"flash_attention: no kernel for device {q.device}")
    if not (q.is_contiguous() and k.is_contiguous() and v.is_contiguous()):
        raise ValueError("flash_attention: q, k, v must be contiguous")
    if h > 65535 or b > 65535:
        raise ValueError(f"flash_attention: grid of {h} heads x {b} batch too large")
    opts = (causal, window, softcap, q_offset,
            scale if scale is not None else d ** -0.5)
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad
                                    or v.requires_grad):
        return _FlashAttention.apply(q, k, v, *opts)
    return _launch(q, k, v, *opts)


def _launch(q, k, v, causal, window, softcap, q_offset, scale) -> torch.Tensor:
    """One launch of the kernel on checked CUDA tensors; on meta tensors
    the output's shape alone."""
    b, sq, h, d = q.shape
    _, skv, kv, dv = v.shape
    out = torch.empty((b, sq, h, dv), dtype=q.dtype, device=q.device)
    if q.device.type == "meta":
        flash_attention.meta_calls += 1
        return out
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


class _FlashAttention(torch.autograd.Function):
    """The kernel's forward with ``flash_attention_grad`` as its backward,
    for CUDA (or meta) inputs that require grad."""

    @staticmethod
    def forward(ctx, q, k, v, causal, window, softcap, q_offset, scale):
        out = _launch(q, k, v, causal, window, softcap, q_offset, scale)
        ctx.save_for_backward(q, k, v, out)
        ctx.opts = dict(causal=causal, window=window, softcap=softcap,
                        q_offset=q_offset, scale=scale)
        return out

    @staticmethod
    def backward(ctx, do):
        if do.device.type == "meta":
            flash_attention.meta_backward_calls += 1
        else:
            flash_attention.backward_calls += 1
        grads = flash_attention_grad(*ctx.saved_tensors, do, **ctx.opts)
        return (*grads, None, None, None, None, None)


flash_attention.launches = 0         # kernel launches, read by chip_smoke.py
flash_attention.backward_calls = 0   # backwards of kernel launches
flash_attention.meta_calls = 0       # calls on meta tensors (no launch)
flash_attention.meta_backward_calls = 0   # their backwards
