"""The port's attention kernels on the CPU: each wrapper runs its plain
PyTorch version, held against the JAX package's Pallas kernel (interpret
mode) and its jnp oracle on the same numpy inputs.  The CUDA kernels
themselves are tested on the card by ``test_torch_cuda.py``."""
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.decode_attention.decode_attention import decode_attention_pallas
from repro.kernels.decode_attention.ref import decode_attention_reference as jax_decode_ref
from repro.kernels.flash_attention.flash_attention import flash_attention_pallas
from repro.kernels.flash_attention.ref import flash_attention_reference as jax_flash_ref
from repro_torch.kernels import build
from repro_torch.kernels.decode_attention import decode_attention
from repro_torch.kernels.flash_attention import flash_attention

TOL = dict(atol=2e-5, rtol=2e-5)      # f32 on both sides: summation order only

FLASH_CASES = [
    # b, sq, skv, h, kv, d, dv, causal, window, softcap, q_offset
    (2, 64, 64, 4, 2, 16, 16, True, None, None, 0),
    (1, 37, 37, 3, 3, 8, 8, True, None, None, 0),
    (2, 64, 64, 4, 4, 16, 16, True, 24, 50.0, 0),
    (1, 1, 96, 4, 2, 16, 16, True, None, None, 95),
    (2, 48, 48, 2, 1, 32, 32, False, None, None, 0),
    (1, 128, 128, 8, 8, 64, 64, True, None, None, 0),
    (2, 33, 65, 4, 2, 16, 16, True, None, None, 32),
    (2, 40, 40, 4, 2, 24, 16, True, None, None, 0),        # D != Dv
    (1, 33, 33, 3, 3, 8, 8, True, None, None, 0),          # ragged edges
]

DECODE_CASES = [
    # b, s, h, kv, d, dv, softcap, window
    (2, 96, 4, 2, 16, 16, None, None),
    (3, 64, 6, 3, 8, 8, 50.0, None),
    (2, 128, 8, 8, 16, 16, None, 40),
    (1, 33, 4, 1, 32, 32, None, None),
    (4, 256, 16, 2, 64, 64, None, None),
    (2, 50, 6, 2, 24, 16, None, None),                     # D != Dv
]


def _flash_inputs(rng, case, dtype=np.float32):
    b, sq, skv, h, kv, d, dv, *_ = case
    return (rng.standard_normal((b, sq, h, d)).astype(dtype),
            rng.standard_normal((b, skv, kv, d)).astype(dtype),
            rng.standard_normal((b, skv, kv, dv)).astype(dtype))


def _flash_kw(case):
    *_, causal, window, cap, qoff = case
    return dict(causal=causal, window=window, softcap=cap, q_offset=qoff)


def _decode_inputs(rng, case):
    b, s, h, kv, d, dv, *_ = case
    return (rng.standard_normal((b, h, d)).astype(np.float32),
            rng.standard_normal((b, s, kv, d)).astype(np.float32),
            rng.standard_normal((b, s, kv, dv)).astype(np.float32),
            rng.integers(1, s + 1, size=b).astype(np.int32))


def _t(*arrays):
    return [torch.from_numpy(a) for a in arrays]


@pytest.mark.parametrize("case", FLASH_CASES)
def test_flash_plain_matches_jax(rng, case):
    q, k, v = _flash_inputs(rng, case)
    kw = _flash_kw(case)
    got = flash_attention(*_t(q, k, v), **kw).numpy()
    pallas = flash_attention_pallas(q, k, v, q_block=16, kv_block=16,
                                    interpret=True, **kw)
    np.testing.assert_allclose(got, np.asarray(pallas), **TOL)
    np.testing.assert_allclose(got, np.asarray(jax_flash_ref(q, k, v, **kw)), **TOL)


def test_flash_plain_bf16_matches_jax(rng):
    q, k, v = _flash_inputs(rng, (2, 64, 64, 4, 2, 32, 32))
    qb, kb, vb = (jnp.asarray(x, jnp.bfloat16) for x in (q, k, v))
    want = np.asarray(jax_flash_ref(qb, kb, vb, causal=True), np.float32)
    tq, tk, tv = (torch.from_numpy(np.asarray(x, np.float32)).bfloat16()
                  for x in (qb, kb, vb))
    got = flash_attention(tq, tk, tv, causal=True)
    assert got.dtype == torch.bfloat16
    # both round an fp32 result to bf16: at most one bf16 ulp apart
    np.testing.assert_allclose(got.float().numpy(), want, atol=1e-2, rtol=1e-2)


@pytest.mark.parametrize("case", DECODE_CASES)
def test_decode_plain_matches_jax(rng, case):
    q, k, v, kv_len = _decode_inputs(rng, case)
    cap, win = case[-2:]
    got = decode_attention(*_t(q, k, v, kv_len), softcap=cap, window=win).numpy()
    pallas = decode_attention_pallas(q, k, v, kv_len, kv_block=16,
                                     interpret=True, softcap=cap, window=win)
    np.testing.assert_allclose(got, np.asarray(pallas), **TOL)
    want = jax_decode_ref(q, k, v, kv_len, softcap=cap, window=win)
    np.testing.assert_allclose(got, np.asarray(want), **TOL)


def test_decode_is_one_row_of_flash(rng):
    """Decode at kv_len = n equals the causal flash row of position n-1."""
    b, s, h, kv, d = 2, 40, 6, 2, 16
    q = rng.standard_normal((b, s, h, d)).astype(np.float32)
    k = rng.standard_normal((b, s, kv, d)).astype(np.float32)
    v = rng.standard_normal((b, s, kv, d)).astype(np.float32)
    full = flash_attention(*_t(q, k, v), causal=True)
    n = 23
    row = decode_attention(torch.from_numpy(q[:, n - 1]), *_t(k, v),
                           torch.full((b,), n, dtype=torch.int32))
    np.testing.assert_allclose(row.numpy(), full[:, n - 1].numpy(), **TOL)


@pytest.mark.parametrize("bad", ["dtype", "shape", "head_dim", "window",
                                 "heads"])
def test_flash_wrapper_rejects(bad):
    q = torch.zeros(1, 4, 4, 16)
    k = v = torch.zeros(1, 4, 2, 16)
    kw = {}
    if bad == "dtype":
        q = q.double()
    elif bad == "shape":
        k = torch.zeros(1, 5, 2, 16)
    elif bad == "head_dim":
        q, k, v = torch.zeros(1, 4, 4, 300), torch.zeros(1, 4, 2, 300), \
            torch.zeros(1, 4, 2, 300)
    elif bad == "window":
        kw["window"] = 0
    else:
        q = torch.zeros(1, 4, 3, 16)
    with pytest.raises((TypeError, ValueError)):
        flash_attention(q, k, v, **kw)


@pytest.mark.parametrize("bad", ["dtype", "kv_len", "head_dim"])
def test_decode_wrapper_rejects(bad):
    q = torch.zeros(2, 4, 16)
    k = v = torch.zeros(2, 8, 2, 16)
    kv_len = torch.ones(2, dtype=torch.int32)
    if bad == "dtype":
        k = v = k.half()
    elif bad == "kv_len":
        kv_len = torch.ones(3, dtype=torch.int32)
    else:
        q, k, v = torch.zeros(2, 4, 512), torch.zeros(2, 8, 2, 512), \
            torch.zeros(2, 8, 2, 512)
    with pytest.raises((TypeError, ValueError)):
        decode_attention(q, k, v, kv_len)


def test_plain_versions_do_not_count_launches():
    """On the CPU no kernel launches, so the launch counters stay put."""
    before = (flash_attention.launches, decode_attention.launches)
    flash_attention(torch.zeros(1, 4, 2, 8), torch.zeros(1, 4, 1, 8),
                    torch.zeros(1, 4, 1, 8))
    decode_attention(torch.zeros(1, 2, 8), torch.zeros(1, 4, 1, 8),
                     torch.zeros(1, 4, 1, 8), torch.ones(1, dtype=torch.int32))
    assert (flash_attention.launches, decode_attention.launches) == before


def test_build_names_libraries_by_source_and_flags(monkeypatch, tmp_path):
    """Libraries live under build/kernels/ of the checkout, named by a hash
    of source and flags, so an edited source builds anew."""
    path = build.library_path("flash_attention")
    assert path.parent == build.BUILD_DIR
    assert path.parent.parent.parent == Path(__file__).resolve().parents[1]
    assert path == build.library_path("flash_attention")
    assert path != build.library_path("decode_attention")
    src = tmp_path / "flash_attention.cu"
    src.write_text((build.CSRC / "flash_attention.cu").read_text() + "\n")
    monkeypatch.setattr(build, "CSRC", tmp_path)
    assert build.library_path("flash_attention").name != path.name

