"""The port's CUDA kernels on the card: each against its plain PyTorch
version on the same CUDA tensors, f32 and bf16, and the engine on the card
against the engine on the CPU.  Imports no JAX, so it runs where only
PyTorch is installed:

    PYTHONPATH=src python -m pytest -q tests/test_torch_cuda.py

Every test needs an NVIDIA GPU and skips without one."""
import copy
import dataclasses

import pytest
import torch

from repro_torch.configs import get_config
from repro_torch.core.types import Batch, Request
from repro_torch.kernels.decode_attention import (decode_attention,
                                                  decode_attention_reference)
from repro_torch.kernels.flash_attention import (flash_attention,
                                                 flash_attention_reference)
from repro_torch.kernels.paged_attention import (
    paged_decode_attention, paged_decode_attention_reference,
    paged_window_attention, paged_window_attention_reference)
from repro_torch.kernels.paged_attention.ops import paged_splits
from repro_torch.kernels.wkv6 import wkv6, wkv6_chunked
from repro_torch.launch import serve
from repro_torch.models import api, attention, mamba, moe
from repro_torch.serving import (EngineConfig, InferenceEngine, PagedEngine,
                                 PagedEngineConfig)

pytestmark = pytest.mark.cuda

FLASH_CASES = [
    # b, sq, skv, h, kv, d, dv, causal, window, softcap, q_offset
    (4, 16, 16, 9, 3, 64, 64, True, None, None, 0),        # serve prefill
    (2, 300, 300, 9, 3, 64, 64, True, None, None, 0),
    (2, 33, 65, 4, 2, 16, 16, True, None, None, 32),
    (2, 64, 64, 4, 4, 16, 16, True, 24, 50.0, 0),
    (2, 48, 48, 2, 1, 32, 32, False, None, None, 0),
    (2, 100, 100, 4, 2, 96, 64, True, None, None, 0),       # D != Dv
    (1, 77, 77, 2, 1, 256, 256, True, None, None, 0),
    # the tensor-core instances: D = 128 at group 16 (split over two blocks),
    # D = 128 with a window and softcap at group 6, a 16-token chunk over a
    # 16-token cached prefix at D = 64
    (2, 300, 300, 32, 2, 128, 128, True, None, None, 0),
    (1, 77, 77, 12, 2, 128, 128, True, 24, 50.0, 0),
    (4, 16, 32, 9, 3, 64, 64, True, None, None, 16),
    # chatglm2-6b's continuation chunks on the shared-prefix paged runs:
    # one prompt, a 16-token chunk and an 8-token tail over a 16-token
    # cached prefix, D = 128 at group 16
    (1, 16, 32, 32, 2, 128, 128, True, None, None, 16),
    (1, 8, 24, 32, 2, 128, 128, True, None, None, 16),
    # the profile round trip on the reduced smollm-135m (group 4, D = 16):
    # a prompt's first 8-token chunk, and the next over its 8 cached keys
    (1, 8, 8, 4, 1, 16, 16, True, None, None, 0),
    (1, 8, 16, 4, 1, 16, 16, True, None, None, 8),
    # gemma2-27b's local layers at group 2: the window bites well inside the
    # prompt, so whole tiles below it are skipped; minicpm3-4b's MLA
    # prefill, D = 96, Dv = 64 on 40 heads (the general instance)
    (2, 600, 600, 4, 2, 128, 128, True, 256, 50.0, 0),
    (2, 130, 130, 40, 40, 96, 64, True, None, None, 0),
    # qwen2-moe-a2.7b's group 1 (16 over 16 heads) and qwen2-vl-7b's group 7
    # (28 over 4) at D = 128, at the serve prefill and at length
    (4, 16, 16, 16, 16, 128, 128, True, None, None, 0),
    (2, 300, 300, 16, 16, 128, 128, True, None, None, 0),
    (4, 16, 16, 28, 4, 128, 128, True, None, None, 0),
    (2, 300, 300, 28, 4, 128, 128, True, None, None, 0),
    # whisper-medium (group 1, D = 64, non-causal): the encoder over 1,536
    # frames, and the cross-attention prefill from 448 and 4 decoder rows
    (4, 1536, 1536, 16, 16, 64, 64, False, None, None, 0),
    (4, 448, 1536, 16, 16, 64, 64, False, None, None, 0),
    (4, 4, 1536, 16, 16, 64, 64, False, None, None, 0),
    # llama4-maverick's group 5 (40 over 8 heads) at D = 128, at the serve
    # prefill and at length (its main path runs them in bf16)
    (4, 16, 16, 40, 8, 128, 128, True, None, None, 0),
    (2, 300, 300, 40, 8, 128, 128, True, None, None, 0),
    # jamba-1.5-large's group 8 (64 over 8 heads) at D = 128, no window, at
    # the serve prefill and at the long batch's 4 x 1024 (its main path
    # runs them in bf16)
    (4, 16, 16, 64, 8, 128, 128, True, None, None, 0),
    (4, 1024, 1024, 64, 8, 128, 128, True, None, None, 0),
    # chatglm2-6b's shards on 4 ranks: a head-TP rank's 16 over 1 heads,
    # and a sequence-parallel rank's 256 query rows over 1,024 keys at
    # q_offset 768
    (2, 1024, 1024, 16, 1, 128, 128, True, None, None, 0),
    (4, 256, 1024, 32, 2, 128, 128, True, None, None, 768),
]

DECODE_CASES = [
    # b, s, h, kv, d, dv, softcap, window, kv_len
    (4, 64, 9, 3, 64, 64, None, None, [24, 20, 17, 31]),   # serve decode
    (4, 700, 9, 3, 64, 64, None, None, [700, 513, 64, 1]),
    (3, 64, 6, 3, 8, 8, 50.0, None, [64, 33, 2]),
    (2, 128, 8, 8, 16, 16, None, 40, [128, 77]),
    (2, 300, 12, 1, 128, 96, None, None, [300, 299]),      # D != Dv, G = 12
    (2, 80, 4, 2, 64, 64, None, None, [90, 0]),            # past the slots; empty
    # the edges of the split of [lo, len) across a cluster: decode_splits(1088)
    # = 16 blocks, each a whole number of 32-position tiles: one position;
    # exactly one split (32) and one past; one tile in each split (512) and
    # one past
    (6, 1088, 9, 3, 64, 64, None, None, [1, 32, 33, 512, 513, 1041]),
    (4, 4096, 9, 3, 64, 64, None, None, [4096, 3001, 1500, 7]),  # 16 splits
    # window starts 841 and 500 fall inside a tile; 150 and 33 fit in it
    (4, 1088, 9, 3, 64, 64, None, 200, [1041, 700, 150, 33]),
    (2, 1088, 12, 1, 128, 96, None, 300, [1088, 1000]),    # general instance
    (2, 2048, 8, 1, 256, 256, None, None, [2048, 1500]),    # widest, 16 splits
    # kv_len past the 128 slots: the window starts at kv_len - 40 = 110
    (2, 128, 8, 8, 16, 16, None, 40, [150, 77]),
    # the dense archs' decode at D = 128 (the general instance): chatglm2-6b's
    # 32 heads over 2 (two rows a warp) at its serve and long lengths,
    # qwen2-1.5b's 12 over 2
    (4, 64, 32, 2, 128, 128, None, None, [24, 20, 17, 31]),
    (4, 1088, 32, 2, 128, 128, None, None, [1041, 1041, 700, 1]),
    (4, 64, 12, 2, 128, 128, None, None, [24, 20, 17, 31]),
    (2, 1088, 12, 2, 128, 128, None, None, [1041, 513]),
    # qwen2-moe-a2.7b's group 1 and qwen2-vl-7b's group 7 at D = 128
    (4, 64, 16, 16, 128, 128, None, None, [24, 20, 17, 31]),
    (4, 1088, 16, 16, 128, 128, None, None, [1041, 1041, 700, 1]),
    (4, 64, 28, 4, 128, 128, None, None, [24, 20, 17, 31]),
    (4, 1088, 28, 4, 128, 128, None, None, [1041, 1041, 700, 1]),
    # gemma2-27b's serve decode (D = 128, softcap 50); whisper-medium's
    # cross decode over all 1,536 memory rows and its self decode
    (4, 64, 32, 16, 128, 128, 50.0, None, [24, 20, 17, 31]),
    (4, 1536, 16, 16, 64, 64, None, None, [1536] * 4),
    (4, 480, 16, 16, 64, 64, None, None, [449, 301, 65, 5]),
    # llama4-maverick's group 5 at D = 128: the serve decode and the long
    # batch's
    (4, 64, 40, 8, 128, 128, None, None, [24, 20, 17, 31]),
    (4, 1088, 40, 8, 128, 128, None, None, [1041, 1041, 700, 1]),
    # jamba-1.5-large's group 8 at D = 128: the serve decode and the long
    # batch's
    (4, 64, 64, 8, 128, 128, None, None, [24, 20, 17, 31]),
    (4, 1088, 64, 8, 128, 128, None, None, [1041, 1041, 1041, 1041]),
    # a head-TP rank's chatglm2-6b decode: 16 over 1 heads
    (2, 1088, 16, 1, 128, 128, None, None, [1041, 1041]),
]

PAGED_CASES = [
    # b, t, h, kv, d, dv, block_size, logical_blocks, phys_blocks, softcap
    (2, 1, 4, 2, 16, 16, 8, 4, 16, None),       # the JAX package's CASES
    (3, 1, 6, 3, 8, 8, 16, 3, 24, 50.0),
    (1, 1, 8, 8, 32, 32, 4, 6, 32, None),
    (4, 1, 16, 2, 64, 64, 16, 2, 48, None),
    (4, 1, 9, 3, 64, 64, 8, 4, 40, None),       # serve decode
    (4, 2, 9, 3, 64, 64, 8, 4, 40, None),
    (4, 4, 9, 3, 64, 64, 8, 4, 40, None),
    (4, 5, 9, 3, 64, 64, 8, 4, 40, 30.0),       # serve verify window
    (2, 3, 4, 2, 96, 64, 8, 4, 16, None),       # D != Dv
    (2, 2, 16, 2, 256, 256, 4, 5, 16, None),    # widest head, group 8
    # the dense archs at D = 128: chatglm2-6b's 32 over 2 and qwen2-1.5b's
    # 12 over 2, over 8-token and 16-token pages
    (4, 1, 32, 2, 128, 128, 8, 8, 40, None),
    (4, 1, 32, 2, 128, 128, 16, 66, 300, None),
    (4, 1, 12, 2, 128, 128, 8, 8, 40, None),
    (2, 5, 12, 2, 128, 128, 16, 66, 140, None),
    # qwen2-moe-a2.7b's paged decode and verify window (group 1), qwen2-vl-7b's
    # paged decode (group 7)
    (4, 1, 16, 16, 128, 128, 8, 8, 40, None),
    (4, 5, 16, 16, 128, 128, 8, 8, 40, None),
    (4, 1, 28, 4, 128, 128, 8, 8, 40, None),
    # llama4-maverick's paged decode and verify window (group 5)
    (4, 1, 40, 8, 128, 128, 8, 8, 40, None),
    (4, 5, 40, 8, 128, 128, 8, 8, 40, None),
    # the profile round trip's verify window on the reduced smollm-135m
    # (group 4, D = 16) over 8-token pages of a 977-page pool
    (4, 5, 4, 1, 16, 16, 8, 8, 977, None),
]

# K1's page splits: 66 16-token pages give paged_splits(66, 16) = (14, 5),
# splits ending on positions 80, 160, ...; bases are the window entry's.
PAGED_SPLIT_CASES = [
    # b, t, h, kv, d, dv, block_size, logical_blocks, phys_blocks, base
    (6, 1, 9, 3, 64, 64, 16, 66, 400, [0, 15, 16, 79, 80, 1055]),
    # limits 1, 16 (on a page boundary), 17 (one past), 80 (on a split
    # boundary), 81 (one past), 1056 (the whole table)
    (6, 5, 9, 3, 64, 64, 16, 66, 400, [75, 76, 11, 12, 0, 1051]),
    # last rows' limits 80, 81, 16, 17, 5, 1056
    (3, 5, 4, 2, 96, 64, 16, 66, 200, [300, 1040, 3]),     # general instance
    # widest head, 16 splits of 8 pages, 40 rows in three chunks
    (2, 5, 8, 1, 256, 256, 16, 128, 260, [2000, 700]),
]

WKV6_CASES = [
    # b, t, h, d, dv, chunk, decay_scale, w_max, s0
    (4, 16, 40, 64, 64, 32, 2.0, None, False),     # serve prefill
    (4, 1024, 40, 64, 64, 32, 2.0, None, False),   # long prefill
    (2, 33, 4, 32, 32, 32, 2.0, None, False),      # ragged T
    (1, 50, 2, 8, 8, 16, 2.0, None, False),        # ragged T, chunk 16
    (2, 7, 3, 16, 16, 32, 2.0, None, False),       # T < chunk
    (1, 48, 2, 16, 16, 16, 4.0, 1e-6, False),      # strong decay
    (2, 64, 3, 16, 16, 16, 2.0, None, True),       # a given s0
    (2, 40, 2, 128, 96, 32, 2.0, None, True),      # widest head, D != Dv
    # the column split over 4 blocks: Dv 6 gives 2, 2, 2 and 0 columns, Dv 2
    # gives 1, 1, 0 and 0 (blocks without a column still build their rows of A)
    (2, 40, 3, 16, 6, 32, 2.0, None, True),
    (2, 33, 2, 16, 2, 32, 2.0, None, False),
]


@pytest.fixture
def cuda():
    """The card, or a skip: decided when the test runs, never at import."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the CUDA kernels have no CPU mode)")
    return torch.device("cuda")


def _randn(gen, *shape, dtype):
    return torch.randn(*shape, generator=gen, device="cuda").to(dtype)


def _tol(want, dtype):
    # f32: summation order only; bf16: both round the output to bf16
    return 1e-4 if dtype == torch.float32 else 2e-2 * want.float().abs().max().item()


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", FLASH_CASES)
def test_flash_kernel_matches_plain(cuda, case, dtype):
    b, sq, skv, h, kv, d, dv, causal, window, cap, qoff = case
    gen = torch.Generator(device=cuda).manual_seed(0)
    q = _randn(gen, b, sq, h, d, dtype=dtype)
    k = _randn(gen, b, skv, kv, d, dtype=dtype)
    v = _randn(gen, b, skv, kv, dv, dtype=dtype)
    kw = dict(causal=causal, window=window, softcap=cap, q_offset=qoff)
    n = flash_attention.launches
    got = flash_attention(q, k, v, **kw)
    torch.cuda.synchronize()
    assert flash_attention.launches == n + 1
    want = flash_attention_reference(q, k, v, **kw)
    assert got.dtype == dtype and got.shape == want.shape
    assert (got.float() - want.float()).abs().max().item() <= _tol(want, dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", DECODE_CASES)
def test_decode_kernel_matches_plain(cuda, case, dtype):
    b, s, h, kv, d, dv, cap, window, kv_len = case
    gen = torch.Generator(device=cuda).manual_seed(0)
    q = _randn(gen, b, h, d, dtype=dtype)
    k = _randn(gen, b, s, kv, d, dtype=dtype)
    v = _randn(gen, b, s, kv, dv, dtype=dtype)
    kl = torch.tensor(kv_len, dtype=torch.int32, device=cuda)
    n = decode_attention.launches
    got = decode_attention(q, k, v, kl, softcap=cap, window=window)
    torch.cuda.synchronize()
    assert decode_attention.launches == n + 1
    want = decode_attention_reference(q, k, v, kl, softcap=cap, window=window)
    assert (got.float() - want.float()).abs().max().item() <= _tol(want, dtype)
    assert (got[kl == 0] == 0).all()   # no valid key: 0, as the reference


def _paged_inputs(gen, case, dtype):
    b, t, h, kv, d, dv, bs, nb, n, _ = case
    q = _randn(gen, b, t, h, d, dtype=dtype)
    kp = _randn(gen, n, bs, kv, d, dtype=dtype)
    vp = _randn(gen, n, bs, kv, dv, dtype=dtype)
    perm = torch.randperm(n, generator=gen, device="cuda")
    bt = perm[:b * nb].reshape(b, nb).to(torch.int32).contiguous()
    base = torch.randint(0, nb * bs - t + 1, (b,), generator=gen,
                         device="cuda").to(torch.int32)
    return q, kp, vp, bt, base


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", PAGED_CASES)
def test_paged_kernel_matches_plain(cuda, case, dtype):
    """Both entry points of K1 against their plain versions, through a
    permuted table with ragged lengths; the decode entry at kv_len 1 too."""
    cap = case[-1]
    gen = torch.Generator(device=cuda).manual_seed(0)
    q, kp, vp, bt, base = _paged_inputs(gen, case, dtype)
    n = paged_window_attention.launches
    got = paged_window_attention(q, kp, vp, bt, base, softcap=cap)
    torch.cuda.synchronize()
    assert paged_window_attention.launches == n + 1
    want = paged_window_attention_reference(q, kp, vp, bt, base, softcap=cap)
    assert got.dtype == dtype and got.shape == want.shape
    assert (got.float() - want.float()).abs().max().item() <= _tol(want, dtype)
    for kv_len in (base + 1, torch.ones_like(base)):
        got = paged_decode_attention(q[:, 0].contiguous(), kp, vp, bt, kv_len,
                                     softcap=cap)
        want = paged_decode_attention_reference(q[:, 0], kp, vp, bt, kv_len,
                                                softcap=cap)
        assert (got.float() - want.float()).abs().max().item() \
            <= _tol(want, dtype)


@pytest.mark.parametrize("t", [1, 5])
def test_paged_kernel_reads_only_the_valid_pages(cuda, t):
    """Table entries past the last valid page never reach the output: a
    tail retargeted at the null block, whose contents are poisoned, gives
    the same result.  A free slot (null row, kv_len 0) writes 0."""
    gen = torch.Generator(device=cuda).manual_seed(1)
    case = (3, t, 9, 3, 64, 64, 8, 6, 24, None)
    q, kp, vp, _, _ = _paged_inputs(gen, case, torch.float32)
    bt = (1 + torch.randperm(23, generator=gen, device=cuda)[:18]).reshape(
        3, 6).to(torch.int32)
    bt[2] = 0
    base = torch.tensor([8 + 3 - t, 2 * 8 - t, 0], dtype=torch.int32,
                        device=cuda)
    out1 = paged_window_attention(q, kp, vp, bt, base)
    bt2, kp2, vp2 = bt.clone(), kp.clone(), vp.clone()
    bt2[:2, 2:] = 0
    kp2[0], vp2[0] = 1e3, -1e3
    out2 = paged_window_attention(q, kp2, vp2, bt2, base)
    empty = paged_decode_attention(q[:, 0].contiguous(), kp, vp, bt,
                                   torch.zeros_like(base))
    torch.cuda.synchronize()
    assert torch.equal(out1[:2], out2[:2])
    want = paged_window_attention_reference(q, kp, vp, bt, base)
    assert (out1 - want).abs().max().item() <= 1e-4
    assert (empty == 0).all()


def test_paged_window_rows_do_not_depend_on_t(cuda):
    """Row t of a window equals, bit for bit, the decode entry at the same
    limit: the kernel's result for a row depends on its own limit only."""
    gen = torch.Generator(device=cuda).manual_seed(2)
    case = (4, 5, 9, 3, 64, 64, 16, 8, 40, None)
    q, kp, vp, bt, base = _paged_inputs(gen, case, torch.float32)
    win = paged_window_attention(q, kp, vp, bt, base)
    for t in range(5):
        one = paged_decode_attention(q[:, t].contiguous(), kp, vp, bt,
                                     base + t + 1)
        assert torch.equal(win[:, t], one)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", PAGED_SPLIT_CASES)
def test_paged_kernel_split_edges(cuda, case, dtype):
    """Both entry points of K1 against their plain versions where row limits
    end on, or one past, a page or a split boundary of a 66-page table; the
    window's rows equal the decode entry at the same limits bit for bit."""
    b, t, h, kv, d, dv, bs, nb, n, bases = case
    assert paged_splits(nb, bs)[0] > 1
    gen = torch.Generator(device=cuda).manual_seed(4)
    q = _randn(gen, b, t, h, d, dtype=dtype)
    kp = _randn(gen, n, bs, kv, d, dtype=dtype)
    vp = _randn(gen, n, bs, kv, dv, dtype=dtype)
    bt = torch.randperm(n, generator=gen, device=cuda)[:b * nb].reshape(
        b, nb).to(torch.int32)
    base = torch.tensor(bases, dtype=torch.int32, device=cuda)
    got = paged_window_attention(q, kp, vp, bt, base)
    want = paged_window_attention_reference(q, kp, vp, bt, base)
    assert (got.float() - want.float()).abs().max().item() <= _tol(want, dtype)
    for i in range(t):
        one = paged_decode_attention(q[:, i].contiguous(), kp, vp, bt,
                                     base + i + 1)
        assert torch.equal(got[:, i], one)
    want = paged_decode_attention_reference(q[:, 0], kp, vp, bt, base + 1)
    assert (got[:, 0].float() - want.float()).abs().max().item() \
        <= _tol(want, dtype)


def test_decode_kernels_give_the_same_bits_twice(cuda):
    """The splits' partials are merged in a fixed order, with no atomics:
    two calls on the same inputs agree bit for bit."""
    gen = torch.Generator(device=cuda).manual_seed(5)
    b, s, h, kv, d, dv, _, _, kv_len = DECODE_CASES[7]             # 16 splits
    q = _randn(gen, b, h, d, dtype=torch.float32)
    k = _randn(gen, b, s, kv, d, dtype=torch.float32)
    v = _randn(gen, b, s, kv, dv, dtype=torch.float32)
    kl = torch.tensor(kv_len, dtype=torch.int32, device=cuda)
    assert torch.equal(decode_attention(q, k, v, kl), decode_attention(q, k, v, kl))
    b, t, h, kv, d, dv, bs, nb, n, bases = PAGED_SPLIT_CASES[1]
    q = _randn(gen, b, t, h, d, dtype=torch.float32)
    kp = _randn(gen, n, bs, kv, d, dtype=torch.float32)
    vp = _randn(gen, n, bs, kv, dv, dtype=torch.float32)
    bt = torch.randperm(n, generator=gen, device=cuda)[:b * nb].reshape(
        b, nb).to(torch.int32)
    base = torch.tensor(bases, dtype=torch.int32, device=cuda)
    assert torch.equal(paged_window_attention(q, kp, vp, bt, base),
                       paged_window_attention(q, kp, vp, bt, base))


def test_decode_wrappers_reject_rows_that_are_not_16_byte_pieces(cuda):
    """K1 and K3 copy K/V rows in 16-byte pieces: a head of 6 f32 (24 bytes)
    or a K/V tensor off a 16-byte boundary is refused, not misread."""
    q = torch.zeros(1, 4, 6, device=cuda)
    k = torch.zeros(1, 8, 2, 6, device=cuda)
    kl = torch.ones(1, dtype=torch.int32, device=cuda)
    with pytest.raises(ValueError, match="16 bytes"):
        decode_attention(q, k, k, kl)
    with pytest.raises(ValueError, match="16 bytes"):
        paged_decode_attention(q, k, k, torch.zeros(1, 1, dtype=torch.int32,
                                                    device=cuda), kl)
    k = torch.zeros(2 * 8 * 2 * 16 + 1, device=cuda)[1:].view(2, 8, 2, 16)
    with pytest.raises(ValueError, match="aligned"):
        decode_attention(torch.zeros(2, 4, 16, device=cuda), k, k,
                         torch.ones(2, dtype=torch.int32, device=cuda))


def test_wrappers_reject_what_the_kernels_do_not_take(cuda):
    q = torch.zeros(1, 8, 4, 16, device=cuda)
    k = torch.zeros(1, 8, 2, 16, device=cuda)
    with pytest.raises(ValueError, match="contiguous"):
        flash_attention(q.transpose(1, 2).contiguous().transpose(1, 2), k, k)
    with pytest.raises(TypeError, match="int32"):
        decode_attention(q[:, 0], k, k, torch.ones(1, dtype=torch.long,
                                                   device=cuda))
    with pytest.raises(TypeError, match="int32"):
        paged_decode_attention(q[:, 0], k, k, torch.zeros(1, 2, dtype=torch.long,
                                                          device=cuda),
                               torch.ones(1, dtype=torch.int32, device=cuda))


def test_engine_on_card_matches_cpu(cuda):
    """Greedy outputs of the reduced model on the card (kernels) equal the
    CPU's (plain versions), and every prefill and decode step launched
    both kernels once per layer."""
    cfg = get_config("smollm-135m").reduced()
    g = torch.Generator().manual_seed(0)
    reqs = [Request(rid=i, tokens=torch.randint(2, cfg.vocab_size, (n,),
                                                generator=g).tolist(),
                    input_len=n, slo=1.0, arrival=0.0, true_output_len=6)
            for i, n in enumerate((5, 12, 9))]
    outs = {}
    for dev in ("cpu", cuda):
        eng = InferenceEngine(cfg, api.init_params(cfg, seed=0, device=dev),
                              EngineConfig(max_batch=4, cache_len=32,
                                           max_new_tokens=6))
        n_fa, n_dec = flash_attention.launches, decode_attention.launches
        res = eng.run_batch(Batch(requests=reqs),
                            true_lens={r.rid: 6 for r in reqs})
        outs[str(dev)] = res.outputs
        if dev != "cpu":
            assert flash_attention.launches - n_fa == cfg.n_layers
            assert decode_attention.launches - n_dec == cfg.n_layers * res.steps
    assert outs["cpu"] == outs[str(cuda)]


@pytest.mark.parametrize("spec_tokens", [0, 3])
def test_paged_engine_on_card_matches_cpu(cuda, spec_tokens):
    """The paged engine's greedy outputs on the card (K1, K2) equal the
    CPU's, with chunked prefill and the prefix cache on, and K1 ran once
    per layer and decode or verify step, K2 once per layer and chunk."""
    cfg = get_config("smollm-135m").reduced()
    g = torch.Generator().manual_seed(1)
    shared = torch.randint(2, cfg.vocab_size, (16,), generator=g).tolist()
    reqs = lambda: [Request(rid=i, tokens=shared + torch.randint(
        2, cfg.vocab_size, (n,), generator=torch.Generator().manual_seed(i)
    ).tolist(), input_len=16 + n, slo=10.0, arrival=float(i),
        true_output_len=7) for i, n in enumerate((3, 9, 5, 12, 2))]
    pcfg = PagedEngineConfig(max_batch=3, block_size=8, n_blocks=40,
                             max_seq_len=48, max_new_tokens=8, chunk_tokens=8,
                             prefix_cache=True, spec_tokens=spec_tokens)
    outs = {}
    for dev in ("cpu", cuda):
        eng = PagedEngine(cfg, api.init_params(cfg, seed=0, device=dev), pcfg)
        n_fa, n_pa = flash_attention.launches, paged_window_attention.launches
        res = eng.run_continuous(reqs())
        outs[str(dev)] = res.outputs
        if dev != "cpu":
            assert flash_attention.launches - n_fa == \
                cfg.n_layers * res.prefill_chunks
            assert paged_window_attention.launches - n_pa == \
                cfg.n_layers * res.steps
            assert res.prefix_hits > 0
    assert outs["cpu"] == outs[str(cuda)]


CLUSTER_LIVE = {
    "round_robin": ("alpaca", {}),
    "prefix_affinity": ("shared-prefix", {"prefix_cache": True,
                                          "chunk_tokens": 16,
                                          "router": "prefix_affinity"}),
}


@pytest.mark.parametrize("case", sorted(CLUSTER_LIVE))
def test_cluster_live_on_card_matches_cpu(cuda, case):
    """``serve --replicas 2 --paged`` at the reduced size: two live paged
    replicas give the same outputs and the same split on the card as on the
    CPU; K2 ran once per layer and prefill chunk and K1 once per layer and
    decode step, summed over the replicas, K3 and K4 never."""
    cfg = get_config("smollm-135m").reduced()
    workload, kw = CLUSTER_LIVE[case]
    pred = serve.fit_predictor(cfg.vocab_size, "cpu")
    outs = {}
    for dev in ("cpu", cuda):
        params = api.init_params(cfg, seed=0, device=dev)
        n = (flash_attention.launches, paged_window_attention.launches,
             decode_attention.launches, wkv6.launches)
        out = serve.serve_cluster(cfg, params,
                                  serve.make_requests(cfg, 12, 16, workload),
                                  copy.deepcopy(pred), replicas=2, **kw)
        if dev != "cpu":
            res = out["results"]
            assert flash_attention.launches - n[0] == \
                cfg.n_layers * sum(r.prefill_chunks for r in res)
            assert paged_window_attention.launches - n[1] == \
                cfg.n_layers * sum(r.steps for r in res)
            assert (decode_attention.launches, wkv6.launches) == n[2:]
        outs[str(dev)] = (out["outputs"], out["router"],
                          [len(rep.queue) for rep in out["replicas"]])
    assert outs["cpu"] == outs[str(cuda)]


def wkv6_inputs(gen, case, dtype):
    """r, k, v in ``dtype``; w = exp(-exp(N * decay_scale)) (clipped to
    ``w_max``) and u in f32, as the JAX package's wkv6 tests draw them."""
    b, t, h, d, dv, _, scale, w_max, with_s0 = case
    r = _randn(gen, b, t, h, d, dtype=torch.float32) * 0.5
    k = _randn(gen, b, t, h, d, dtype=torch.float32) * 0.5
    v = _randn(gen, b, t, h, dv, dtype=torch.float32)
    w = torch.exp(-torch.exp(_randn(gen, b, t, h, d, dtype=torch.float32) * scale))
    if w_max is not None:
        w = w.clamp_max(w_max)
    u = _randn(gen, h, d, dtype=torch.float32) * 0.3
    s0 = _randn(gen, b, h, d, dv, dtype=torch.float32) if with_s0 else None
    return r.to(dtype), k.to(dtype), v.to(dtype), w, u, s0


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", WKV6_CASES)
def test_wkv6_kernel_matches_plain(cuda, case, dtype):
    """K4 against the chunked plain version: out within the usual
    tolerance, the f32 state within 1e-4 in both dtypes (both read the same
    rounded inputs), everything finite."""
    gen = torch.Generator(device=cuda).manual_seed(0)
    r, k, v, w, u, s0 = wkv6_inputs(gen, case, dtype)
    chunk = case[5]
    n = wkv6.launches
    out, state = wkv6(r, k, v, w, u, s0, chunk=chunk)
    torch.cuda.synchronize()
    assert wkv6.launches == n + 1
    want, want_s = wkv6_chunked(r, k, v, w, u, s0, chunk=chunk)
    assert out.dtype == dtype and out.shape == want.shape
    assert state.dtype == torch.float32 and state.shape == want_s.shape
    assert torch.isfinite(out.float()).all() and torch.isfinite(state).all()
    assert (out.float() - want.float()).abs().max().item() <= _tol(want, dtype)
    assert (state - want_s).abs().max().item() <= 1e-4


def test_wkv6_kernel_rejects_what_it_does_not_take(cuda):
    x = torch.zeros(1, 8, 2, 16, device=cuda)
    u = torch.zeros(2, 16, device=cuda)
    with pytest.raises(ValueError, match="contiguous"):
        wkv6(x.transpose(1, 2).contiguous().transpose(1, 2), x, x, x, u)
    with pytest.raises(ValueError, match="chunk"):
        wkv6(x, x, x, x, u, chunk=64)
    with pytest.raises(TypeError):
        wkv6(x.half(), x.half(), x.half(), x, u)


def test_rwkv_engine_on_card_matches_cpu(cuda):
    """Greedy outputs of the reduced rwkv6-3b on the card (K4 on every
    prefill) equal the CPU's (plain versions), on a mixed-length batch and
    through the continuous engine; K4 ran once per layer and prefill."""
    cfg = get_config("rwkv6-3b").reduced()
    g = torch.Generator().manual_seed(0)
    reqs = [Request(rid=i, tokens=torch.randint(2, cfg.vocab_size, (n,),
                                                generator=g).tolist(),
                    input_len=n, slo=1.0, arrival=float(i), true_output_len=6)
            for i, n in enumerate((5, 40, 9, 3, 17))]
    outs = {}
    for dev in ("cpu", cuda):
        eng = InferenceEngine(cfg, api.init_params(cfg, seed=0, device=dev),
                              EngineConfig(max_batch=2, cache_len=64,
                                           max_new_tokens=6))
        n_wkv = wkv6.launches
        res = eng.run_batch(Batch(requests=reqs[:3]),
                            true_lens={r.rid: 6 for r in reqs})
        cont = eng.run_continuous(reqs)
        outs[str(dev)] = (res.outputs, cont.outputs)
        if dev != "cpu":
            assert wkv6.launches - n_wkv >= 2 * cfg.n_layers
            assert (wkv6.launches - n_wkv) % cfg.n_layers == 0
    assert outs["cpu"] == outs[str(cuda)]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("w,window", [(256, 256), (64, 4096)])
def test_ring_decode_through_the_kernel_matches_plain(cuda, w, window, dtype):
    """gemma2-27b's ring decode as the model runs it
    (``ring_decode_attention``: K3 over the first min(kv_len + 1, w) slots,
    no window) against the plain ``ring_decode``
    on the same CUDA tensors, before and after the ring wraps."""
    cfg = get_config("gemma2-27b").reduced()
    gen = torch.Generator(device=cuda).manual_seed(0)
    kv_len = torch.tensor([0, 5, w - 1, w, w + 7, 3 * w + 2], dtype=torch.int32,
                          device=cuda)
    q = _randn(gen, 6, 8, 128, dtype=dtype)
    k = _randn(gen, 6, w, 4, 128, dtype=dtype)
    v = _randn(gen, 6, w, 4, 128, dtype=dtype)
    got = attention.ring_decode_attention(q, k, v, kv_len,
                                          softcap=cfg.attn_softcap)
    want = attention.ring_decode(cfg, q, {"k": k, "v": v}, kv_len, window)
    assert (got.float() - want.float()).abs().max().item() <= _tol(want, dtype)


@pytest.mark.parametrize("arch", ["gemma2-27b", "minicpm3-4b"])
def test_window_and_mla_engines_on_card_match_cpu(cuda, arch):
    """Greedy outputs of the reduced gemma2-27b (a ring of 8 slots on its
    local layer) and minicpm3-4b (MLA) on the card equal the CPU's, padded
    and continuous; flash attention ran once per layer and prefill, decode
    attention once per layer and step on gemma2-27b (the local layer's
    ring included) and never on minicpm3-4b (latent-space decode)."""
    cfg = get_config(arch).reduced()
    g = torch.Generator().manual_seed(0)
    reqs = [Request(rid=i, tokens=torch.randint(2, cfg.vocab_size, (n,),
                                                generator=g).tolist(),
                    input_len=n, slo=1.0, arrival=float(i), true_output_len=6)
            for i, n in enumerate((5, 14, 9, 3, 11))]
    outs = {}
    for dev in ("cpu", cuda):
        eng = InferenceEngine(cfg, api.init_params(cfg, seed=0, device=dev),
                              EngineConfig(max_batch=3, cache_len=32,
                                           max_new_tokens=6))
        n_fa, n_dec = flash_attention.launches, decode_attention.launches
        res = eng.run_batch(Batch(requests=reqs[:3]),
                            true_lens={r.rid: 6 for r in reqs})
        cont = eng.run_continuous(reqs)
        outs[str(dev)] = (res.outputs, cont.outputs)
        if dev != "cpu":
            n_fa = flash_attention.launches - n_fa
            assert n_fa >= 2 * cfg.n_layers and n_fa % cfg.n_layers == 0
            steps = 0 if cfg.mla is not None else res.steps + cont.steps
            assert decode_attention.launches - n_dec == cfg.n_layers * steps
    assert outs["cpu"] == outs[str(cuda)]


@pytest.mark.parametrize("b, s, shift", [(1, 1, 0.0), (4, 1, 0.0), (4, 5, 2.0),
                                         (3, 40, 2.0)])
def test_moe_apply_on_card_matches_cpu(cuda, b, s, shift):
    """qwen2-moe-a2.7b's MoE block at the published routing (60 experts,
    top-4, 4 shared) and a narrow width on the card against the CPU on the
    same weights and input: one token, a decode batch, a verify window and
    a prefill whose capacity binds (the shared direction skews the
    router); the same drop fraction, outputs within 1e-4, with the router
    margin above 1e-6 so no expert can flip."""
    cfg = get_config("qwen2-moe-a2.7b").reduced()
    cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
        cfg.moe, n_experts=60, top_k=4, d_expert=32, n_shared_experts=4,
        d_shared=32))
    p = moe.MoE(cfg, torch.Generator().manual_seed(0))
    g = torch.Generator().manual_seed(1)
    x = torch.randn(b, s, cfg.d_model, generator=g) \
        + shift * torch.randn(cfg.d_model, generator=g)
    assert moe.router_margin(cfg, p, x) > 1e-6
    y, aux = moe.moe_apply(cfg, p, x)
    yc, auxc = moe.moe_apply(cfg, p.to(cuda), x.to(cuda))
    assert (yc.cpu() - y).abs().max().item() <= 1e-4
    assert auxc["drop_frac"].item() == aux["drop_frac"].item()
    assert auxc["lb_loss"].item() == pytest.approx(aux["lb_loss"].item(),
                                                   abs=1e-5)
    if s == 40:
        assert aux["drop_frac"].item() > 0


@pytest.mark.parametrize("arch", ["qwen2-moe-a2.7b", "qwen2-vl-7b"])
def test_moe_and_mrope_engines_on_card_match_cpu(cuda, arch):
    """Greedy outputs of the reduced qwen2-moe-a2.7b and qwen2-vl-7b on the
    card equal the CPU's, padded, continuous and paged; flash attention ran
    once per layer and prefill, decode attention once per layer and padded
    step, paged attention once per layer and paged step."""
    cfg = get_config(arch).reduced()
    g = torch.Generator().manual_seed(0)
    reqs = [Request(rid=i, tokens=torch.randint(2, cfg.vocab_size, (n,),
                                                generator=g).tolist(),
                    input_len=n, slo=1.0, arrival=float(i), true_output_len=6)
            for i, n in enumerate((5, 14, 9, 3, 11))]
    outs = {}
    for dev in ("cpu", cuda):
        params = api.init_params(cfg, seed=0, device=dev)
        eng = InferenceEngine(cfg, params, EngineConfig(
            max_batch=3, cache_len=32, max_new_tokens=6))
        n_dec, n_pag = decode_attention.launches, \
            paged_window_attention.launches
        res = eng.run_batch(Batch(requests=reqs[:3]),
                            true_lens={r.rid: 6 for r in reqs})
        cont = eng.run_continuous(reqs)
        paged = PagedEngine(cfg, params, PagedEngineConfig(
            max_batch=3, block_size=8, n_blocks=32, max_seq_len=32,
            max_new_tokens=6)).run_continuous(reqs)
        outs[str(dev)] = (res.outputs, cont.outputs, paged.outputs)
        if dev != "cpu":
            assert decode_attention.launches - n_dec == \
                cfg.n_layers * (res.steps + cont.steps)
            assert paged_window_attention.launches - n_pag == \
                cfg.n_layers * paged.steps
    assert outs["cpu"] == outs[str(cuda)]


def test_encdec_on_card_matches_cpu(cuda):
    """The reduced whisper-medium on the card equals the CPU: prefill
    logits of right-padded prompts over 16 frames, and four greedy decode
    steps token for token; flash attention ran 3 x 2 times a prefill
    (encoder, decoder self, cross) and decode attention 2 x 2 times a
    step."""
    cfg = get_config("whisper-medium").reduced()
    g = torch.Generator().manual_seed(0)
    frames = torch.randn(3, 16, cfg.d_model, generator=g) * 0.02
    toks = torch.randint(2, cfg.vocab_size, (3, 6), generator=g)
    kv_len = torch.tensor([6, 3, 1], dtype=torch.int32)
    got = {}
    for dev in ("cpu", cuda):
        params = api.init_params(cfg, seed=0, device=dev)
        n_fa, n_dec = flash_attention.launches, decode_attention.launches
        lg, cache = api.prefill(cfg, params, {"frames": frames.to(dev),
                                              "tokens": toks.to(dev)},
                                cache_len=10, kv_len=kv_len.to(dev))
        first, outs = lg.float().cpu(), []
        for step in range(4):
            nxt = lg[:, :cfg.vocab_size].argmax(-1)
            outs.append(nxt.cpu())
            lg, cache = api.decode_step(cfg, params, nxt[:, None], cache,
                                        kv_len.to(dev) + step)
        got[str(dev)] = (first, torch.stack(outs))
        if dev != "cpu":
            assert flash_attention.launches - n_fa == 3 * cfg.n_layers
            assert decode_attention.launches - n_dec == 2 * cfg.n_layers * 4
    assert (got["cpu"][0] - got[str(cuda)][0]).abs().max().item() <= 1e-4
    assert torch.equal(got["cpu"][1], got[str(cuda)][1])


def test_llama4_bf16_engines_on_card_match_cpu(cuda):
    """The reduced llama4-maverick at group 5 (10 over 2 heads; a dense
    layer, then a top-1 MoE layer) in bf16, its deployment dtype: prefill
    logits on the card against the CPU within 3e-2 of the largest logit,
    and the padded and paged engines run with bf16 caches and pools; K2
    once per layer and prefill, K3 once per layer and padded step, K1 once
    per layer and paged step."""
    cfg = dataclasses.replace(get_config("llama4-maverick-400b-a17b").reduced(),
                              n_heads=10, n_kv_heads=2)
    g = torch.Generator().manual_seed(0)
    reqs = [Request(rid=i, tokens=torch.randint(2, cfg.vocab_size, (n,),
                                                generator=g).tolist(),
                    input_len=n, slo=1.0, arrival=float(i), true_output_len=6)
            for i, n in enumerate((5, 14, 9, 3, 11))]
    cpu = api.init_params(cfg, seed=0, dtype=torch.bfloat16, device="cpu")
    card = api.init_params(cfg, seed=0, dtype=torch.bfloat16, device=cuda)
    toks = torch.randint(2, cfg.vocab_size, (3, 12), generator=g)
    kv_len = torch.tensor([12, 7, 3], dtype=torch.int32)
    lg, _ = api.prefill(cfg, cpu, {"tokens": toks}, cache_len=16, kv_len=kv_len)
    lgc, cache = api.prefill(cfg, card, {"tokens": toks.to(cuda)},
                             cache_len=16, kv_len=kv_len.to(cuda))
    assert cache[0]["k"].dtype == torch.bfloat16
    assert (lgc.cpu() - lg).abs().max().item() <= \
        3e-2 * lg.abs().max().item()
    eng = InferenceEngine(cfg, card, EngineConfig(max_batch=3, cache_len=32,
                                                  max_new_tokens=6))
    n_fa, n_dec, n_pag = flash_attention.launches, decode_attention.launches, \
        paged_window_attention.launches
    res = eng.run_batch(Batch(requests=reqs[:3]),
                        true_lens={r.rid: 6 for r in reqs})
    paged = PagedEngine(cfg, card, PagedEngineConfig(
        max_batch=3, block_size=8, n_blocks=32, max_seq_len=32,
        max_new_tokens=6), dtype=torch.bfloat16).run_continuous(reqs)
    assert len(res.outputs) == 3 and len(paged.outputs) == 5
    assert decode_attention.launches - n_dec == cfg.n_layers * res.steps
    assert paged_window_attention.launches - n_pag == \
        cfg.n_layers * paged.steps
    assert flash_attention.launches - n_fa == \
        cfg.n_layers * (1 + paged.prefill_chunks)


def test_mamba_on_card_matches_cpu(cuda):
    """The reduced jamba's Mamba mixer (f32) on the card against the CPU on
    the same weights: a prefill of T = 40 in chunks of 16 with ``kv_len``
    (output, conv tail and state) and four decode steps."""
    cfg = get_config("jamba-1.5-large-398b").reduced()
    cpu = api.init_params(cfg, seed=0, device="cpu")
    card = api.init_params(cfg, seed=0, device=cuda)
    g = torch.Generator().manual_seed(1)
    x = torch.randn(3, 40, cfg.d_model, generator=g)
    kv_len = torch.tensor([40, 2, 23], dtype=torch.int32)
    got = {}
    for dev, model in (("cpu", cpu), ("cuda", card)):
        p = model.blocks[1].mixer
        y, c = mamba.mamba_prefill(cfg, p, x.to(dev), cache_len=48, chunk=16,
                                   kv_len=kv_len.to(dev))
        ys = [y]
        for t in range(4):
            yt, c = mamba.mamba_decode(cfg, p, x[:, t:t + 1].to(dev), c)
            ys.append(yt)
        got[dev] = [v.cpu() for v in ys + [c["conv"], c["ssm"]]]
    for a, b in zip(got["cpu"], got["cuda"]):
        assert (a - b).abs().max().item() <= 1e-4


def test_jamba_engines_on_card_match_cpu(cuda):
    """The reduced jamba (one group period: 7 Mamba layers and an
    attention layer) in f32 through the padded and continuous engines on
    the card, greedy outputs equal to the CPU's; prefill logits within
    1e-4; K2 once a prefill and K3 once a padded decode step (the one
    attention layer), K1 and K4 never."""
    cfg = get_config("jamba-1.5-large-398b").reduced()
    g = torch.Generator().manual_seed(0)
    reqs = [Request(rid=i, tokens=torch.randint(2, cfg.vocab_size, (n,),
                                                generator=g).tolist(),
                    input_len=n, slo=1.0, arrival=float(i), true_output_len=6)
            for i, n in enumerate((5, 14, 9, 3, 11))]
    toks = torch.randint(2, cfg.vocab_size, (3, 12), generator=g)
    kv_len = torch.tensor([12, 7, 3], dtype=torch.int32)
    outs, logits = {}, {}
    for dev in ("cpu", cuda):
        model = api.init_params(cfg, seed=0, device=dev)
        logits[str(dev)], _ = api.prefill(
            cfg, model, {"tokens": toks.to(dev)}, cache_len=16,
            kv_len=kv_len.to(dev))
        eng = InferenceEngine(cfg, model, EngineConfig(max_batch=3,
                                                       cache_len=32,
                                                       max_new_tokens=6))
        n = (flash_attention.launches, decode_attention.launches,
             paged_window_attention.launches, wkv6.launches)
        res = eng.run_batch(Batch(requests=reqs[:3]),
                            true_lens={r.rid: 6 for r in reqs})
        if dev != "cpu":
            assert flash_attention.launches - n[0] == 1
            assert decode_attention.launches - n[1] == res.steps
            assert (paged_window_attention.launches, wkv6.launches) == n[2:]
        cont = eng.run_continuous(reqs)
        outs[str(dev)] = (res.outputs, cont.outputs)
    assert (logits["cpu"] - logits[str(cuda)].cpu()).abs().max().item() <= 1e-4
    assert outs["cpu"] == outs[str(cuda)]


# ------------------------------------------------------------- training

def test_kernels_without_a_backward_raise_under_grad(cuda):
    """K1, K3 and K4 write their outputs through raw pointers: under grad,
    with an input that requires it, they raise instead of returning an
    output autograd cannot see through; under no_grad they run."""
    gen = torch.Generator(device=cuda).manual_seed(0)
    q = _randn(gen, 2, 4, 16, dtype=torch.float32).requires_grad_(True)
    k = _randn(gen, 2, 32, 2, 16, dtype=torch.float32)
    v = _randn(gen, 2, 32, 2, 16, dtype=torch.float32)
    kl = torch.tensor([5, 32], dtype=torch.int32, device=cuda)
    with pytest.raises(RuntimeError, match="no gradient"):
        decode_attention(q, k, v, kl)
    pool_k = _randn(gen, 8, 4, 2, 16, dtype=torch.float32)
    pool_v = _randn(gen, 8, 4, 2, 16, dtype=torch.float32)
    tables = torch.arange(1, 9, dtype=torch.int32, device=cuda)[None] \
        .expand(2, 8)[:, :4].contiguous()
    with pytest.raises(RuntimeError, match="no gradient"):
        paged_decode_attention(q, pool_k, pool_v, tables, kl.clamp(max=16))
    with pytest.raises(RuntimeError, match="no gradient"):
        paged_window_attention(q[:, None].contiguous(), pool_k, pool_v,
                               tables, kl.clamp(max=15))
    r, kk, w = (_randn(gen, 1, 8, 2, 16, dtype=torch.float32) for _ in range(3))
    with pytest.raises(RuntimeError, match="no gradient"):
        wkv6(r.requires_grad_(True), kk, kk, torch.sigmoid(w),
             torch.zeros(2, 16, device=cuda))
    with torch.no_grad():
        decode_attention(q, k, v, kl)
        paged_decode_attention(q, pool_k, pool_v, tables, kl.clamp(max=16))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", [
    (2, 64, 64, 6, 2, 64, 64, True, None, None, 0),
    (1, 40, 72, 8, 1, 128, 128, True, None, None, 32),
    (2, 48, 48, 4, 2, 32, 32, True, 16, 20.0, 0),
    (2, 50, 50, 4, 2, 96, 64, True, None, None, 0),
    (2, 12, 40, 4, 4, 64, 64, False, None, None, 0),
])
def test_flash_kernel_gradient_matches_plain_autograd(monkeypatch, cuda, case,
                                                      dtype):
    """K2's autograd.Function on the card: the kernel's forward and
    flash_attention_grad equal autograd of the plain version on the same
    tensors, one launch and one backward each, and the plain version never
    runs in the card's forward or backward."""
    from repro_torch.kernels.flash_attention import ops as fa_ops
    b, sq, skv, h, kv, d, dv, causal, window, cap, qoff = case
    gen = torch.Generator(device=cuda).manual_seed(0)
    q, k, v = (_randn(gen, *s, dtype=dtype) for s in (
        (b, sq, h, d), (b, skv, kv, d), (b, skv, kv, dv)))
    do = _randn(gen, b, sq, h, dv, dtype=dtype)
    kw = dict(causal=causal, window=window, softcap=cap, q_offset=qoff)
    leaves = [t.clone().requires_grad_(True) for t in (q, k, v)]
    n, nb = flash_attention.launches, flash_attention.backward_calls
    with monkeypatch.context() as mp:
        def plain(*args, **kwargs):
            raise AssertionError("the plain version ran on the card")
        mp.setattr(fa_ops, "flash_attention_reference", plain)
        out = flash_attention(*leaves, **kw)
        got = torch.autograd.grad(out, leaves, do)
        torch.cuda.synchronize()
    assert (flash_attention.launches, flash_attention.backward_calls) == \
        (n + 1, nb + 1)
    ref = [t.clone().requires_grad_(True) for t in (q, k, v)]
    want = torch.autograd.grad(flash_attention_reference(*ref, **kw), ref, do)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and g.shape == w.shape
        tol = (1e-4 if dtype == torch.float32 else 2e-2) * \
            w.float().abs().max().item()
        assert (g.float() - w.float()).abs().max().item() <= tol


def test_train_step_on_card_matches_cpu(cuda):
    """Two AdamW steps of the reduced smollm: loss and grad_norm on the
    card (K2 forward, its torch gradient) against the CPU."""
    from repro_torch.launch.train import batch_at, token_base
    from repro_torch.training import (OptConfig, TrainConfig, init_training,
                                      make_train_step)
    cfg = get_config("smollm-135m").reduced()
    tcfg = TrainConfig(opt=OptConfig(lr=1e-3))
    base = token_base(cfg, 4, 64)
    runs = {}
    for device in ("cpu", "cuda"):
        params, opt = init_training(cfg, 0, tcfg, device=device)
        step = make_train_step(cfg, None, tcfg)
        runs[device] = []
        for i in range(2):
            params, opt, m = step(params, opt, batch_at(base, i, device), i)
            runs[device].append((float(m["loss"]), float(m["grad_norm"])))
    for (lc, gc), (lg, gg) in zip(runs["cpu"], runs["cuda"]):
        assert lg == pytest.approx(lc, rel=1e-4)
        assert gg == pytest.approx(gc, rel=1e-3)
