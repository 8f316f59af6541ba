"""The port's CUDA kernels on the card: each against its plain PyTorch
version on the same CUDA tensors, f32 and bf16, and the engine on the card
against the engine on the CPU.  Imports no JAX, so it runs where only
PyTorch is installed:

    PYTHONPATH=src python -m pytest -q tests/test_torch_cuda.py

Every test needs an NVIDIA GPU and skips without one."""
import pytest
import torch

from repro_torch.configs import get_config
from repro_torch.core.types import Batch, Request
from repro_torch.kernels.decode_attention import (decode_attention,
                                                  decode_attention_reference)
from repro_torch.kernels.flash_attention import (flash_attention,
                                                 flash_attention_reference)
from repro_torch.models import api
from repro_torch.serving import EngineConfig, InferenceEngine

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
]

DECODE_CASES = [
    # b, s, h, kv, d, dv, softcap, window, kv_len
    (4, 64, 9, 3, 64, 64, None, None, [24, 20, 17, 31]),   # serve decode
    (4, 700, 9, 3, 64, 64, None, None, [700, 513, 64, 1]),
    (3, 64, 6, 3, 8, 8, 50.0, None, [64, 33, 2]),
    (2, 128, 8, 8, 16, 16, None, 40, [128, 77]),
    (2, 300, 12, 1, 128, 96, None, None, [300, 299]),      # D != Dv, G = 12
    (2, 80, 4, 2, 64, 64, None, None, [90, 0]),            # past the slots; empty
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
    ok = kl > 0            # no valid key: the kernel writes 0, as the TPU one
    want = decode_attention_reference(q, k, v, kl, softcap=cap, window=window)
    err = (got.float() - want.float())[ok].abs().max().item()
    assert err <= _tol(want[ok], dtype)
    assert (got[~ok] == 0).all()


def test_wrappers_reject_what_the_kernels_do_not_take(cuda):
    q = torch.zeros(1, 8, 4, 16, device=cuda)
    k = torch.zeros(1, 8, 2, 16, device=cuda)
    with pytest.raises(ValueError, match="contiguous"):
        flash_attention(q.transpose(1, 2).contiguous().transpose(1, 2), k, k)
    with pytest.raises(TypeError, match="int32"):
        decode_attention(q[:, 0], k, k, torch.ones(1, dtype=torch.long,
                                                   device=cuda))


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
