"""Compare the port's kernels and its long prefill and decode steps between
checkouts, on one NVIDIA GPU.

    python3 chip_compare.py OLD_ROOT NEW_ROOT [--splits]

Each checkout runs in a process of its own, in the order OLD, NEW, NEW,
OLD, so both meet the same card, and each run prints one JSON line:

- device ms (torch.profiler, median of 50 launches, warm L2, f32) of the
  prefill kernel K2 at ``serve_prefill`` (4 x 16 tokens), ``long_prefill``
  (4 x 1024) and ``long_prefill_b1`` (1 x 1024, the paged path's
  single-prompt prefill), of the flash-decoding kernel K3 at ``serve_decode`` (4 x 64-slot caches, lengths
  <= 31), ``long_decode`` (4 x 1041 of 1088) and ``s4096_ragged`` (lengths
  4096, 3001, 1500, 7), and of the paged kernel K1 at ``paged_serve_decode``
  (8-token pages), ``paged_long_decode`` (66 16-token pages, kv_len 1041)
  and ``paged_long_window`` (the T = 5 verify window), 9 query heads over
  3 KV heads of 64, as ``chip_smoke.py`` times them, and of the WKV6 kernel
  K4 at ``rwkv_serve_prefill`` (4 x 16 tokens) and ``rwkv_long_prefill``
  (4 x 1024), 40 heads of 64, chunk 32, inputs drawn as ``chip_smoke.py``
  draws them;
- wall ms (median of 5), device-busy ms and the attention kernel's ms
  (``fa_fwd``; ``dec_fwd`` or ``paged_fwd``) of the padded long prefill
  (4 x 1024 tokens) and of the padded and the paged long decode step of
  smollm-135m at full width (4 sequences at kv_len 1041).

``--splits`` also times the last checkout's kernels at the long shapes with
one block per (batch, KV head) and with the split count its wrappers pick,
so the per-tile and the fixed cost of a call can be told apart (the
checkout must have ``decode_splits``).  Needs a CUDA device; imports no JAX.
"""
from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

B, H, KV, D = 4, 9, 3, 64
N_TIMED = 50
K3_SHAPES = [  # name, cache slots, lengths
    ("serve_decode", 64, [24, 20, 17, 31]),
    ("long_decode", 1088, [1041] * 4),
    ("s4096_ragged", 4096, [4096, 3001, 1500, 7]),
]
K2_SHAPES = [  # name, batch, tokens
    ("serve_prefill", 4, 16),
    ("long_prefill", 4, 1024),
    ("long_prefill_b1", 1, 1024),
]
K4_SHAPES = [  # name, batch, tokens
    ("rwkv_serve_prefill", 4, 16),
    ("rwkv_long_prefill", 4, 1024),
]
K4_HEADS = 40
K1_SHAPES = [  # name, pages, page size, window T, window base (kv_len)
    ("paged_serve_decode", 4, 8, 1, [23, 19, 16, 30]),
    ("paged_long_decode", 66, 16, 1, [1040] * 4),
    ("paged_long_window", 66, 16, 5, [1036] * 4),
]


def measure(root: Path, splits: bool) -> dict:
    sys.path.insert(0, str(root / "src"))
    import torch
    from repro_torch.configs import get_config
    from repro_torch.kernels.decode_attention import decode_attention
    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.kernels.paged_attention import paged_window_attention
    from repro_torch.kernels.wkv6 import wkv6
    from repro_torch.models import api
    from repro_torch.serving import EngineConfig, InferenceEngine, greedy

    if not torch.cuda.is_available():
        sys.exit("chip_compare.py needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    gen = torch.Generator(device="cuda").manual_seed(0)

    def randn(*shape):
        return torch.randn(*shape, generator=gen, device="cuda")

    def activities(fn, n):
        fn()
        torch.cuda.synchronize()
        with torch.profiler.profile(
                activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
            for _ in range(n):
                fn()
            torch.cuda.synchronize()
        return [(e.name, e.time_range.elapsed_us()) for e in prof.events()
                if e.device_type == torch.autograd.DeviceType.CUDA]

    def kernel_ms(fn):
        return statistics.median(us for _, us in activities(fn, N_TIMED)) / 1e3

    out, calls = {}, {}
    for name, b, s in K2_SHAPES:
        q, k, v = randn(b, s, H, D), randn(b, s, KV, D), randn(b, s, KV, D)
        out[f"K2/{name}"] = kernel_ms(lambda: flash_attention(q, k, v))
    for name, s, lens in K3_SHAPES:
        q, k, v = randn(B, H, D), randn(B, s, KV, D), randn(B, s, KV, D)
        kl = torch.tensor(lens, dtype=torch.int32, device="cuda")
        calls[name] = (q, k, v, kl)
        out[f"K3/{name}"] = kernel_ms(lambda: decode_attention(q, k, v, kl))
    for name, nb, bs, t, base in K1_SHAPES:
        n = B * nb + 1
        kp, vp = randn(n, bs, KV, D), randn(n, bs, KV, D)
        bt = (1 + torch.randperm(n - 1, generator=gen, device="cuda"))[
            :B * nb].reshape(B, nb).to(torch.int32)
        q = randn(B, t, H, D)
        kl = torch.tensor(base, dtype=torch.int32, device="cuda")
        calls[name] = (q, kp, vp, bt, kl)
        out[f"K1/{name}"] = kernel_ms(
            lambda: paged_window_attention(q, kp, vp, bt, kl))
    for name, b, t in K4_SHAPES:
        r, k = randn(b, t, K4_HEADS, D) * 0.5, randn(b, t, K4_HEADS, D) * 0.5
        v = randn(b, t, K4_HEADS, D)
        w = torch.exp(-torch.exp(randn(b, t, K4_HEADS, D) * 2.0))
        u = randn(K4_HEADS, D) * 0.3
        out[f"K4/{name}"] = kernel_ms(lambda: wkv6(r, k, v, w, u, chunk=32))
    if splits:
        out.update(split_sweep(calls, kernel_ms))

    def step(key, fn, symbol):
        fn()
        torch.cuda.synchronize()
        walls = []
        for _ in range(5):
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            walls.append((time.perf_counter() - t0) * 1e3)
        kern = activities(fn, 3)
        out[key] = {
            "wall_ms": statistics.median(walls),
            "device_busy_ms": sum(us for _, us in kern) / 1e3 / 3,
            f"{symbol}_ms": sum(us for nm, us in kern if symbol in nm) / 1e3 / 3}

    cfg = get_config("smollm-135m")
    params = api.init_params(cfg, seed=0, dtype=torch.float32, device="cuda")
    eng = InferenceEngine(cfg, params, EngineConfig(max_batch=B, cache_len=1088))
    prompts = torch.randint(2, cfg.vocab_size, (B, 1024),
                            generator=torch.Generator().manual_seed(0)).tolist()
    toks, kv_len = eng._pad_prompts(prompts)
    step("padded long prefill", lambda: eng._prefill(toks, kv_len), "fa_fwd")
    logits, cache = eng._prefill(toks, kv_len)
    nxt = greedy(logits, cfg.vocab_size)[:, None].long()
    step("padded long decode step", lambda: eng._decode(nxt, cache, kv_len),
         "dec_fwd")
    del cache, logits
    pools = api.init_paged_pools(cfg, B * 66 + 1, 16, device="cuda")
    for pool in pools:
        pool["k"].normal_(generator=gen)
        pool["v"].normal_(generator=gen)
    bt = (1 + torch.randperm(B * 66, generator=gen, device="cuda")).reshape(
        B, 66).to(torch.int32)
    kl = torch.full((B,), 1041, dtype=torch.int32, device="cuda")
    tok = torch.randint(2, cfg.vocab_size, (B, 1), generator=gen, device="cuda")
    step("paged long decode step",
         lambda: api.paged_decode_step(cfg, params, tok, pools, bt, kl),
         "paged_fwd")
    return out


def split_sweep(calls, kernel_ms) -> dict:
    """The long shapes' kernels with one block per (batch, KV head) and
    with the wrappers' split count, through the kernels' C entry points."""
    import torch
    from repro_torch.kernels.decode_attention import ops as dec
    from repro_torch.kernels.paged_attention import ops as paged

    stream = torch.cuda.current_stream().cuda_stream
    out = {}
    q, k, v, kl = calls["long_decode"]
    o = torch.empty(B, H, D, device="cuda")
    s = k.shape[1]
    for n in (1, dec.decode_splits(s)):
        out[f"K3/long_decode/splits={n}"] = kernel_ms(lambda: dec._kernel()(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), kl.data_ptr(),
            o.data_ptr(), 0, B, s, H, KV, D, D, 0, 0.0, D ** -0.5, n, stream))
    for name in ("paged_long_decode", "paged_long_window"):
        q, kp, vp, bt, kl = calls[name]
        t, (nb, bs) = q.shape[1], (bt.shape[1], kp.shape[1])
        o = torch.empty(B, t, H, D, device="cuda")
        for n, per in ((1, nb), paged.paged_splits(nb, bs)):
            out[f"K1/{name}/splits={n}"] = kernel_ms(lambda: paged._kernel()(
                q.data_ptr(), kp.data_ptr(), vp.data_ptr(), bt.data_ptr(),
                kl.data_ptr(), o.data_ptr(), 0, B, t, H, KV, D, D, bs, nb, 0,
                0.0, D ** -0.5, n, per, stream))
    return out


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("roots", nargs="*", type=Path,
                    help="checkouts: OLD NEW runs OLD, NEW, NEW, OLD")
    ap.add_argument("--splits", action="store_true",
                    help="also sweep the last checkout's split counts")
    ap.add_argument("--one", type=Path, help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.one:
        print(json.dumps(measure(args.one.resolve(), args.splits)))
        return
    roots = args.roots
    if not roots:
        ap.error("name one or two checkouts")
    order = [roots[0], roots[1], roots[1], roots[0]] if len(roots) == 2 else roots
    for i, root in enumerate(order):
        sweep = args.splits and root == roots[-1] and i == order.index(root)
        res = subprocess.run(
            [sys.executable, __file__, "--one", str(root)]
            + (["--splits"] if sweep else []), capture_output=True, text=True,
            timeout=900)
        if res.returncode:
            sys.exit(f"{root}: exit {res.returncode}\n{res.stderr[-4000:]}")
        print(f"{root} {res.stdout.strip().splitlines()[-1]}", flush=True)


if __name__ == "__main__":
    main()
