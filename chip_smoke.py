"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, in order; any failed check exits non-zero:

1. device: a CUDA device must be present; prints its name and power limit;
   TF32 off for matmuls and convolutions (full fp32).
2. build: compiles every CUDA kernel of the serve path from
   ``src/repro_torch/kernels/csrc`` with nvcc, all at once.
3. parity: each kernel against its plain PyTorch version on the same CUDA
   tensors, f32 and bf16, at the serve path's shapes and the edge cases
   (q_offset, window, softcap, non-causal, D != Dv, ragged lengths).
4. times: each kernel, its plain version and the one PyTorch call that
   computes the same function (scaled_dot_product_attention, timed only as
   a yardstick), median of CUDA-event-timed runs.
5. serve: the default serve path of ``repro_torch.launch.serve`` at full
   width (smollm-135m, 30 layers, d_model 576), then one longer padded batch
   (4 x 1024-token prompts, 32 new tokens); checks that both kernels ran on
   every prefill and decode step, and that the first batch's logits on the
   card match the same engine on the CPU.

The last three lines are a JSON object of per-kernel numbers (launches on
the serve phase's paths, error, device time, plain-version and library
times, bound), the card's name and power limit as nvidia-smi reports them,
and ``{"ok": true, "device": {...}}``.  A copy of every number goes to
``chiprun_out/chip_smoke.json``.
"""
from __future__ import annotations

import json
import math
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

import numpy as np  # noqa: E402
import torch  # noqa: E402
import torch.nn.functional as F  # noqa: E402

from repro_torch.configs import H100, get_config  # noqa: E402
from repro_torch.core.types import Batch, Request  # noqa: E402
from repro_torch.kernels import build  # noqa: E402
from repro_torch.kernels.decode_attention import (  # noqa: E402
    decode_attention, decode_attention_reference)
from repro_torch.kernels.flash_attention import (  # noqa: E402
    flash_attention, flash_attention_reference)
from repro_torch.launch import serve  # noqa: E402
from repro_torch.models import api  # noqa: E402
from repro_torch.serving import EngineConfig, InferenceEngine, greedy  # noqa: E402

# Bounds use the H100 data sheet's peaks: HBM bytes/s, and FLOP/s of fp32
# outside the tensor cores (what these FMA kernels use) and of bf16.
PEAK_FLOPS = {torch.float32: H100.peak_flops_fp32, torch.bfloat16: H100.peak_flops}
TOL_F32 = 1e-4            # fp32 kernel vs fp32 plain: summation order only
TOL_BF16 = 2e-2           # x max|ref|: both round the output to bf16
TOL_LOGITS = 1e-3         # card vs CPU logits, f32, 30 layers
SERVE_ARGS = ["--no-reduced", "--device", "cuda"]
LONG_PROMPT, LONG_NEW, LONG_CACHE = 1024, 32, 1088
N_TIMED = 25

FLASH_CASES = [  # name, b, sq, skv, h, kv, d, dv, causal, window, softcap, q_offset
    ("serve_prefill", 4, 16, 16, 9, 3, 64, 64, True, None, None, 0),
    ("long_prefill", 4, LONG_PROMPT, LONG_PROMPT, 9, 3, 64, 64, True, None, None, 0),
    ("s2048", 4, 2048, 2048, 9, 3, 64, 64, True, None, None, 0),
    ("q_offset", 2, 33, 65, 4, 2, 16, 16, True, None, None, 32),
    ("window_softcap", 2, 64, 64, 4, 4, 16, 16, True, 24, 50.0, 0),
    ("non_causal", 2, 48, 48, 2, 1, 32, 32, False, None, None, 0),
    ("d96_dv64", 2, 100, 100, 4, 2, 96, 64, True, None, None, 0),
    ("ragged33", 1, 33, 33, 3, 3, 8, 8, True, None, None, 0),
]
DECODE_CASES = [  # name, b, s, h, kv, d, dv, softcap, window, kv_len
    ("serve_decode", 4, 64, 9, 3, 64, 64, None, None, [24, 20, 17, 31]),
    ("long_decode", 4, LONG_CACHE, 9, 3, 64, 64, None, None, [1041] * 4),
    ("s4096_ragged", 4, 4096, 9, 3, 64, 64, None, None, [4096, 3001, 1500, 7]),
    ("window", 2, 128, 8, 8, 16, 16, None, 40, [128, 77]),
    ("softcap", 3, 64, 6, 3, 8, 8, 50.0, None, [64, 33, 2]),
    ("kv_len_1", 4, 256, 9, 3, 64, 64, None, None, [1, 1, 1, 1]),
]
TIMED = {"flash_attention": "long_prefill", "decode_attention": "long_decode"}


def fail(msg: str) -> None:
    print(f"FAIL: {msg}", flush=True)
    sys.exit(1)


def call_ms(fn) -> float:
    """Median milliseconds of one call of ``fn`` between two CUDA events,
    over N_TIMED calls: device time plus any wait for the host's launch."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(N_TIMED):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def device_kernels(fn, n: int = 1):
    """Device activities (kernels, copies) of ``n`` calls of ``fn`` as
    torch.profiler records them: [(name, microseconds)]."""
    fn()
    torch.cuda.synchronize()
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
    return [(e.name, e.time_range.elapsed_us()) for e in prof.events()
            if e.device_type == torch.autograd.DeviceType.CUDA]


def timed(fn) -> dict:
    """Device ms per call (sum of its kernels' durations, profiler) and the
    event-timed ms per call; ``ms`` is the device time where the profiler
    saw the device, else the event time."""
    kern = device_kernels(fn, N_TIMED)
    dev = sum(us for _, us in kern) / 1e3 / N_TIMED if kern else None
    ev = call_ms(fn)
    return {"ms": dev if dev is not None else ev, "device_ms": dev,
            "call_ms": ev, "launches_per_call": len(kern) / N_TIMED}


def randn(gen, *shape, dtype):
    return torch.randn(*shape, generator=gen, device="cuda").to(dtype)


def flash_inputs(case, dtype, gen):
    _, b, sq, skv, h, kv, d, dv, causal, window, cap, qoff = case
    q = randn(gen, b, sq, h, d, dtype=dtype)
    k = randn(gen, b, skv, kv, d, dtype=dtype)
    v = randn(gen, b, skv, kv, dv, dtype=dtype)
    return (q, k, v), dict(causal=causal, window=window, softcap=cap,
                           q_offset=qoff)


def decode_inputs(case, dtype, gen):
    _, b, s, h, kv, d, dv, cap, window, kv_len = case
    q = randn(gen, b, h, d, dtype=dtype)
    k = randn(gen, b, s, kv, d, dtype=dtype)
    v = randn(gen, b, s, kv, dv, dtype=dtype)
    kl = torch.tensor(kv_len, dtype=torch.int32, device="cuda")
    return (q, k, v, kl), dict(softcap=cap, window=window)


def flash_cost(case, dtype):
    """(bytes, operations) the flash function needs for this case."""
    _, b, sq, skv, h, kv, d, dv, causal, window, cap, qoff = case
    size = torch.finfo(dtype).bits // 8
    pairs = 0
    for i in range(sq):
        qa = qoff + i
        hi = min(skv - 1, qa) if causal else skv - 1
        lo = max(0, qa - window + 1) if window else 0
        pairs += max(0, hi - lo + 1)
    nbytes = size * (b * sq * h * (d + dv) + b * skv * kv * (d + dv))
    return nbytes, 2.0 * (d + dv) * pairs * b * h


def decode_cost(case, dtype):
    _, b, s, h, kv, d, dv, cap, window, kv_len = case
    size = torch.finfo(dtype).bits // 8
    rows = sum(min(n, window) if window else n for n in kv_len)
    nbytes = size * (rows * kv * (d + dv) + b * h * (d + dv)) + 4 * b
    return nbytes, 2.0 * (d + dv) * rows * h


def bound(nbytes, ops, dtype):
    t_bytes, t_ops = nbytes / H100.hbm_bw * 1e3, ops / PEAK_FLOPS[dtype] * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def phase_device() -> dict:
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: no CUDA device")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip().splitlines()[0]
    print(f"[device] {torch.cuda.get_device_name(0)}; nvidia-smi: {smi}; "
          f"torch {torch.__version__}, CUDA {torch.version.cuda}", flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return {"name": torch.cuda.get_device_name(0), "smi": smi}


def phase_build() -> dict:
    t0 = time.perf_counter()
    took = build.build_all()
    wall = time.perf_counter() - t0
    print(f"[build] {len(took)} kernels in {wall:.1f}s wall "
          f"({', '.join(f'{n} {s:.1f}s' for n, s in took.items())})", flush=True)
    for name in build.KERNELS:
        regs = [ln.split("info    :")[-1].strip()
                for ln in build.build_log(name).splitlines() if "registers" in ln]
        print(f"[build] {name}: {'; '.join(regs)}", flush=True)
    return {"wall_s": wall, "per_kernel_s": took}


def phase_parity() -> dict:
    gen = torch.Generator(device="cuda").manual_seed(0)
    out, bad = {}, []
    for kernel, cases, make, fn, ref in (
            ("flash_attention", FLASH_CASES, flash_inputs, flash_attention,
             flash_attention_reference),
            ("decode_attention", DECODE_CASES, decode_inputs, decode_attention,
             decode_attention_reference)):
        for case in cases:
            for dtype in (torch.float32, torch.bfloat16):
                args, kw = make(case, dtype, gen)
                got = fn(*args, **kw)
                torch.cuda.synchronize()
                want = ref(*args, **kw)
                if got.shape != want.shape or got.dtype != want.dtype:
                    fail(f"{kernel} {case[0]}: {got.shape}/{got.dtype} vs "
                         f"{want.shape}/{want.dtype}")
                err = (got.float() - want.float()).abs().max().item()
                tol = TOL_F32 if dtype == torch.float32 else \
                    TOL_BF16 * want.float().abs().max().item()
                ok = err <= tol and math.isfinite(err)
                tag = f"{kernel}/{case[0]}/{str(dtype)[6:]}"
                out[tag] = {"max_abs_err": err, "tol": tol}
                print(f"[parity] {tag}: max_abs_err {err:.3e} tol {tol:.3e} "
                      f"{'ok' if ok else 'FAIL'}", flush=True)
                if not ok:
                    bad.append(tag)
    if bad:
        fail(f"kernel parity: {bad}")
    return out


def phase_times() -> dict:
    gen = torch.Generator(device="cuda").manual_seed(1)
    out = {}
    for case in FLASH_CASES[:3]:
        args, kw = flash_inputs(case, torch.float32, gen)
        lib_args = [t.transpose(1, 2).contiguous() for t in args]
        out[f"flash_attention/{case[0]}"] = time_three(
            lambda: flash_attention(*args, **kw),
            lambda: flash_attention_reference(*args, **kw),
            lambda: F.scaled_dot_product_attention(*lib_args, is_causal=True,
                                                   enable_gqa=True),
            flash_cost(case, torch.float32))
    for case in DECODE_CASES[:3]:
        (q, k, v, kl), kw = decode_inputs(case, torch.float32, gen)
        mask = (torch.arange(k.shape[1], device="cuda")[None, :]
                < kl[:, None])[:, None, None, :]
        lq, lk, lv = q[:, :, None], k.transpose(1, 2).contiguous(), \
            v.transpose(1, 2).contiguous()
        out[f"decode_attention/{case[0]}"] = time_three(
            lambda: decode_attention(q, k, v, kl, **kw),
            lambda: decode_attention_reference(q, k, v, kl, **kw),
            lambda: F.scaled_dot_product_attention(lq, lk, lv, attn_mask=mask,
                                                   enable_gqa=True),
            decode_cost(case, torch.float32))
    for tag, r in out.items():
        print(f"[times] {tag}: kernel {r['ms']:.4f} ms (call {r['call_ms']:.4f}), "
              f"plain {r['plain_ms']:.4f} ms (call {r['plain_call_ms']:.4f}), "
              f"library {r['library_ms']:.4f} ms (call {r['library_call_ms']:.4f}), "
              f"bound {r['bound_ms']:.4f} ms ({r['bound_by']}); device time "
              f"{'from torch.profiler' if r['device_ms'] is not None else 'not seen: event times'}",
              flush=True)
    return out


def time_three(kernel, plain, library, cost) -> dict:
    """Kernel, plain version and library call on the same inputs, with the
    bound of the function from its bytes and operations."""
    nbytes, ops = cost
    b_ms, b_by = bound(nbytes, ops, torch.float32)
    k, p, lib = timed(kernel), timed(plain), timed(library)
    return {**k, "plain_ms": p["ms"], "plain_call_ms": p["call_ms"],
            "plain_launches": p["launches_per_call"],
            "library_ms": lib["ms"], "library_call_ms": lib["call_ms"],
            "bound_ms": b_ms, "bound_by": b_by, "bytes": nbytes, "ops": ops}


def step_breakdown(what: str, fn) -> dict:
    """Where one serving step's time goes: host-clock wall time (median of
    5, synchronised), device busy time and launches (profiler), idle share,
    and the kernels that take the most device time."""
    fn()
    torch.cuda.synchronize()
    walls = []
    for _ in range(5):
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        walls.append((time.perf_counter() - t0) * 1e3)
    wall = statistics.median(walls)
    kern = device_kernels(fn)
    busy = sum(us for _, us in kern) / 1e3
    by_name: dict = {}
    for name, us in kern:
        by_name[name] = by_name.get(name, 0.0) + us / 1e3
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:5]
    rec = {"wall_ms": wall, "device_busy_ms": busy, "launches": len(kern),
           "idle_share": 1.0 - busy / wall if kern else None,
           "top_kernels_ms": {n[:60]: t for n, t in top}}
    print(f"[profile] {what}: wall {wall:.2f} ms, device busy {busy:.3f} ms, "
          f"{len(kern)} device activities, idle share "
          f"{rec['idle_share'] if kern else 'not measured'}; top "
          + "; ".join(f"{n[:40]} {t:.3f}" for n, t in top), flush=True)
    return rec


def reset_launches() -> None:
    flash_attention.launches = 0
    decode_attention.launches = 0


def check_launches(what: str, prefills: int, steps: int, n_layers: int) -> dict:
    got = {"flash_attention": flash_attention.launches,
           "decode_attention": decode_attention.launches}
    want = {"flash_attention": n_layers * prefills,
            "decode_attention": n_layers * steps}
    print(f"[serve] {what} launches {got} (expected {want})", flush=True)
    if got != want or min(got.values()) <= 0:
        fail(f"{what}: kernel launches {got}, expected {want}")
    return got


def logits_parity(cfg, prompts) -> dict:
    """Prefill and first decode-step logits of one batch on the card vs the
    same engine on the CPU (plain kernel versions, same seeded weights)."""
    got = {}
    for device in ("cuda", "cpu"):
        params = api.init_params(cfg, seed=0, dtype=torch.float32, device=device)
        eng = InferenceEngine(cfg, params, EngineConfig(max_batch=4, cache_len=64))
        toks, kv_len = eng._pad_prompts(prompts)
        lg, cache = eng._prefill(toks, kv_len)
        nxt = greedy(lg, cfg.vocab_size) if device == "cuda" else got["nxt"].cpu()
        lg2, _ = eng._decode(nxt[:, None].long(), cache, kv_len)
        got[device] = (lg.float().cpu(), lg2.float().cpu())
        got["nxt"] = nxt
        del params, eng, cache
    errs = {name: (got["cuda"][i] - got["cpu"][i]).abs().max().item()
            for i, name in enumerate(("prefill", "decode"))}
    for name, err in errs.items():
        print(f"[serve] card vs CPU {name} logits: max_abs_err {err:.3e} "
              f"(tol {TOL_LOGITS})", flush=True)
        if not err <= TOL_LOGITS:
            fail(f"card vs CPU {name} logits differ by {err}")
    return errs


def phase_serve() -> dict:
    cfg = get_config("smollm-135m")
    reset_launches()
    t0 = time.perf_counter()
    res = serve.main(SERVE_ARGS)
    wall = time.perf_counter() - t0
    results = res["results"]
    serve_launches = check_launches("serve", len(results),
                                    sum(r.steps for r in results), cfg.n_layers)
    outs = res["outputs"]
    if len(outs) != 12 or any(not v or any(not 0 <= t < cfg.vocab_size for t in v)
                              for v in outs.values()):
        fail("serve: missing outputs or token ids outside the vocab")

    rng = np.random.default_rng(0)
    prompts = rng.integers(2, cfg.vocab_size, (4, LONG_PROMPT)).tolist()
    batch = Batch(requests=[Request(rid=i, tokens=p, input_len=len(p), slo=1e9,
                                    arrival=0.0, true_output_len=LONG_NEW)
                            for i, p in enumerate(prompts)])
    params = api.init_params(cfg, seed=0, dtype=torch.float32, device="cuda")
    eng = InferenceEngine(cfg, params, EngineConfig(
        max_batch=4, cache_len=LONG_CACHE, max_new_tokens=LONG_NEW))
    true_lens = {r.rid: LONG_NEW for r in batch.requests}
    eng.run_batch(batch, true_lens=true_lens)             # warm-up
    reset_launches()
    long = eng.run_batch(batch, true_lens=true_lens)
    long_launches = check_launches("long batch", 1, long.steps, cfg.n_layers)
    long_tokens = sum(len(v) for v in long.outputs.values())
    if long_tokens != 4 * LONG_NEW:
        fail(f"long batch: {long_tokens} tokens, expected {4 * LONG_NEW}")
    print(f"[serve] long batch: prefill {long.prefill_s * 1e3:.2f} ms "
          f"({4 * LONG_PROMPT / long.prefill_s:.0f} prompt tok/s), decode "
          f"{long.steps} steps in {long.decode_s * 1e3:.2f} ms "
          f"({long_tokens / long.decode_s:.1f} tok/s)", flush=True)
    first = sorted(results[0].outputs)
    reqs = {r.rid: r for r in serve.make_requests(cfg, 12, 16)}
    first_prompts = [reqs[rid].tokens for rid in first]
    profile = {}
    for what, e, prompts in (
            ("long batch", eng, prompts),
            ("serve batch", InferenceEngine(cfg, params, EngineConfig(
                max_batch=4, cache_len=64)), first_prompts)):
        toks, kv_len = e._pad_prompts(prompts)
        profile[f"{what} prefill"] = step_breakdown(
            f"{what} prefill {tuple(toks.shape)}",
            lambda: e._prefill(toks, kv_len))
        lg, cache = e._prefill(toks, kv_len)
        nxt = greedy(lg, cfg.vocab_size)[:, None].long()
        profile[f"{what} decode step"] = step_breakdown(
            f"{what} decode step", lambda: e._decode(nxt, cache, kv_len))
    del params, eng, cache

    errs = logits_parity(cfg, first_prompts)
    return {"serve": {"digest": res["digest"], "tokens": res["tokens"],
                      "seconds": res["seconds"], "wall_s": wall,
                      "tok_per_s": res["tokens"] / res["seconds"],
                      "batches": len(results),
                      "decode_steps": sum(r.steps for r in results),
                      "launches": serve_launches},
            "long_batch": {"prefill_ms": long.prefill_s * 1e3,
                           "decode_ms": long.decode_s * 1e3, "steps": long.steps,
                           "decode_tok_per_s": long_tokens / long.decode_s,
                           "launches": long_launches},
            "profile": profile, "logits_max_abs_err": errs}


def main() -> None:
    t_start = time.perf_counter()
    dev = phase_device()
    built = phase_build()
    parity = phase_parity()
    times = phase_times()
    served = phase_serve()
    launches = {k: served["serve"]["launches"][k] + served["long_batch"]["launches"][k]
                for k in TIMED}
    kernels = []
    for name, case, src, replaces in (
            ("flash_attention", TIMED["flash_attention"],
             "src/repro_torch/kernels/csrc/flash_attention.cu",
             "src/repro/kernels/flash_attention/flash_attention.py:92"),
            ("decode_attention", TIMED["decode_attention"],
             "src/repro_torch/kernels/csrc/decode_attention.cu",
             "src/repro/kernels/decode_attention/decode_attention.py:75")):
        t = times[f"{name}/{case}"]
        kernels.append({
            "name": name, "route": "cuda", "source": src, "replaces": replaces,
            "launches": launches[name],
            "max_abs_err": parity[f"{name}/{case}/float32"]["max_abs_err"],
            "ms": t["ms"], "plain_ms": t["plain_ms"], "bound_ms": t["bound_ms"],
            "bound_by": t["bound_by"], "library_ms": t["library_ms"]})
    record = {"device": dev, "build": built, "parity": parity, "times": times,
              **served, "kernels": kernels,
              "total_s": time.perf_counter() - t_start}
    out_dir = ROOT / "chiprun_out"
    out_dir.mkdir(exist_ok=True)
    (out_dir / "chip_smoke.json").write_text(json.dumps(record, indent=1))
    print(f"[done] {record['total_s']:.1f}s", flush=True)
    print(json.dumps({"kernels": kernels}))
    print(dev["smi"])
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
