"""Time edited copies of the prefill kernel K2 against each other on one
NVIDIA GPU: which part of the kernel costs what, and what a design choice
buys.

    python3 chip_variants.py

Each variant is ``src/repro_torch/kernels/csrc/flash_attention.cu`` as
committed with the text replacements of ``VARIANTS`` (``final`` with none).
All are built at once with nvcc into ``build/variants/``, then run in turns,
forward and back (A, B, ..., B, A), at the shapes of the main path, on the
same f32 inputs.  One JSON line per variant gives, per shape, the median ms
of 30 calls between CUDA events (launch gaps included: at the serve shape
mostly launch) and the max abs error against the plain version.  Variants
marked diagnostic drop work and are wrong on purpose; they say what the
dropped work costs.  Needs a CUDA device; imports no JAX.
"""
from __future__ import annotations

import ctypes
import json
import statistics
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

import torch  # noqa: E402

from repro_torch.kernels import build  # noqa: E402
from repro_torch.kernels.flash_attention.ref import (  # noqa: E402
    flash_attention_reference)

OUT = ROOT / "build" / "variants"
N_TIMED = 30
SHAPES = [  # name, b, sq, h, kv, d (causal, Skv = Sq)
    ("serve_prefill", 4, 16, 9, 3, 64),
    ("long_prefill", 4, 1024, 9, 3, 64),
    ("long_prefill_b1", 1, 1024, 9, 3, 64),
    ("s2048", 4, 2048, 9, 3, 64),
    ("chatglm2_prefill", 2, 1024, 32, 2, 128),
]
PASSES = """  if constexpr (!EXACT_B) {
#pragma unroll
    for (int n = 0; n < N; ++n) mma(d[n], ab, bs[n][0], bs[n][1]);
  }
#pragma unroll
  for (int n = 0; n < N; ++n) mma(d[n], as, bb[n][0], bb[n][1]);
"""
VARIANTS = {
    "final": [],
    # x's TF32 parts with the cvt instruction instead of integer rounding
    "cvt_split": [("""  big = (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
  small = __float_as_uint(x - __uint_as_float(big));""",
                   """  asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(big) : "f"(x));
  asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(small) : "f"(x - __uint_as_float(big)));""")],
    # the three products into one accumulator back to back
    "back_to_back": [(PASSES + """#pragma unroll
  for (int n = 0; n < N; ++n) mma(d[n], ab, bb[n][0], bb[n][1]);""",
                      """#pragma unroll
  for (int n = 0; n < N; ++n) {
    if constexpr (!EXACT_B) mma(d[n], ab, bs[n][0], bs[n][1]);
    mma(d[n], as, bb[n][0], bb[n][1]);
    mma(d[n], ab, bb[n][0], bb[n][1]);
  }""")],
    # p = e^(s - m) with expf on natural-base scores
    "expf": [("  scale *= LOG2E;\n  softcap *= LOG2E;\n", ""),
             ("corr[r] = exp2f(m[r] - mn);", "corr[r] = expf(m[r] - mn);"),
             ("exp2f(s[j][e] - mn)", "expf(s[j][e] - mn)")],
    # 64 rows of a head a block even where the blocks do not cover the SMs
    "no_adaptive_rows": [("  while (wp > 1 &&", "  while (false && wp > 1 &&")],
    # 64-key tiles in 2 stages (36 KB of shared memory more at D = 64)
    "bn64_ns2": [("constexpr int BN = 32;", "constexpr int BN = 64;"),
                 ("constexpr int NS = 3;", "constexpr int NS = 2;")],
    # diagnostic: one TF32 product (big.big) instead of three
    "diag_one_tf32": [(PASSES, "")],
    # diagnostic: no S = Q.K^T product
    "diag_no_qk": [("      mma3<EXACT>(s, ab, as, kb);", "")],
    # diagnostic: no O += P.V product
    "diag_no_pv": [("      mma3<EXACT>(acc, ab, as, vb);", "")],
    # diagnostic: no exponentials (p = s)
    "diag_no_exp": [("corr[r] = exp2f(m[r] - mn);", "corr[r] = 1.f;"),
                    ("s[j][e] == NEG_INF ? 0.f : exp2f(s[j][e] - mn)", "s[j][e]")],
}


def build_variants() -> None:
    src = (build.CSRC / "flash_attention.cu").read_text()
    OUT.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name, reps in VARIANTS.items():
        text = src
        for old, new in reps:
            if text.count(old) != 1:
                sys.exit(f"{name}: the text to replace is not in the source once")
            text = text.replace(old, new)
        path = OUT / f"{name}.cu"
        path.write_text(text)
        cmd = [build.nvcc_path(), *build.NVCC_FLAGS, "-o", str(path.with_suffix(".so")),
               str(path)]
        procs[name] = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                       stderr=subprocess.STDOUT, text=True)
    for name, proc in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            sys.exit(f"{name}: nvcc exit {proc.returncode}\n{log[-3000:]}")


def main() -> None:
    if not torch.cuda.is_available():
        sys.exit("chip_variants.py needs a CUDA device")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True).stdout.strip().splitlines()[0]
    print(f"[device] {smi}", flush=True)
    build_variants()
    gen = torch.Generator(device="cuda").manual_seed(0)
    inputs = {}
    for name, b, s, h, kv, d in SHAPES:
        q = torch.randn(b, s, h, d, generator=gen, device="cuda")
        k = torch.randn(b, s, kv, d, generator=gen, device="cuda")
        v = torch.randn(b, s, kv, d, generator=gen, device="cuda")
        inputs[name] = (q, k, v, torch.empty_like(q), flash_attention_reference(q, k, v))
    res: dict = {name: {} for name in VARIANTS}
    for name in list(VARIANTS) + list(reversed(VARIANTS)):
        fn = ctypes.CDLL(str(OUT / f"{name}.so")).flash_attention_fwd
        fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 9 + [
            ctypes.c_int, ctypes.c_float, ctypes.c_int, ctypes.c_float, ctypes.c_void_p]
        for shape, b, s, h, kv, d in SHAPES:
            q, k, v, o, want = inputs[shape]
            stream = torch.cuda.current_stream().cuda_stream

            def call():
                err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), 0, b,
                         s, s, h, kv, d, d, 1, 0, 0.0, 0, d ** -0.5, stream)
                if err:
                    sys.exit(f"{name} {shape}: CUDA error {err}")
            for _ in range(3):
                call()
            torch.cuda.synchronize()
            times = []
            for _ in range(N_TIMED):
                start = torch.cuda.Event(enable_timing=True)
                end = torch.cuda.Event(enable_timing=True)
                start.record()
                call()
                end.record()
                end.synchronize()
                times.append(start.elapsed_time(end))
            rec = res[name].setdefault(shape, {"ms": [], "max_abs_err": None})
            rec["ms"].append(statistics.median(times))
            rec["max_abs_err"] = (o - want).abs().max().item()
    for name, shapes in res.items():
        print(json.dumps({"variant": name, **shapes}), flush=True)


if __name__ == "__main__":
    main()
