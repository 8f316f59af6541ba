// FlashAttention-2 forward for Hopper (sm_90a), CUDA C++ on the tensor cores
// at fp32 accuracy (3xTF32 mma.sync).
//
// Replaces the TPU kernel flash_attention_pallas
// (src/repro/kernels/flash_attention/flash_attention.py:92, body _fa_kernel
// :28): GQA by index (query head h reads KV head h / group, no K/V repeat),
// causal masking at absolute positions via q_offset, optional sliding window
// and tanh softcap, a non-causal mode, ragged Sq/Skv masked in the kernel,
// online softmax in fp32, output in q's dtype.
//
// Layouts are the JAX package's: q [B, Sq, H, D], k [B, Skv, KV, D],
// v [B, Skv, KV, Dv], o [B, Sq, H, Dv], all contiguous; f32 or bf16.
//
// What bounds it on the H100: at prefill lengths the work is two products per
// visible (query, key) pair, 2*(D+Dv) operations, far above the card's
// operations-per-byte balance, so it is bound by operations.  The fastest
// route to products at fp32 accuracy is the tensor cores in TF32 with each
// operand split in two (3xTF32: 495 / 3 = 165 TFLOP/s against 67 for fp32
// FMA).  The design of the tensor-core instances (D = Dv = 64, the main
// path's smollm-135m; D = Dv = 128, chatglm2-6b and qwen2-1.5b):
//
// - 3xTF32 mma.sync.m16n8k8 for S = Q.K^T and O += P.V: x = big + small,
//   big = x rounded to TF32 (as cvt.rna.tf32), small = x - big; each product
//   is small.big + big.small + big.big, accumulated in fp32 (one TF32
//   product is ~1e-3 off at S = 1024, D = 64; the three ~4e-6 off the fp32
//   plain version on the card).  bf16 inputs take the same path: a bf16 K or
//   V value is exact in TF32, so its small part is 0 and its products are
//   two, not three (Q is scaled in fp32 and P is fp32, so those are split).
// - One warp owns 16 query rows of one head, keeps its Q rows (fp32,
//   pre-scaled) in shared memory and its score tile and output rows in
//   registers; row max and sum are quad shuffles.  P never leaves the
//   registers: the accumulator fragment of S holds keys 2t, 2t+1 of each 8,
//   and the P.V product reads that fragment as its A operand with the key
//   order permuted to match (A column t <- key 2t, column t + 4 <- key
//   2t + 1), and V's B fragment is read in the same order.  No shuffles, no
//   shared round trip, no block-wide sync for P.
// - GQA packing: a block serves up to 8 query heads that share one KV head
//   (the group, split evenly over blocks above 8 heads: chatglm2-6b's 16 run
//   as two blocks of 8) at up to 64 positions (16 a warp), so each K/V tile
//   is staged once for all of them.  At <= 16-token prompts a block is the
//   group's heads at one 16-row tile: no padding rows beyond the prompt's.
// - K/V tiles of 32 keys are copied with 16-byte cp.async into a ring of 3
//   stages, two tiles in flight while one is computed; one __syncthreads a
//   tile (f32: 78 KB of shared memory with Q at D = 64, two blocks an SM;
//   165 KB at D = 128).  Staged rows are padded
//   by 16 bytes, so the lanes' fragment reads of K (key g, column t) and of V
//   (key 2t, column g) fall in distinct banks.
// - Heaviest query tiles first: the block scheduler takes blockIdx.y in
//   order, and y = 0 is the last query tile, the longest under the causal
//   mask.
// - Tiles wholly above the causal diagonal or below the window are never
//   loaded; masks are applied only to tiles that cross an edge.
//
// What bounds it now (PERF.md; chip_variants.py times variants of this
// file): the products.  One TF32 product instead of three takes the long
// prefill to two thirds of its time: each TF32 pass runs at under half the
// 495 TFLOP/s that wgmma reaches, and the two extra passes of 3xTF32 cost a
// third of the kernel.  The exponentials cost a few percent.  Slower
// and left out: two 16-row tiles a warp (168-180 registers, one block an
// SM), and guards that skip the 8-key steps past the diagonal (branches in
// the unrolled products).  wgmma and TMA are the next design: their TF32
// form wants K-major shared descriptors and swizzled layouts.
//
// Other head dimensions (8, 16, 32, 96/64, 256, ...) and K/V not 16-byte
// aligned take the general instance below, the first port's SIMT design:
// fp32 FMA from shared memory, one block of 256 threads per (64-row query
// tile, head, batch), 4x4 micro tiles.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <algorithm>
#include <cstddef>
#include <cstdint>

namespace {

constexpr float NEG_INF = -1e30f;  // masked score, as in the TPU kernel
constexpr unsigned FULL = 0xffffffffu;
constexpr int MAX_HEAD_DIM = 256;

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }
template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

// 16 bytes global -> shared, asynchronous; zero-filled when !valid (src is
// then not read).  The same helpers as decode_common.cuh's (copied, so this
// library does not rebuild with the decode kernels' header).
__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool valid) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s), "l"(src),
               "r"(valid ? 16 : 0));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n"); }
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// ---------------------------------------------------------------------------
// Tensor-core instances.

constexpr int MAXW = 8;    // warps a block: heads x 16-row tiles
constexpr int MAX_WP = 4;  // 16-row tiles of one head a block (64 positions)
constexpr int BN = 32;     // keys a K/V tile
constexpr int NS = 3;      // stages of the K/V ring

// x = big + small: big is x rounded to TF32, to nearest with ties away from
// zero (cvt.rna.tf32.f32's rounding in two integer operations, which
// chip_variants.py times faster than the cvt); small = x - big is exact in
// fp32 and goes to the tensor core as it is, which reads the TF32 bits of an
// operand: its last bits are truncated (~2^-21 of x, under the fp32
// accumulation's own error; the error against the plain version is the
// cvt's).
__device__ __forceinline__ void split(float x, unsigned& big, unsigned& small) {
  big = (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
  small = __float_as_uint(x - __uint_as_float(big));
}

// d += a.b for a 16x8 A fragment, an 8x8 B fragment and a 16x8 fp32 d.
__device__ __forceinline__ void mma(float (&d)[4], const unsigned (&a)[4], unsigned b0,
                                    unsigned b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// d[n] += a.b[n] for N tiles at fp32 accuracy: (ab, as) is A split in big
// and small parts; b[n] holds B's two values of tile n, split here.  The
// small products come first, and each of the three passes runs over all N
// tiles, so the products into one accumulator are N apart, not back to back
// (faster at D = 128, chip_variants.py).  EXACT_B: B is exact in TF32 (bf16
// input), its small part 0.
template <bool EXACT_B, int N>
__device__ __forceinline__ void mma3(float (&d)[N][4], const unsigned (&ab)[4],
                                     const unsigned (&as)[4], const float (&b)[N][2]) {
  unsigned bb[N][2], bs[N][2];
#pragma unroll
  for (int n = 0; n < N; ++n)
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      if constexpr (EXACT_B)
        bb[n][e] = __float_as_uint(b[n][e]);
      else
        split(b[n][e], bb[n][e], bs[n][e]);
    }
  if constexpr (!EXACT_B) {
#pragma unroll
    for (int n = 0; n < N; ++n) mma(d[n], ab, bs[n][0], bs[n][1]);
  }
#pragma unroll
  for (int n = 0; n < N; ++n) mma(d[n], as, bb[n][0], bb[n][1]);
#pragma unroll
  for (int n = 0; n < N; ++n) mma(d[n], ab, bb[n][0], bb[n][1]);
}

__device__ __forceinline__ void store2(float* p, float a, float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
}
__device__ __forceinline__ void store2(__nv_bfloat16* p, float a, float b) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
}

// The K/V ring (NS stages of BN K rows and BN V rows of T, padded by 16
// bytes), then each of the nw warps' 16 Q rows (fp32, padded by 4).
template <typename T, int D>
constexpr size_t mma_smem(int nw) {
  return (size_t)NS * 2 * BN * (D + 16 / sizeof(T)) * sizeof(T) +
         (size_t)nw * 16 * (D + 4) * sizeof(float);
}

// A warp owns 16 consecutive query rows of one head.  Lane (g, t) =
// (lane / 4, lane % 4) holds, in m16n8k8 order, rows g and g + 8: the A
// fragment of Q at columns t, t + 4 of each 8 dims (read from the warp's Q
// rows in shared memory at each tile; held in registers, Q and its split
// parts took 2 D of them and the D = 128 instance spilled), and the
// accumulators of S (keys 2t, 2t + 1 of each 8) and of O (columns 2t,
// 2t + 1 of each 8).
template <typename T, int D>
__global__ void __launch_bounds__(MAXW * 32)
fa_fwd_mma(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
           T* __restrict__ o, int sq, int skv, int h, int kvh, int hc, int wp, int nhc,
           int causal, int window, float softcap, int q_offset, float scale) {
  constexpr bool EXACT = sizeof(T) == 2;
  constexpr int STR = D + 16 / sizeof(T);     // staged row, elements
  constexpr int NK = D / 8;                   // 8-wide steps over D (and Dv)
  constexpr int NN = BN / 8;                  // 8-key steps over a tile
  constexpr int CPR = D * sizeof(T) / 16;     // 16-byte pieces a row
  constexpr int VEC = 16 / sizeof(T);
  constexpr int QSTR = D + 4;                 // Q row, floats
  constexpr float LOG2E = 1.44269504088896341f;
  extern __shared__ __align__(16) unsigned char smem[];
  T* const ring = reinterpret_cast<T*>(smem);  // NS x {K, V} x [BN][STR]

  // Scores in base 2 (Q scaled by log2 e, softcap likewise), so p = 2^(s - m)
  // is one ex2 (faster than expf, chip_variants.py); the softmax is the
  // same.
  scale *= LOG2E;
  softcap *= LOG2E;
  const int group = h / kvh;
  const int qp = 16 * wp;                      // query rows a block, per head
  const int qt = gridDim.y - 1 - blockIdx.y;   // heaviest tiles first
  int x = blockIdx.x;
  const int chunk = x % nhc;
  x /= nhc;
  const int kh = x % kvh, b = x / kvh;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int gh = chunk * hc + warp / wp;       // head within the group
  const int head = kh * group + gh;
  const int p0 = qt * qp + (warp % wp) * 16;   // the warp's first query row
  const bool active = gh < group && p0 < sq;

  // KV tiles the block can see at all, and the warp's absolute rows.
  const int qa_lo_blk = q_offset + qt * qp;
  const int qa_hi_blk = q_offset + min(sq, (qt + 1) * qp) - 1;
  int kt_end = (skv + BN - 1) / BN;
  if (causal) kt_end = min(kt_end, qa_hi_blk / BN + 1);
  const int kt_begin = window > 0 ? max(0, qa_lo_blk - window + 1) / BN : 0;
  const int ntiles = max(0, kt_end - kt_begin);
  const int qa_lo = q_offset + p0, qa_hi = q_offset + min(p0 + 15, sq - 1);

  auto load_tile = [&](int i) {  // tile kt_begin + i into stage i % NS
    T* ks = ring + (size_t)(i % NS) * 2 * BN * STR;
    T* vs = ks + BN * STR;
    const int k0 = (kt_begin + i) * BN;
    for (int c = threadIdx.x; c < BN * CPR; c += blockDim.x) {
      const int r = c / CPR, off = (c % CPR) * VEC;
      const int pos = k0 + r;
      const bool ok = pos < skv;
      const size_t row = ((size_t)b * skv + (ok ? pos : 0)) * kvh + kh;
      cp_async16(ks + r * STR + off, k + row * D + off, ok);
      cp_async16(vs + r * STR + off, v + row * D + off, ok);
    }
  };
#pragma unroll
  for (int i = 0; i < NS - 1; ++i) {
    if (i < ntiles) load_tile(i);
    cp_async_commit();
  }

  // The warp's Q rows, scaled, zero past sq, staged while the first K/V
  // tiles are in flight; the warp alone reads them.
  float* const qs = reinterpret_cast<float*>(smem + (size_t)NS * 2 * BN * STR * sizeof(T)) +
                    warp * 16 * QSTR;
  for (int i = lane; i < 16 * D; i += 32) {
    const int r = i / D, c = i % D;
    qs[r * QSTR + c] = active && p0 + r < sq
                           ? to_f(q[(((size_t)b * sq + p0 + r) * h + head) * D + c]) * scale
                           : 0.f;
  }
  __syncwarp();

  float m[2] = {NEG_INF, NEG_INF}, l[2] = {0.f, 0.f}, acc[NK][4];
#pragma unroll
  for (int n = 0; n < NK; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;

  for (int i = 0; i < ntiles; ++i) {
    cp_async_wait<NS - 2>();   // tile i has landed (for this thread's copies)
    __syncthreads();           // for everyone's; stage (i - 1) % NS is free
    if (i + NS - 1 < ntiles) load_tile(i + NS - 1);
    cp_async_commit();
    const int k0 = (kt_begin + i) * BN;
    if (!active || (causal && k0 > qa_hi) ||
        (window > 0 && k0 + BN - 1 <= qa_lo - window))
      continue;
    const T* ks = ring + (size_t)(i % NS) * 2 * BN * STR;
    const T* vs = ks + BN * STR;

    float s[NN][4];
#pragma unroll
    for (int j = 0; j < NN; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < NK; ++kk) {
      unsigned ab[4], as[4];
#pragma unroll
      for (int e = 0; e < 4; ++e)
        split(qs[(g + 8 * (e & 1)) * QSTR + 8 * kk + t + 4 * (e >> 1)], ab[e], as[e]);
      float kb[NN][2];
#pragma unroll
      for (int j = 0; j < NN; ++j) {
        const T* kr = ks + (8 * j + g) * STR + 8 * kk + t;
        kb[j][0] = to_f(kr[0]);
        kb[j][1] = to_f(kr[4]);
      }
      mma3<EXACT>(s, ab, as, kb);
    }

    const bool edge = k0 + BN > skv || (causal && k0 + BN - 1 > qa_lo) ||
                      (window > 0 && k0 <= qa_hi - window);
#pragma unroll
    for (int j = 0; j < NN; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float xv = s[j][e];
        if (softcap > 0.f) xv = softcap * tanhf(xv / softcap);
        if (edge) {
          const int kp = k0 + 8 * j + 2 * t + (e & 1);
          const int qa = qa_lo + g + 8 * (e >> 1);
          bool ok = kp < skv;
          if (causal) ok = ok && kp <= qa;
          if (window > 0) ok = ok && kp > qa - window;
          if (!ok) xv = NEG_INF;
        }
        s[j][e] = xv;
      }

    float corr[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      float mx = NEG_INF;
#pragma unroll
      for (int j = 0; j < NN; ++j) mx = fmaxf(mx, fmaxf(s[j][2 * r], s[j][2 * r + 1]));
      mx = fmaxf(mx, __shfl_xor_sync(FULL, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(FULL, mx, 2));
      const float mn = fmaxf(m[r], mx);
      corr[r] = exp2f(m[r] - mn);
      m[r] = mn;
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < NN; ++j)
#pragma unroll
        for (int e = 2 * r; e < 2 * r + 2; ++e) {
          const float p = s[j][e] == NEG_INF ? 0.f : exp2f(s[j][e] - mn);
          s[j][e] = p;
          sum += p;
        }
      l[r] = l[r] * corr[r] + sum;   // this lane's share; quad sum at the end
    }
#pragma unroll
    for (int n = 0; n < NK; ++n) {
      acc[n][0] *= corr[0];
      acc[n][1] *= corr[0];
      acc[n][2] *= corr[1];
      acc[n][3] *= corr[1];
    }

    // O += P.V over the tile's keys, 8 at a time: A column t is key 2t,
    // column t + 4 key 2t + 1, which is where the S accumulator holds them.
#pragma unroll
    for (int kk = 0; kk < NN; ++kk) {
      unsigned ab[4], as[4];
      split(s[kk][0], ab[0], as[0]);
      split(s[kk][2], ab[1], as[1]);
      split(s[kk][1], ab[2], as[2]);
      split(s[kk][3], ab[3], as[3]);
      const T* vr = vs + (8 * kk + 2 * t) * STR + g;
      float vb[NK][2];
#pragma unroll
      for (int n = 0; n < NK; ++n) {
        vb[n][0] = to_f(vr[8 * n]);
        vb[n][1] = to_f(vr[STR + 8 * n]);
      }
      mma3<EXACT>(acc, ab, as, vb);
    }
  }
  cp_async_wait<0>();

  if (!active) return;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    float den = l[r];
    den += __shfl_xor_sync(FULL, den, 1);
    den += __shfl_xor_sync(FULL, den, 2);
    den = fmaxf(den, 1e-30f);
    const int row = p0 + g + 8 * r;
    if (row >= sq) continue;
    T* orow = o + (((size_t)b * sq + row) * h + head) * D + 2 * t;
#pragma unroll
    for (int n = 0; n < NK; ++n)
      store2(orow + 8 * n, acc[n][2 * r] / den, acc[n][2 * r + 1] / den);
  }
}

struct Call {
  const void *q, *k, *v;
  void* o;
  int b, sq, skv, h, kvh, d, dv, causal, window;
  float softcap;
  int q_offset;
  float scale;
  cudaStream_t stream;
};

template <typename T, int D>
cudaError_t launch_mma(const Call& a) {
  static const cudaError_t attr = cudaFuncSetAttribute(
      fa_fwd_mma<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)mma_smem<T, D>(MAXW));
  if (attr != cudaSuccess) return attr;
  const int group = a.h / a.kvh;
  const int nhc = (group + MAXW - 1) / MAXW;        // blocks a group
  const int hc = (group + nhc - 1) / nhc;           // heads a block
  static const int sms = [] {
    int dev = 0, n = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev);
    return n;
  }();
  // Up to MAX_WP 16-row tiles of each head a block, fewer where the blocks
  // would not cover the SMs (a single 1k prompt: 192 blocks of 3 warps, not
  // 96 of 6; the longest block sets the time; chip_variants.py).
  int wp = std::max(1, std::min({MAXW / hc, MAX_WP, (a.sq + 15) / 16}));
  while (wp > 1 && (long long)nhc * a.kvh * a.b * ((a.sq + 16 * wp - 1) / (16 * wp)) < sms)
    wp /= 2;
  const int qtiles = (a.sq + 16 * wp - 1) / (16 * wp);
  if (qtiles > 65535) return cudaErrorInvalidConfiguration;
  const size_t smem = mma_smem<T, D>(hc * wp);
  fa_fwd_mma<T, D><<<dim3(nhc * a.kvh * a.b, qtiles), hc * wp * 32, smem, a.stream>>>(
      static_cast<const T*>(a.q), static_cast<const T*>(a.k), static_cast<const T*>(a.v),
      static_cast<T*>(a.o), a.sq, a.skv, a.h, a.kvh, hc, wp, nhc, a.causal, a.window,
      a.softcap, a.q_offset, a.scale);
  return cudaGetLastError();
}

// ---------------------------------------------------------------------------
// The general instance: fp32 FMA from shared memory.

constexpr int BM = 64;          // query rows per block
constexpr int BNS = 64;         // key/value rows per tile
constexpr int NT = 256;         // threads: 16 (ty) x 16 (tx)

constexpr size_t simt_smem(int d, int dv) {
  return sizeof(float) *
         ((size_t)(BM + BNS) * (d + 1) + (size_t)BNS * dv + (size_t)BM * (BNS + 1));
}

// Thread (ty, tx) owns query rows ty + 16*i (i < 4), score columns
// tx + 16*j (j < 4) and output columns tx + 16*jj (jj < NJ).  The 16 threads
// of one row sit in one half warp, so row reductions are xor shuffles 8..1.
template <typename T, int NJ>
__global__ void __launch_bounds__(NT)
fa_fwd_simt(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
            T* __restrict__ o, int sq, int skv, int h, int kvh, int d, int dv,
            int causal, int window, float softcap, int q_offset, float scale) {
  extern __shared__ float smem_f[];
  const int dp = d + 1;                 // padded row: conflict-free column reads
  float* qs = smem_f;                   // [BM][dp], pre-scaled
  float* ks = qs + BM * dp;             // [BNS][dp]
  float* vs = ks + BNS * dp;            // [BNS][dv]
  float* ps = vs + BNS * dv;            // [BM][BNS + 1] probabilities

  const int q0 = blockIdx.x * BM;
  const int head = blockIdx.y;
  const int b = blockIdx.z;
  const int kh = head / (h / kvh);
  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;

  const size_t q_row = (size_t)h * d, k_row = (size_t)kvh * d;
  const size_t v_row = (size_t)kvh * dv, o_row = (size_t)h * dv;
  const T* qb = q + (size_t)b * sq * q_row + (size_t)head * d;
  const T* kb = k + (size_t)b * skv * k_row + (size_t)kh * d;
  const T* vb = v + (size_t)b * skv * v_row + (size_t)kh * dv;
  T* ob = o + (size_t)b * sq * o_row + (size_t)head * dv;

  for (int i = tid; i < BM * d; i += NT) {
    const int r = i / d, c = i - r * d;
    qs[r * dp + c] = q0 + r < sq ? to_f(qb[(size_t)(q0 + r) * q_row + c]) * scale : 0.f;
  }

  // KV tiles this query tile can see at all.
  const int q_first = q_offset + q0;
  const int q_last = q_offset + min(sq, q0 + BM) - 1;
  int kt_end = (skv + BNS - 1) / BNS;
  if (causal) kt_end = min(kt_end, q_last / BNS + 1);
  int kt_begin = 0;
  if (window > 0) kt_begin = max(0, q_first - window + 1) / BNS;

  float m[4], l[4], acc[4][NJ];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = NEG_INF;
    l[i] = 0.f;
#pragma unroll
    for (int jj = 0; jj < NJ; ++jj) acc[i][jj] = 0.f;
  }

  for (int kt = kt_begin; kt < kt_end; ++kt) {
    const int k0 = kt * BNS;
    __syncthreads();                    // last tile's readers are done
    for (int i = tid; i < BNS * d; i += NT) {
      const int r = i / d, c = i - r * d;
      ks[r * dp + c] = k0 + r < skv ? to_f(kb[(size_t)(k0 + r) * k_row + c]) : 0.f;
    }
    for (int i = tid; i < BNS * dv; i += NT) {
      const int r = i / dv, c = i - r * dv;
      vs[r * dv + c] = k0 + r < skv ? to_f(vb[(size_t)(k0 + r) * v_row + c]) : 0.f;
    }
    __syncthreads();

    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
    for (int c = 0; c < d; ++c) {
      float qv[4], kv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) qv[i] = qs[(ty + 16 * i) * dp + c];
#pragma unroll
      for (int j = 0; j < 4; ++j) kv[j] = ks[(tx + 16 * j) * dp + c];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = fmaf(qv[i], kv[j], s[i][j]);
    }

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = ty + 16 * i;
      const int qa = q_offset + q0 + r;           // absolute query position
      const bool q_ok = q0 + r < sq;
      float rmax = NEG_INF;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int kp = k0 + tx + 16 * j;
        float x = s[i][j];
        if (softcap > 0.f) x = softcap * tanhf(x / softcap);
        bool ok = q_ok && kp < skv;
        if (causal) ok = ok && kp <= qa;
        if (window > 0) ok = ok && kp > qa - window;
        s[i][j] = ok ? x : NEG_INF;
        rmax = fmaxf(rmax, s[i][j]);
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        rmax = fmaxf(rmax, __shfl_xor_sync(FULL, rmax, off));
      const float m_new = fmaxf(m[i], rmax);
      const float corr = expf(m[i] - m_new);
      float rsum = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float p = s[i][j] == NEG_INF ? 0.f : expf(s[i][j] - m_new);
        ps[r * (BNS + 1) + tx + 16 * j] = p;
        rsum += p;
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        rsum += __shfl_xor_sync(FULL, rsum, off);
      l[i] = l[i] * corr + rsum;
      m[i] = m_new;
#pragma unroll
      for (int jj = 0; jj < NJ; ++jj) acc[i][jj] *= corr;
    }
    __syncthreads();

    for (int c = 0; c < BNS; ++c) {
      float pv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) pv[i] = ps[(ty + 16 * i) * (BNS + 1) + c];
#pragma unroll
      for (int jj = 0; jj < NJ; ++jj) {
        const int col = tx + 16 * jj;
        const float vv = col < dv ? vs[c * dv + col] : 0.f;
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[i][jj] = fmaf(pv[i], vv, acc[i][jj]);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = q0 + ty + 16 * i;
    if (r >= sq) continue;
    const float den = fmaxf(l[i], 1e-30f);
#pragma unroll
    for (int jj = 0; jj < NJ; ++jj) {
      const int col = tx + 16 * jj;
      if (col < dv) ob[(size_t)r * o_row + col] = from_f<T>(acc[i][jj] / den);
    }
  }
}

template <typename T, int NJ>
cudaError_t launch_simt(const Call& a) {
  static const cudaError_t attr =
      cudaFuncSetAttribute(fa_fwd_simt<T, NJ>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           (int)simt_smem(MAX_HEAD_DIM, 16 * NJ));
  if (attr != cudaSuccess) return attr;
  const dim3 grid((a.sq + BM - 1) / BM, a.h, a.b);
  fa_fwd_simt<T, NJ><<<grid, NT, simt_smem(a.d, a.dv), a.stream>>>(
      static_cast<const T*>(a.q), static_cast<const T*>(a.k), static_cast<const T*>(a.v),
      static_cast<T*>(a.o), a.sq, a.skv, a.h, a.kvh, a.d, a.dv, a.causal, a.window,
      a.softcap, a.q_offset, a.scale);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch(const Call& a) {
  if (a.d > MAX_HEAD_DIM || a.dv > MAX_HEAD_DIM) return cudaErrorInvalidValue;
  // cp.async copies 16-byte pieces: K and V must start on a 16-byte boundary
  const bool aligned =
      ((reinterpret_cast<uintptr_t>(a.k) | reinterpret_cast<uintptr_t>(a.v)) & 15) == 0;
  if (aligned && a.d == a.dv && a.d == 64) return launch_mma<T, 64>(a);
  if (aligned && a.d == a.dv && a.d == 128) return launch_mma<T, 128>(a);
  if (a.dv <= 64) return launch_simt<T, 4>(a);
  if (a.dv <= 128) return launch_simt<T, 8>(a);
  return launch_simt<T, 16>(a);
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16.  window <= 0: no window; softcap <= 0: no
// softcap.  Returns the cudaError_t of the launch (0 on success).
extern "C" int flash_attention_fwd(const void* q, const void* k, const void* v,
                                   void* o, int dtype, int b, int sq, int skv,
                                   int h, int kvh, int d, int dv, int causal,
                                   int window, float softcap, int q_offset,
                                   float scale, void* stream) {
  const Call a{q, k, v, o, b, sq, skv, h, kvh, d, dv, causal, window, softcap,
               q_offset, scale, static_cast<cudaStream_t>(stream)};
  if (dtype == 0) return (int)dispatch<float>(a);
  if (dtype == 1) return (int)dispatch<__nv_bfloat16>(a);
  return (int)cudaErrorInvalidValue;
}
