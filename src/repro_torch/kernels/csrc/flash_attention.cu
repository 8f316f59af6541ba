// FlashAttention-2 forward for Hopper (sm_90a), plain CUDA C++ with fp32 FMA.
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
// (query, key) pair, 2*(D+Dv) operations, far above the card's
// operations-per-byte balance, so it is bound by operations.  This first
// design computes them with fp32 FMA from shared memory (no tensor cores):
// one block of 256 threads per (64-row query tile, head, batch); K/V tiles of
// 64 rows are staged through shared memory in fp32; each thread owns a 4x4
// micro tile of the score block and a 4 x ceil(Dv/16) micro tile of the
// output, so every shared-memory load feeds several FMAs.  Tiles wholly above
// the causal diagonal or below the window are never loaded.  mma.sync/wgmma
// and TMA are the next designs.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstddef>

namespace {

constexpr int BM = 64;          // query rows per block
constexpr int BN = 64;          // key/value rows per tile
constexpr int NT = 256;         // threads: 16 (ty) x 16 (tx)
constexpr float NEG_INF = -1e30f;  // masked score, as in the TPU kernel

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }
template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

// Thread (ty, tx) owns query rows ty + 16*i (i < 4), score columns
// tx + 16*j (j < 4) and output columns tx + 16*jj (jj < NJ).  The 16 threads
// of one row sit in one half warp, so row reductions are xor shuffles 8..1.
template <typename T, int NJ>
__global__ void __launch_bounds__(NT)
fa_fwd(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
       T* __restrict__ o, int sq, int skv, int h, int kvh, int d, int dv,
       int causal, int window, float softcap, int q_offset, float scale) {
  extern __shared__ float smem[];
  const int dp = d + 1;                 // padded row: conflict-free column reads
  float* qs = smem;                     // [BM][dp], pre-scaled
  float* ks = qs + BM * dp;             // [BN][dp]
  float* vs = ks + BN * dp;             // [BN][dv]
  float* ps = vs + BN * dv;             // [BM][BN + 1] probabilities

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
  int kt_end = (skv + BN - 1) / BN;
  if (causal) kt_end = min(kt_end, q_last / BN + 1);
  int kt_begin = 0;
  if (window > 0) kt_begin = max(0, q_first - window + 1) / BN;

  float m[4], l[4], acc[4][NJ];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = NEG_INF;
    l[i] = 0.f;
#pragma unroll
    for (int jj = 0; jj < NJ; ++jj) acc[i][jj] = 0.f;
  }

  for (int kt = kt_begin; kt < kt_end; ++kt) {
    const int k0 = kt * BN;
    __syncthreads();                    // last tile's readers are done
    for (int i = tid; i < BN * d; i += NT) {
      const int r = i / d, c = i - r * d;
      ks[r * dp + c] = k0 + r < skv ? to_f(kb[(size_t)(k0 + r) * k_row + c]) : 0.f;
    }
    for (int i = tid; i < BN * dv; i += NT) {
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
        rmax = fmaxf(rmax, __shfl_xor_sync(0xffffffffu, rmax, off));
      const float m_new = fmaxf(m[i], rmax);
      const float corr = expf(m[i] - m_new);
      float rsum = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float p = s[i][j] == NEG_INF ? 0.f : expf(s[i][j] - m_new);
        ps[r * (BN + 1) + tx + 16 * j] = p;
        rsum += p;
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        rsum += __shfl_xor_sync(0xffffffffu, rsum, off);
      l[i] = l[i] * corr + rsum;
      m[i] = m_new;
#pragma unroll
      for (int jj = 0; jj < NJ; ++jj) acc[i][jj] *= corr;
    }
    __syncthreads();

    for (int c = 0; c < BN; ++c) {
      float pv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) pv[i] = ps[(ty + 16 * i) * (BN + 1) + c];
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
cudaError_t launch(const void* q, const void* k, const void* v, void* o, int b,
                   int sq, int skv, int h, int kvh, int d, int dv, int causal,
                   int window, float softcap, int q_offset, float scale,
                   cudaStream_t stream) {
  const size_t smem = sizeof(float) *
      ((size_t)(BM + BN) * (d + 1) + (size_t)BN * dv + (size_t)BM * (BN + 1));
  cudaError_t err = cudaFuncSetAttribute(
      fa_fwd<T, NJ>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((sq + BM - 1) / BM, h, b);
  fa_fwd<T, NJ><<<grid, NT, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<T*>(o), sq, skv, h, kvh, d, dv, causal, window, softcap,
      q_offset, scale);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch(const void* q, const void* k, const void* v, void* o, int b,
                     int sq, int skv, int h, int kvh, int d, int dv, int causal,
                     int window, float softcap, int q_offset, float scale,
                     cudaStream_t stream) {
  if (dv <= 64)
    return launch<T, 4>(q, k, v, o, b, sq, skv, h, kvh, d, dv, causal, window,
                        softcap, q_offset, scale, stream);
  if (dv <= 128)
    return launch<T, 8>(q, k, v, o, b, sq, skv, h, kvh, d, dv, causal, window,
                        softcap, q_offset, scale, stream);
  return launch<T, 16>(q, k, v, o, b, sq, skv, h, kvh, d, dv, causal, window,
                       softcap, q_offset, scale, stream);
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16.  window <= 0: no window; softcap <= 0: no
// softcap.  Returns the cudaError_t of the launch (0 on success).
extern "C" int flash_attention_fwd(const void* q, const void* k, const void* v,
                                   void* o, int dtype, int b, int sq, int skv,
                                   int h, int kvh, int d, int dv, int causal,
                                   int window, float softcap, int q_offset,
                                   float scale, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return (int)dispatch<float>(q, k, v, o, b, sq, skv, h, kvh, d, dv, causal,
                                window, softcap, q_offset, scale, st);
  if (dtype == 1)
    return (int)dispatch<__nv_bfloat16>(q, k, v, o, b, sq, skv, h, kvh, d, dv,
                                        causal, window, softcap, q_offset, scale, st);
  return (int)cudaErrorInvalidValue;
}
