// Flash-decoding for Hopper (sm_90a), plain CUDA C++ with fp32 FMA.
//
// Replaces the TPU kernel decode_attention_pallas
// (src/repro/kernels/decode_attention/decode_attention.py:75, body _dec_kernel
// :23): one query token per sequence attends to a contiguous KV cache with a
// per-sequence valid length kv_len; optional window (positions >
// kv_len - 1 - window) and tanh softcap; positions past kv_len are never
// read; online softmax in fp32, output in q's dtype.
//
// Layouts are the JAX package's: q [B, H, D], k [B, S, KV, D],
// v [B, S, KV, Dv], kv_len [B] int32, o [B, H, Dv], all contiguous; f32/bf16.
//
// What bounds it on the H100: every valid K/V row is read once for only
// 2*G*(D+Dv) operations (G = query heads per KV head), so it is bound by the
// bytes of K/V.  This first design gives one block of 8 warps to each
// (batch, KV head, chunk of <= 8 query heads of the group): the G heads are
// the rows; the warps stride over 32-position tiles of the valid range
// [max(0, kv_len - window), kv_len), one position per lane for the scores
// and one output column per lane for P.V; each warp keeps its own fp32
// (m, l, acc) and the block merges them at the end.  At the serve shapes
// (B <= 4, KV = 3) that is 12 blocks on 132 SMs; splitting the sequence
// across blocks with a (acc, m, l) combine pass is the next design.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstddef>

namespace {

constexpr int NW = 8;            // warps per block
constexpr int NT = NW * 32;
constexpr int MAXD = 256;        // D, Dv <= 256
constexpr int NDV = MAXD / 32;   // output columns per lane
constexpr float NEG_INF = -1e30f;
constexpr unsigned FULL = 0xffffffffu;

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }
template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) x = fmaxf(x, __shfl_xor_sync(FULL, x, off));
  return x;
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) x += __shfl_xor_sync(FULL, x, off);
  return x;
}

// GR: query rows per block (a power of two >= the rows it serves, <= 8).
template <typename T, int GR>
__global__ void __launch_bounds__(NT)
dec_fwd(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
        const int* __restrict__ kv_len, T* __restrict__ o, int s, int h, int kvh,
        int d, int dv, int window, float softcap, float scale) {
  __shared__ float qs[GR][MAXD];
  __shared__ float os[GR][MAXD];
  __shared__ float ms[NW][GR];
  __shared__ float ls[NW][GR];

  const int group = h / kvh;
  const int g0 = blockIdx.x * GR;
  const int ng = min(GR, group - g0);
  const int kh = blockIdx.y, b = blockIdx.z;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int head0 = kh * group + g0;
  // The cache has s slots: a length past them reads no further, as the
  // reference's mask over the s slots does.
  const int len = max(0, min(kv_len[b], s));
  const int lo = window > 0 ? max(0, len - window) : 0;

  for (int i = threadIdx.x; i < GR * d; i += NT) {
    const int r = i / d, c = i - r * d;
    qs[r][c] = r < ng ? to_f(q[((size_t)b * h + head0 + r) * d + c]) * scale : 0.f;
  }
  for (int i = threadIdx.x; i < GR * dv; i += NT) os[i / dv][i % dv] = 0.f;
  __syncthreads();

  const size_t k_row = (size_t)kvh * d, v_row = (size_t)kvh * dv;
  const T* kb = k + (size_t)b * s * k_row + (size_t)kh * d;
  const T* vb = v + (size_t)b * s * v_row + (size_t)kh * dv;

  float m[GR], l[GR], acc[GR][NDV];
#pragma unroll
  for (int g = 0; g < GR; ++g) {
    m[g] = NEG_INF;
    l[g] = 0.f;
#pragma unroll
    for (int jj = 0; jj < NDV; ++jj) acc[g][jj] = 0.f;
  }

  for (int t0 = lo + warp * 32; t0 < len; t0 += NW * 32) {
    const int pos = t0 + lane;
    const bool ok = pos < len;
    float sc[GR];
#pragma unroll
    for (int g = 0; g < GR; ++g) sc[g] = 0.f;
    if (ok) {
      const T* kr = kb + (size_t)pos * k_row;
      for (int c = 0; c < d; ++c) {
        const float kv = to_f(kr[c]);
#pragma unroll
        for (int g = 0; g < GR; ++g) sc[g] = fmaf(qs[g][c], kv, sc[g]);
      }
    }
    float p[GR];
#pragma unroll
    for (int g = 0; g < GR; ++g) {
      float x = sc[g];
      if (softcap > 0.f) x = softcap * tanhf(x / softcap);
      x = ok ? x : NEG_INF;
      const float m_new = fmaxf(m[g], warp_max(x));
      const float corr = expf(m[g] - m_new);
      p[g] = ok ? expf(x - m_new) : 0.f;
      l[g] = l[g] * corr + warp_sum(p[g]);
      m[g] = m_new;
#pragma unroll
      for (int jj = 0; jj < NDV; ++jj) acc[g][jj] *= corr;
    }
    const int n_valid = min(32, len - t0);
    for (int j = 0; j < n_valid; ++j) {
      const T* vr = vb + (size_t)(t0 + j) * v_row;
      float vv[NDV];
#pragma unroll
      for (int jj = 0; jj < NDV; ++jj) {
        const int col = lane + 32 * jj;
        vv[jj] = col < dv ? to_f(vr[col]) : 0.f;
      }
#pragma unroll
      for (int g = 0; g < GR; ++g) {
        const float pj = __shfl_sync(FULL, p[g], j);
#pragma unroll
        for (int jj = 0; jj < NDV; ++jj) acc[g][jj] = fmaf(pj, vv[jj], acc[g][jj]);
      }
    }
  }

  // Merge the warps' partials: weights exp(m_w - max_w m_w), in warp order.
  if (lane == 0) {
#pragma unroll
    for (int g = 0; g < GR; ++g) {
      ms[warp][g] = m[g];
      ls[warp][g] = l[g];
    }
  }
  __syncthreads();
  for (int w = 0; w < NW; ++w) {
    if (warp == w) {
#pragma unroll
      for (int g = 0; g < GR; ++g) {
        float mx = NEG_INF;
        for (int u = 0; u < NW; ++u) mx = fmaxf(mx, ms[u][g]);
        const float wgt = expf(m[g] - mx);
#pragma unroll
        for (int jj = 0; jj < NDV; ++jj) {
          const int col = lane + 32 * jj;
          if (col < dv) os[g][col] += acc[g][jj] * wgt;
        }
      }
    }
    __syncthreads();
  }
  for (int i = threadIdx.x; i < ng * dv; i += NT) {
    const int r = i / dv, c = i - r * dv;
    float mx = NEG_INF;
    for (int u = 0; u < NW; ++u) mx = fmaxf(mx, ms[u][r]);
    float den = 0.f;
    for (int u = 0; u < NW; ++u) den += ls[u][r] * expf(ms[u][r] - mx);
    o[((size_t)b * h + head0 + r) * dv + c] = from_f<T>(os[r][c] / fmaxf(den, 1e-30f));
  }
}

template <typename T, int GR>
cudaError_t launch(const void* q, const void* k, const void* v, const void* kv_len,
                   void* o, int b, int s, int h, int kvh, int d, int dv,
                   int window, float softcap, float scale, cudaStream_t stream) {
  const int group = h / kvh;
  const dim3 grid((group + GR - 1) / GR, kvh, b);
  dec_fwd<T, GR><<<grid, NT, 0, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<const int*>(kv_len), static_cast<T*>(o), s, h, kvh, d, dv,
      window, softcap, scale);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch(const void* q, const void* k, const void* v, const void* kv_len,
                     void* o, int b, int s, int h, int kvh, int d, int dv,
                     int window, float softcap, float scale, cudaStream_t stream) {
  const int group = h / kvh;
  if (group <= 1)
    return launch<T, 1>(q, k, v, kv_len, o, b, s, h, kvh, d, dv, window, softcap, scale, stream);
  if (group <= 2)
    return launch<T, 2>(q, k, v, kv_len, o, b, s, h, kvh, d, dv, window, softcap, scale, stream);
  if (group <= 4)
    return launch<T, 4>(q, k, v, kv_len, o, b, s, h, kvh, d, dv, window, softcap, scale, stream);
  return launch<T, 8>(q, k, v, kv_len, o, b, s, h, kvh, d, dv, window, softcap, scale, stream);
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16.  window <= 0: no window; softcap <= 0: no
// softcap.  Returns the cudaError_t of the launch (0 on success).
extern "C" int decode_attention_fwd(const void* q, const void* k, const void* v,
                                    const void* kv_len, void* o, int dtype, int b,
                                    int s, int h, int kvh, int d, int dv,
                                    int window, float softcap, float scale,
                                    void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return (int)dispatch<float>(q, k, v, kv_len, o, b, s, h, kvh, d, dv, window,
                                softcap, scale, st);
  if (dtype == 1)
    return (int)dispatch<__nv_bfloat16>(q, k, v, kv_len, o, b, s, h, kvh, d, dv,
                                        window, softcap, scale, st);
  return (int)cudaErrorInvalidValue;
}
