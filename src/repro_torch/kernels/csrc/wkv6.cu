// RWKV-6 WKV recurrence for Hopper (sm_90a), plain CUDA C++ with fp32 FMA.
//
// Replaces the TPU kernel wkv6_pallas (src/repro/kernels/wkv6/wkv6.py:70,
// body _wkv6_kernel :21).  Per (batch, head), with key dim i and value dim j:
//
//   out_t[j] = sum_i r_t[i] (S_{t-1}[i,j] + u[i] k_t[i] v_t[j])
//   S_t[i,j] = w_t[i] S_{t-1}[i,j] + k_t[i] v_t[j]
//
// computed chunk by chunk as the TPU kernel does: with lw = log(clip(w,
// 1e-12, 1)) (taken here, in the load), cw the inclusive and cx the
// exclusive cumulative sum of lw over the chunk,
//
//   out = (r e^cx) S + A v,   A[t,s] = sum_i r[t,i] k[s,i] e^(cx[t,i] - cw[s,i])
//                             for s < t, A[t,t] = sum_i r[t,i] u[i] k[t,i],
//   S  <- e^cw[last] S + (k e^(cw[last] - cw))^T v.
//
// Every exponent is <= 0 (the pairwise log-space form), so a decay as strong
// as w = 1e-12 a step (lw = -27.6, -884 over a chunk) cannot overflow, which
// the factored r e^cw / k e^-cw form would.  Transcendentals are the accurate
// expf/logf (no fast math).
//
// Layouts are the JAX package's: r, k [B, T, H, D], v [B, T, H, Dv] (f32 or
// bf16), w [B, T, H, D] f32, u [H, D] f32, optional s0 [B, H, D, Dv] f32;
// out [B, T, H, Dv] in r's dtype, final state [B, H, D, Dv] f32; all
// contiguous.  D, Dv <= 128, chunk <= 32.
//
// The TPU grid (b, h, chunk) runs its chunk axis in order and keeps S in
// VMEM scratch between grid steps; blocks on Hopper run in no order, so one
// block of 256 threads takes one (b, h) and loops over the chunks itself,
// with S in shared memory for the whole sweep and the final state written at
// the end.  The TPU body materialises the [C, C, D] decay tensor (256 KB at
// C = 32, D = 64), more than a block's shared memory; here each A[t,s] sums
// its D exponentials on the fly and only A (C x C) is kept.  Shared memory
// per block: the r, k, v, cx, cw tiles, A, S, u and the chunk decay, 62 KB at
// C = 32, D = Dv = 64 (dynamic, above the 48 KB default).  Rows past T in
// the last chunk count as r = k = v = 0, lw = 0 and are never written.
//
// What bounds it on the H100: reading r, k, v, w and writing out is ~4 bytes
// per ~9 FMAs (C = 32, D = Dv = 64), so the bytes and the fp32 FMA rate bound
// it about equally (0.063 vs 0.051 ms at B = 4, T = 1024, H = 40), with
// ~3.4e8 accurate expf on top.  This first design has B x H blocks (160 at
// B = 4 for 132 SMs), uses no tensor cores, and every inner loop reads 2-4
// shared-memory operands per FMA, which bounds it (1.65 ms at that shape on
// an H100 80GB HBM3 at 700 W, see PERF.md).  Register tiling of the three
// products, splitting T across blocks with a second pass over the chunk
// states, and sub-chunk factorisation of the decay come next.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstddef>

namespace {

constexpr int NT = 256;          // threads per block
constexpr int MAXC = 32;         // chunk <= 32
constexpr int MAXD = 128;        // D, Dv <= 128

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }
template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

// Floats of shared memory for chunk c and head dims d, dv (layout below).
__host__ __device__ inline size_t smem_floats(int c, int d, int dv) {
  return (size_t)c * d * 2 + (size_t)c * (d + 1) * 2 + (size_t)c * dv + (size_t)c * c +
         (size_t)d * dv + 2 * (size_t)d;
}

template <typename T>
__global__ void __launch_bounds__(NT)
wkv6_fwd_kernel(const T* __restrict__ r, const T* __restrict__ k,
                const T* __restrict__ v, const float* __restrict__ w,
                const float* __restrict__ u, const float* __restrict__ s0,
                T* __restrict__ o, float* __restrict__ sf, int t_len, int h,
                int d, int dv, int c) {
  // Shared layout (floats); k and cw rows are padded to d + 1 so that the
  // lanes of a warp, which take different s of one A row, hit distinct banks.
  extern __shared__ float sm[];
  const int d1 = d + 1;
  float* rs = sm;                    // [c][d]   r, then r * e^cx
  float* cx = rs + c * d;            // [c][d]   exclusive cumulative lw
  float* ks = cx + c * d;            // [c][d1]  k, then k * e^(cw[last] - cw)
  float* cw = ks + c * d1;           // [c][d1]  inclusive cumulative lw
  float* vs = cw + c * d1;           // [c][dv]
  float* as = vs + c * dv;           // [c][c]   A with the bonus on its diagonal
  float* ss = as + c * c;            // [d][dv]  state
  float* us = ss + d * dv;           // [d]      bonus u
  float* dec = us + d;               // [d]      e^cw[last]

  const int hi = blockIdx.x, b = blockIdx.y, tid = threadIdx.x;
  const size_t row = (size_t)h * d, rowv = (size_t)h * dv;   // time strides
  const size_t base = ((size_t)b * t_len * h + hi) * d;
  const size_t basev = ((size_t)b * t_len * h + hi) * dv;
  const size_t sbase = ((size_t)b * h + hi) * d * dv;

  for (int e = tid; e < d * dv; e += NT) ss[e] = s0 ? s0[sbase + e] : 0.f;
  for (int i = tid; i < d; i += NT) us[i] = u[(size_t)hi * d + i];

  for (int t0 = 0; t0 < t_len; t0 += c) {
    const int n = min(c, t_len - t0);          // valid rows of this chunk
    __syncthreads();                           // the last chunk's readers are done
    for (int e = tid; e < c * d; e += NT) {
      const int t = e / d, i = e - t * d;
      const size_t g = base + (size_t)(t0 + t) * row + i;
      const bool ok = t < n;
      rs[t * d + i] = ok ? to_f(r[g]) : 0.f;
      ks[t * d1 + i] = ok ? to_f(k[g]) : 0.f;
      cx[t * d + i] = ok ? logf(fminf(fmaxf(w[g], 1e-12f), 1.f)) : 0.f;
    }
    for (int e = tid; e < c * dv; e += NT) {
      const int t = e / dv, j = e - t * dv;
      vs[t * dv + j] = t < n ? to_f(v[basev + (size_t)(t0 + t) * rowv + j]) : 0.f;
    }
    __syncthreads();
    // cumulative log decay, one column per thread: cx[t] = sum_{s<t} lw[s],
    // cw[t] = sum_{s<=t} lw[s]; cx[t] and cw[t-1] are the same float
    for (int i = tid; i < d; i += NT) {
      float acc = 0.f;
      for (int t = 0; t < c; ++t) {
        const float l = cx[t * d + i];
        cx[t * d + i] = acc;
        acc += l;
        cw[t * d1 + i] = acc;
      }
      dec[i] = expf(acc);
    }
    __syncthreads();
    // A over the valid rows: strictly below the diagonal the pairwise decay,
    // on it the bonus
    for (int e = tid; e < n * c; e += NT) {
      const int t = e / c, s = e - t * c;
      const float* rt = rs + t * d;
      const float* ksr = ks + s * d1;
      float acc = 0.f;
      if (s < t) {
        const float* cxt = cx + t * d;
        const float* cws = cw + s * d1;
#pragma unroll 4
        for (int i = 0; i < d; ++i) acc += rt[i] * ksr[i] * expf(cxt[i] - cws[i]);
      } else if (s == t) {
#pragma unroll 4
        for (int i = 0; i < d; ++i) acc += rt[i] * us[i] * ksr[i];
      }
      as[t * c + s] = acc;
    }
    __syncthreads();
    for (int e = tid; e < c * d; e += NT) {
      const int t = e / d, i = e - t * d;
      rs[t * d + i] *= expf(cx[t * d + i]);
      ks[t * d1 + i] *= expf(cw[(c - 1) * d1 + i] - cw[t * d1 + i]);
    }
    __syncthreads();
    // out = (r e^cx) S + A v, valid rows only
    for (int e = tid; e < n * dv; e += NT) {
      const int t = e / dv, j = e - t * dv;
      const float* rt = rs + t * d;
      const float* at = as + t * c;
      float acc = 0.f;
#pragma unroll 4
      for (int i = 0; i < d; ++i) acc += rt[i] * ss[i * dv + j];
      for (int s = 0; s <= t; ++s) acc += at[s] * vs[s * dv + j];
      o[basev + (size_t)(t0 + t) * rowv + j] = from_f<T>(acc);
    }
    __syncthreads();
    // S <- e^cw[last] S + kd^T v
    for (int e = tid; e < d * dv; e += NT) {
      const int i = e / dv, j = e - i * dv;
      float acc = dec[i] * ss[e];
      for (int s = 0; s < n; ++s) acc += ks[s * d1 + i] * vs[s * dv + j];
      ss[e] = acc;
    }
  }
  __syncthreads();
  for (int e = tid; e < d * dv; e += NT) sf[sbase + e] = ss[e];
}

template <typename T>
cudaError_t launch(const void* r, const void* k, const void* v, const void* w,
                   const void* u, const void* s0, void* o, void* sf, int b, int t,
                   int h, int d, int dv, int c, cudaStream_t stream) {
  const size_t bytes = smem_floats(c, d, dv) * sizeof(float);
  static size_t opted = 48 * 1024;     // dynamic shared memory allowed so far
  if (bytes > opted) {
    const cudaError_t err = cudaFuncSetAttribute(
        wkv6_fwd_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
    if (err != cudaSuccess) return err;
    opted = bytes;
  }
  wkv6_fwd_kernel<T><<<dim3(h, b), NT, bytes, stream>>>(
      static_cast<const T*>(r), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<const float*>(w), static_cast<const float*>(u),
      static_cast<const float*>(s0), static_cast<T*>(o), static_cast<float*>(sf),
      t, h, d, dv, c);
  return cudaGetLastError();
}

}  // namespace

// dtype (of r, k, v and out): 0 = float32, 1 = bfloat16.  s0 may be null
// (zero initial state).  chunk is min(chunk, T) as the caller gives it.
// Returns the cudaError_t of the launch (0 on success).
extern "C" int wkv6_fwd(const void* r, const void* k, const void* v, const void* w,
                        const void* u, const void* s0, void* o, void* sf, int dtype,
                        int b, int t, int h, int d, int dv, int chunk, void* stream) {
  if (chunk < 1 || chunk > MAXC || d < 1 || d > MAXD || dv < 1 || dv > MAXD)
    return (int)cudaErrorInvalidValue;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return (int)launch<float>(r, k, v, w, u, s0, o, sf, b, t, h, d, dv, chunk, st);
  if (dtype == 1)
    return (int)launch<__nv_bfloat16>(r, k, v, w, u, s0, o, sf, b, t, h, d, dv, chunk,
                                      st);
  return (int)cudaErrorInvalidValue;
}
