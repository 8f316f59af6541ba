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
// VMEM scratch between grid steps; blocks on Hopper run in no order, so a
// block loops over the chunks itself with its state in shared memory.  The
// recurrence is independent across value columns: S[:, j] and out[:, j]
// depend on v[:, j], s0[:, j] and A only, and A on r, k, w and u only.  So
// a thread-block cluster of 4 blocks (256 threads each) serves one (b, h):
// block q owns the columns [q dvs, (q + 1) dvs), dvs = ceil(Dv / 4), of v,
// S, s0, out and the final state (a block past Dv owns none and still
// builds its rows of A and meets every barrier).  A (C x C) is built once a
// cluster: block q computes the rows t = q mod 4 and stores each entry into
// all four blocks' shared memory through distributed shared memory, into a
// double buffer (chunk parity) behind one cluster barrier a chunk.  The
// loads of r, k, w, the cumulative sums and the rescaling of r and k stay
// per block: each block needs all of D for its own products (its peers'
// reads of the same rows hit L2).  Every sum keeps the one-block order.
// The TPU body materialises the [C, C, D] decay tensor (256 KB at C = 32,
// D = 64), more than a block's shared memory; here each A[t,s] sums its D
// exponentials on the fly.  Shared memory per block: r, k, cw (rows padded
// to D + 1), the block's columns of v and S, A twice, u and the chunk decay,
// 40 KB at C = 32, D = Dv = 64, so 5 blocks (40 warps) fit an SM at <= 48
// registers a thread: the 640 blocks of B = 4, H = 40 run in one wave (one
// block a (b, h) would give 160 blocks of 8 warps for 132 SMs).  Rows past
// T in the last chunk count as r = k = v = 0, lw = 0 and are never
// written.
//
// What bounds it on the H100: reading r, k, v, w and writing out is ~4 bytes
// per ~9 FMAs (C = 32, D = Dv = 64), so the bytes bound the function (0.063
// ms at B = 4, T = 1024, H = 40; its 3.4e9 operations take 0.021 ms at the
// 3xTF32 rate).  This design runs no tensor core and reads 2-4
// shared-memory operands per FMA in every inner loop: by a count of its
// accesses, the shared-memory pipe (one warp-wide access an SM a clock)
// bounds it; PERF.md has the count and the times.  Register tiling of the out and state products, a dense mapping of
// A's pairs, a sub-chunk factorisation of the decay and TMA multicast of
// r, k, w across the cluster come next.

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstddef>

namespace {

namespace cg = cooperative_groups;

constexpr int NT = 256;          // threads per block
constexpr int MAXC = 32;         // chunk <= 32
constexpr int MAXD = 128;        // D, Dv <= 128
constexpr int SPLITS = 4;        // blocks a (batch, head), by value columns
constexpr int MIN_BLOCKS = 5;    // resident blocks an SM at D = Dv = 64

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }
template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

// Floats of shared memory for chunk c, head dims d, dv and nv = ceil(dv / 4)
// value columns a block (layout below).
__host__ __device__ inline size_t smem_floats(int c, int d, int nv) {
  return (size_t)c * (d + 1) * 3 + (size_t)c * nv + 2 * (size_t)c * (c + 1) +
         (size_t)d * nv + 2 * (size_t)d;
}

template <typename T>
__global__ void __launch_bounds__(NT, MIN_BLOCKS)
wkv6_fwd_kernel(const T* __restrict__ r, const T* __restrict__ k,
                const T* __restrict__ v, const float* __restrict__ w,
                const float* __restrict__ u, const float* __restrict__ s0,
                T* __restrict__ o, float* __restrict__ sf, int t_len, int h,
                int d, int dv, int c) {
  // Shared layout (floats); rows of r, k, cw and A are padded by one so that
  // the lanes of a warp that take different rows or different s hit
  // distinct banks.
  extern __shared__ float sm[];
  const int d1 = d + 1, c1 = c + 1;
  const int dvs = (dv + SPLITS - 1) / SPLITS;       // columns a block
  float* rs = sm;                    // [c][d1]  r, then r * e^cx
  float* ks = rs + c * d1;           // [c][d1]  k, then k * e^(cw[last] - cw)
  float* cw = ks + c * d1;           // [c][d1]  lw, then its inclusive cumsum
  float* vs = cw + c * d1;           // [c][nv]  this block's columns of v
  float* as = vs + c * dvs;          // [2][c][c1] A, bonus on its diagonal
  float* ss = as + 2 * c * c1;       // [d][nv]  this block's columns of S
  float* us = ss + d * dvs;          // [d]      bonus u
  float* dec = us + d;               // [d]      e^cw[last]

  cg::cluster_group cluster = cg::this_cluster();
  const int q = blockIdx.x, hi = blockIdx.y, b = blockIdx.z, tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const int j0 = q * dvs, nv = max(0, min(dvs, dv - j0));   // own columns
  const size_t row = (size_t)h * d, rowv = (size_t)h * dv;   // time strides
  const size_t base = ((size_t)b * t_len * h + hi) * d;
  const size_t basev = ((size_t)b * t_len * h + hi) * dv + j0;
  const size_t sbase = ((size_t)b * h + hi) * d * dv + j0;

  for (int e = tid; e < d * nv; e += NT) {
    const int i = e / nv, j = e - i * nv;
    ss[e] = s0 ? s0[sbase + (size_t)i * dv + j] : 0.f;
  }
  for (int i = tid; i < d; i += NT) us[i] = u[(size_t)hi * d + i];
  // every block of the cluster has started before a peer stores into it
  cluster.sync();

  for (int t0 = 0, buf = 0; t0 < t_len; t0 += c, buf ^= 1) {
    const int n = min(c, t_len - t0);          // valid rows of this chunk
    __syncthreads();                           // the last chunk's readers are done
    for (int e = tid; e < c * d; e += NT) {
      const int t = e / d, i = e - t * d;
      const size_t g = base + (size_t)(t0 + t) * row + i;
      const bool ok = t < n;
      rs[t * d1 + i] = ok ? to_f(r[g]) : 0.f;
      ks[t * d1 + i] = ok ? to_f(k[g]) : 0.f;
      cw[t * d1 + i] = ok ? logf(fminf(fmaxf(w[g], 1e-12f), 1.f)) : 0.f;
    }
    for (int e = tid; e < c * nv; e += NT) {
      const int t = e / nv, j = e - t * nv;
      vs[e] = t < n ? to_f(v[basev + (size_t)(t0 + t) * rowv + j]) : 0.f;
    }
    __syncthreads();
    // cumulative log decay in place, one column per thread: cw[t] = sum_{s<=t}
    // lw[s]; the exclusive sum cx[t] = sum_{s<t} lw[s] is the same float as
    // cw[t-1] (and 0 at t = 0), so it is read from there
    for (int i = tid; i < d; i += NT) {
      float acc = 0.f;
      for (int t = 0; t < c; ++t) {
        acc += cw[t * d1 + i];
        cw[t * d1 + i] = acc;
      }
      dec[i] = expf(acc);
    }
    __syncthreads();
    // A over the valid rows, built once a cluster: block q takes the rows
    // t = q mod 4 (warp w row 4w + q, lane s column s; c <= 32 rows need one
    // pass) and stores each entry into all four blocks' buffer `buf`.
    // Strictly below the diagonal the pairwise decay, on it the bonus.
    float* at_buf = as + buf * c * c1;
    {
      const int t = SPLITS * warp + q, s = lane;
      if (t < n && s < c) {
        const float* rt = rs + t * d1;
        const float* ksr = ks + s * d1;
        float acc = 0.f;
        if (s < t) {
          const float* cxt = cw + (t - 1) * d1;
          const float* cws = cw + s * d1;
#pragma unroll 4
          for (int i = 0; i < d; ++i) acc += rt[i] * ksr[i] * expf(cxt[i] - cws[i]);
        } else if (s == t) {
#pragma unroll 4
          for (int i = 0; i < d; ++i) acc += rt[i] * us[i] * ksr[i];
        }
#pragma unroll
        for (int p = 0; p < SPLITS; ++p) cluster.map_shared_rank(at_buf, p)[t * c1 + s] = acc;
      }
    }
    // One cluster barrier a chunk: every row of A has arrived.  A block
    // stores into buffer buf ^ 1 next chunk only after this barrier, which
    // each peer reached after its last read of that buffer (last chunk).
    cluster.sync();
    for (int e = tid; e < c * d; e += NT) {
      const int t = e / d, i = e - t * d;
      if (t > 0) rs[t * d1 + i] *= expf(cw[(t - 1) * d1 + i]);
      ks[t * d1 + i] *= expf(cw[(c - 1) * d1 + i] - cw[t * d1 + i]);
    }
    __syncthreads();
    // out = (r e^cx) S + A v over this block's columns, valid rows only
    for (int e = tid; e < n * nv; e += NT) {
      const int t = e / nv, j = e - t * nv;
      const float* rt = rs + t * d1;
      const float* at = at_buf + t * c1;
      float acc = 0.f;
#pragma unroll 4
      for (int i = 0; i < d; ++i) acc += rt[i] * ss[i * nv + j];
      for (int s = 0; s <= t; ++s) acc += at[s] * vs[s * nv + j];
      o[basev + (size_t)(t0 + t) * rowv + j] = from_f<T>(acc);
    }
    __syncthreads();
    // S <- e^cw[last] S + kd^T v over this block's columns
    for (int e = tid; e < d * nv; e += NT) {
      const int i = e / nv, j = e - i * nv;
      float acc = dec[i] * ss[e];
      for (int s = 0; s < n; ++s) acc += ks[s * d1 + i] * vs[s * nv + j];
      ss[e] = acc;
    }
  }
  // no block leaves while a peer may still address its shared memory
  cluster.sync();
  for (int e = tid; e < d * nv; e += NT) {
    const int i = e / nv, j = e - i * nv;
    sf[sbase + (size_t)i * dv + j] = ss[e];
  }
}

template <typename T>
cudaError_t launch(const void* r, const void* k, const void* v, const void* w,
                   const void* u, const void* s0, void* o, void* sf, int b, int t,
                   int h, int d, int dv, int c, cudaStream_t stream) {
  const size_t bytes = smem_floats(c, d, (dv + SPLITS - 1) / SPLITS) * sizeof(float);
  static size_t opted = 48 * 1024;     // dynamic shared memory allowed so far
  if (bytes > opted) {
    const cudaError_t err = cudaFuncSetAttribute(
        wkv6_fwd_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
    if (err != cudaSuccess) return err;
    opted = bytes;
  }
  // one cluster of SPLITS blocks along x for each (head, batch)
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(SPLITS, h, b);
  cfg.blockDim = dim3(NT, 1, 1);
  cfg.dynamicSmemBytes = bytes;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = SPLITS;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const cudaError_t err = cudaLaunchKernelEx(
      &cfg, wkv6_fwd_kernel<T>, static_cast<const T*>(r), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const float*>(w),
      static_cast<const float*>(u), static_cast<const float*>(s0), static_cast<T*>(o),
      static_cast<float*>(sf), t, h, d, dv, c);
  if (err != cudaSuccess) return err;
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
