// Paged attention for Hopper (sm_90a), plain CUDA C++ with fp32 FMA.
//
// Replaces the TPU kernel _paged_window_core
// (src/repro/kernels/paged_attention/paged_attention.py:137, body
// _paged_kernel :84) behind both of its entry points: single-token paged
// decode (T = 1) and the speculative-verification window (T = K + 1).  Each
// of the T query positions of a sequence attends to K/V scattered across
// fixed-size physical pages named by the sequence's block table: row t sees
// logical positions p <= base + t, base = kv_len + offset (offset -1 for the
// decode entry, whose kv_len counts the query; 0 for the window entry, whose
// kv_len is the history before the window).  Softcap before the mask,
// online softmax in fp32, and acc / max(l, 1e-30) at the end, so a row with
// no valid key writes 0.
//
// Layouts are the JAX package's: q [B, T, H, D], k_pool [N, bs, KV, D],
// v_pool [N, bs, KV, Dv], block_tables [B, nb] int32, kv_len [B] int32,
// o [B, T, H, Dv], all contiguous; f32/bf16.
//
// What is not carried over from the TPU: the 8-sublane row padding of the
// GQA group (_group_pad) and the power-of-two bucketing of nb (bucket_nb,
// _pad_tables), which only cap jit recompiles; nb is a runtime int here.
// Scalar prefetch becomes the kernel loading its own table entries, and it
// loads only the pages its rows can see: logical pages < ceil(len / bs),
// len = the largest row limit of the block, clamped to the table's nb * bs
// positions, so entries past that are never read.
//
// What bounds it on the H100: every valid K/V row is read once for only
// 2*T*G*(D+Dv) operations (G = query heads per KV head), so it is bound by
// the bytes of the valid K/V rows.  This first design gives one block of 8
// warps to each (batch, KV head, chunk of <= 8 of the T*G query rows; row
// r = t*G + g).  Warp w takes the 32-position tiles w, w+8, ... of the
// logical range: whole pages when bs divides 32, one table load per lane,
// shuffled to the lanes that need it for P.V.  Each warp keeps fp32
// (m, l, acc) per row and the block merges them in warp order at the end.
// A tile or part of a tile past a row's limit leaves that row's state
// exactly unchanged (p = 0, correction factor 1), so a row's result depends
// only on its own limit: the same at any T and in any row chunk.  Next:
// split the pages of a sequence across blocks with a combine pass (the serve
// shapes give only B*KV = 12 blocks on 132 SMs), cp.async/TMA page loads,
// and bf16 MMA over the T*G rows.

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

// RC: query rows per block (a power of two >= the rows it serves, <= 8).
template <typename T, int RC>
__global__ void __launch_bounds__(NT)
paged_fwd(const T* __restrict__ q, const T* __restrict__ kp, const T* __restrict__ vp,
          const int* __restrict__ bt, const int* __restrict__ kv_len, T* __restrict__ o,
          int tw, int h, int kvh, int d, int dv, int bs, int nb, int offset,
          float softcap, float scale) {
  __shared__ float qs[RC][MAXD];
  __shared__ float os[RC][MAXD];
  __shared__ float ms[NW][RC];
  __shared__ float ls[NW][RC];

  const int group = h / kvh;
  const int r0 = blockIdx.x * RC;
  const int nr = min(RC, tw * group - r0);
  const int kh = blockIdx.y, b = blockIdx.z;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int base = kv_len[b] + offset;
  const int cap = nb * bs;

  // Row i of the block is window position t = (r0 + i) / group, query head
  // kh * group + (r0 + i) % group; it sees positions < lim[i].
  int lim[RC];
  int len = 0;
#pragma unroll
  for (int i = 0; i < RC; ++i) {
    const int t = (r0 + i) / group;
    lim[i] = i < nr ? max(0, min(base + t + 1, cap)) : 0;
    len = max(len, lim[i]);
  }

  for (int i = threadIdx.x; i < RC * d; i += NT) {
    const int r = i / d, c = i - r * d;
    float x = 0.f;
    if (r < nr) {
      const int row = r0 + r, t = row / group, g = row - t * group;
      x = to_f(q[(((size_t)b * tw + t) * h + kh * group + g) * d + c]) * scale;
    }
    qs[r][c] = x;
  }
  for (int i = threadIdx.x; i < RC * dv; i += NT) os[i / dv][i % dv] = 0.f;
  __syncthreads();

  const int* btb = bt + (size_t)b * nb;
  const size_t k_row = (size_t)kvh * d, v_row = (size_t)kvh * dv;
  const T* kb = kp + (size_t)kh * d;
  const T* vb = vp + (size_t)kh * dv;

  float m[RC], l[RC], acc[RC][NDV];
#pragma unroll
  for (int i = 0; i < RC; ++i) {
    m[i] = NEG_INF;
    l[i] = 0.f;
#pragma unroll
    for (int jj = 0; jj < NDV; ++jj) acc[i][jj] = 0.f;
  }

  for (int t0 = warp * 32; t0 < len; t0 += NW * 32) {
    const int pos = t0 + lane;
    const bool in = pos < len;
    // Physical row (page * bs + offset in page) of this lane's position.
    size_t prow = 0;
    float sc[RC];
#pragma unroll
    for (int i = 0; i < RC; ++i) sc[i] = 0.f;
    if (in) {
      const int page = pos / bs;
      prow = (size_t)btb[page] * bs + (pos - page * bs);
      const T* kr = kb + prow * k_row;
      for (int c = 0; c < d; ++c) {
        const float kv = to_f(kr[c]);
#pragma unroll
        for (int i = 0; i < RC; ++i) sc[i] = fmaf(qs[i][c], kv, sc[i]);
      }
    }
    float p[RC];
#pragma unroll
    for (int i = 0; i < RC; ++i) {
      float x = sc[i];
      if (softcap > 0.f) x = softcap * tanhf(x / softcap);
      const bool ok = pos < lim[i];
      x = ok ? x : NEG_INF;
      const float m_new = fmaxf(m[i], warp_max(x));
      const float corr = expf(m[i] - m_new);
      p[i] = ok ? expf(x - m_new) : 0.f;
      l[i] = l[i] * corr + warp_sum(p[i]);
      m[i] = m_new;
#pragma unroll
      for (int jj = 0; jj < NDV; ++jj) acc[i][jj] *= corr;
    }
    const int n_valid = min(32, len - t0);
    for (int j = 0; j < n_valid; ++j) {
      const size_t rj = __shfl_sync(FULL, (unsigned long long)prow, j);
      const T* vr = vb + rj * v_row;
      float vv[NDV];
#pragma unroll
      for (int jj = 0; jj < NDV; ++jj) {
        const int col = lane + 32 * jj;
        vv[jj] = col < dv ? to_f(vr[col]) : 0.f;
      }
#pragma unroll
      for (int i = 0; i < RC; ++i) {
        const float pj = __shfl_sync(FULL, p[i], j);
#pragma unroll
        for (int jj = 0; jj < NDV; ++jj) acc[i][jj] = fmaf(pj, vv[jj], acc[i][jj]);
      }
    }
  }

  // Merge the warps' partials: weights exp(m_w - max_w m_w), in warp order.
  if (lane == 0) {
#pragma unroll
    for (int i = 0; i < RC; ++i) {
      ms[warp][i] = m[i];
      ls[warp][i] = l[i];
    }
  }
  __syncthreads();
  for (int w = 0; w < NW; ++w) {
    if (warp == w) {
#pragma unroll
      for (int i = 0; i < RC; ++i) {
        float mx = NEG_INF;
        for (int u = 0; u < NW; ++u) mx = fmaxf(mx, ms[u][i]);
        const float wgt = expf(m[i] - mx);
#pragma unroll
        for (int jj = 0; jj < NDV; ++jj) {
          const int col = lane + 32 * jj;
          if (col < dv) os[i][col] += acc[i][jj] * wgt;
        }
      }
    }
    __syncthreads();
  }
  for (int i = threadIdx.x; i < nr * dv; i += NT) {
    const int r = i / dv, c = i - r * dv;
    float mx = NEG_INF;
    for (int u = 0; u < NW; ++u) mx = fmaxf(mx, ms[u][r]);
    float den = 0.f;
    for (int u = 0; u < NW; ++u) den += ls[u][r] * expf(ms[u][r] - mx);
    const int row = r0 + r, t = row / group, g = row - t * group;
    o[(((size_t)b * tw + t) * h + kh * group + g) * dv + c] =
        from_f<T>(os[r][c] / fmaxf(den, 1e-30f));
  }
}

template <typename T, int RC>
cudaError_t launch(const void* q, const void* kp, const void* vp, const void* bt,
                   const void* kv_len, void* o, int b, int tw, int h, int kvh,
                   int d, int dv, int bs, int nb, int offset, float softcap,
                   float scale, cudaStream_t stream) {
  const int rows = tw * (h / kvh);
  const dim3 grid((rows + RC - 1) / RC, kvh, b);
  paged_fwd<T, RC><<<grid, NT, 0, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(kp), static_cast<const T*>(vp),
      static_cast<const int*>(bt), static_cast<const int*>(kv_len), static_cast<T*>(o),
      tw, h, kvh, d, dv, bs, nb, offset, softcap, scale);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch(const void* q, const void* kp, const void* vp, const void* bt,
                     const void* kv_len, void* o, int b, int tw, int h, int kvh,
                     int d, int dv, int bs, int nb, int offset, float softcap,
                     float scale, cudaStream_t stream) {
  const int rows = tw * (h / kvh);
  if (rows <= 1)
    return launch<T, 1>(q, kp, vp, bt, kv_len, o, b, tw, h, kvh, d, dv, bs, nb,
                        offset, softcap, scale, stream);
  if (rows <= 2)
    return launch<T, 2>(q, kp, vp, bt, kv_len, o, b, tw, h, kvh, d, dv, bs, nb,
                        offset, softcap, scale, stream);
  if (rows <= 4)
    return launch<T, 4>(q, kp, vp, bt, kv_len, o, b, tw, h, kvh, d, dv, bs, nb,
                        offset, softcap, scale, stream);
  return launch<T, 8>(q, kp, vp, bt, kv_len, o, b, tw, h, kvh, d, dv, bs, nb,
                      offset, softcap, scale, stream);
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16.  softcap <= 0: no softcap.  Row t of a
// sequence attends positions <= kv_len + offset + t.  Returns the
// cudaError_t of the launch (0 on success).
extern "C" int paged_attention_fwd(const void* q, const void* k_pool,
                                   const void* v_pool, const void* block_tables,
                                   const void* kv_len, void* o, int dtype, int b,
                                   int tw, int h, int kvh, int d, int dv, int bs,
                                   int nb, int offset, float softcap, float scale,
                                   void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (bs <= 0 || nb <= 0 || tw <= 0) return (int)cudaErrorInvalidValue;
  if (dtype == 0)
    return (int)dispatch<float>(q, k_pool, v_pool, block_tables, kv_len, o, b, tw,
                                h, kvh, d, dv, bs, nb, offset, softcap, scale, st);
  if (dtype == 1)
    return (int)dispatch<__nv_bfloat16>(q, k_pool, v_pool, block_tables, kv_len, o,
                                        b, tw, h, kvh, d, dv, bs, nb, offset,
                                        softcap, scale, st);
  return (int)cudaErrorInvalidValue;
}
