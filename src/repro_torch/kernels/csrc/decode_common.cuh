// Device code shared by the two decode kernels, decode_attention.cu (K3) and
// paged_attention.cu (K1): a split of the KV range across the blocks of one
// thread-block cluster, K/V tiles staged in shared memory with cp.async, an
// online softmax per query row in fp32, and the combine of the blocks'
// partials through distributed shared memory.  Each kernel supplies its own
// query rows, its split's range and the global row of each position.
//
// Block: NW warps; warp w owns the query rows w, w + NW, ... of the block
// (RPW <= 2 of them) and keeps their (m, l, acc) in registers; a warp with
// no row below nr skips the arithmetic and only copies.  A tile is TILE
// positions, one per lane for Q.K^T and staged rows for P.V.
//
// Bit-for-bit invariants the kernels rely on: a row's arithmetic depends only
// on the tiles of its split and on its own end (positions at or past it get
// p = 0 and leave m, l, acc exactly unchanged), not on which warp or block
// row it occupies; the combine reads the partials in rank order.

#pragma once

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstddef>

namespace decode_common {

namespace cg = cooperative_groups;

constexpr int NW = 8;             // warps per block
constexpr int NT = NW * 32;
// At most 128 registers a thread, so two blocks share an SM: 192 blocks (16
// splits at B = 4, KV = 3) then run in one wave; at 137 registers they took
// two and the call 1.6x as long.
constexpr int MIN_BLOCKS = 2;
constexpr int TILE = 32;          // positions per staged tile
constexpr int MAXD = 256;         // D, Dv <= 256
constexpr int MAX_SPLITS = 16;    // blocks per cluster (above 8: non-portable)
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

// 16 bytes global -> shared, asynchronous; zero-filled when !valid (src is
// then not read).  No "memory" clobber, so the compiler may compute the
// next addresses while copies are issued: a stage is only read after
// cp_async_wait and __syncthreads, and only overwritten after the
// __syncthreads that ends the tile that read it.
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

// VEC = 16 / sizeof(T) elements of a 16-byte aligned shared row as floats.
__device__ __forceinline__ void load16(const float* p, float* out) {
  const float4 x = *reinterpret_cast<const float4*>(p);
  out[0] = x.x; out[1] = x.y; out[2] = x.z; out[3] = x.w;
}
__device__ __forceinline__ void load16(const __nv_bfloat16* p, float* out) {
  const uint4 x = *reinterpret_cast<const uint4*>(p);
  const unsigned w[4] = {x.x, x.y, x.z, x.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    __nv_bfloat162 h2;
    *reinterpret_cast<unsigned*>(&h2) = w[i];
    const float2 f = __bfloat1622float2(h2);
    out[2 * i] = f.x;
    out[2 * i + 1] = f.y;
  }
}

__host__ __device__ inline size_t align16(size_t x) { return (x + 15) & ~size_t(15); }

// Offsets into a block's dynamic shared memory.  ns stages of TILE K rows
// and TILE V rows of T, each row padded by 16 bytes so the lanes' 16-byte
// reads of TILE consecutive rows fall in distinct banks; then fp32 q rows
// (pre-scaled), p rows, the partial (m, l, acc) of each row, rank 0's
// copies of every split's m (then its weight) and l, the denominators, and
// the kernel's own ints (page table entries for K1).
struct Layout {
  int kstride, vstride;                 // elements of T per staged row
  size_t stage, q, p, m, l, acc, w, wl, den, ints, total;
};

__host__ __device__ inline Layout make_layout(int elem, int ns, int rc, int d, int dv,
                                              int splits, int n_ints) {
  Layout L;
  L.kstride = d + 16 / elem;
  L.vstride = dv + 16 / elem;
  L.stage = (size_t)TILE * (L.kstride + L.vstride) * elem;
  L.q = align16((size_t)ns * L.stage);
  L.p = align16(L.q + sizeof(float) * rc * d);
  L.m = align16(L.p + sizeof(float) * rc * TILE);
  L.l = align16(L.m + sizeof(float) * rc);
  L.acc = align16(L.l + sizeof(float) * rc);
  L.w = align16(L.acc + sizeof(float) * rc * dv);
  L.wl = align16(L.w + sizeof(float) * rc * splits);
  L.den = align16(L.wl + sizeof(float) * rc * splits);
  L.ints = align16(L.den + sizeof(float) * rc);
  L.total = align16(L.ints + sizeof(int) * n_ints);
  return L;
}

// The block's RC query rows, scaled, as fp32 rows of qs (zero past row nr);
// q_row(r) points at row r in global memory.  With D known at compile time
// each thread issues all its loads before its first store.
template <typename T, int RC, int DK, typename QRow>
__device__ __forceinline__ void load_q(float* qs, int d, int nr, float scale, QRow q_row) {
  if (DK) {
    constexpr int N = (RC * (DK ? DK : 1) + NT - 1) / NT;
    float x[N];
#pragma unroll
    for (int k = 0; k < N; ++k) {
      const int i = threadIdx.x + k * NT, r = i / d, c = i - r * d;
      x[k] = i < RC * d && r < nr ? to_f(q_row(r)[c]) * scale : 0.f;
    }
#pragma unroll
    for (int k = 0; k < N; ++k)
      if (threadIdx.x + k * NT < RC * d) qs[threadIdx.x + k * NT] = x[k];
  } else {
    for (int i = threadIdx.x; i < RC * d; i += NT) {
      const int r = i / d, c = i - r * d;
      qs[i] = r < nr ? to_f(q_row(r)[c]) * scale : 0.f;
    }
  }
}

// Issue the cp.async copies of the K and V rows of positions [t0, t0 + TILE)
// into one stage; positions at or past `end` are zero-filled.  row_of(pos)
// is the global row of a position: its K row is kg + row * k_ld, its V row
// vg + row * v_ld.  NT / TILE threads share a position, so each computes its
// row once, and neighbouring threads copy neighbouring 16-byte pieces.
template <typename T, typename RowOf>
__device__ __forceinline__ void stage_tile(T* ks, T* vs, const Layout& L, int d, int dv,
                                           const T* kg, const T* vg, size_t k_ld,
                                           size_t v_ld, int t0, int end, RowOf row_of) {
  constexpr int VEC = 16 / sizeof(T);
  constexpr int TPR = NT / TILE;
  const int j = threadIdx.x / TPR, sub = threadIdx.x % TPR;
  const int pos = t0 + j;
  const bool ok = pos < end;
  const size_t row = ok ? row_of(pos) : 0;
  const T* kr = kg + row * k_ld;
  const T* vr = vg + row * v_ld;
  T* ksr = ks + j * L.kstride;
  T* vsr = vs + j * L.vstride;
  for (int c = sub * VEC; c < d; c += TPR * VEC) cp_async16(ksr + c, kr + c, ok);
  for (int c = sub * VEC; c < dv; c += TPR * VEC) cp_async16(vsr + c, vr + c, ok);
}

// One staged tile for the warp's RPW rows: scores, online-softmax update and
// P.V.  rend[i]: positions >= rend[i] are masked for row i; nj: staged
// positions of the tile (the rest are zero).  Softcap before the mask.  Each
// score sums four interleaved partial dot products (shorter dependent
// chains); l[i] is this lane's share of the row's sum, reduced across the
// warp once, after the last tile.
template <typename T, int DK, int RPW>
__device__ __forceinline__ void tile_update(const T* ks, const T* vs, const Layout& L,
                                            int d, int dv, const float* qs, float* ps,
                                            int t0, int nj, const int (&rend)[RPW],
                                            float softcap, float (&m)[RPW],
                                            float (&l)[RPW],
                                            float (&acc)[RPW][(DK ? DK : MAXD) / 32]) {
  constexpr int VEC = 16 / sizeof(T);
  constexpr int NDV = (DK ? DK : MAXD) / 32;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;

  float s[RPW][4];
#pragma unroll
  for (int i = 0; i < RPW; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) s[i][e] = 0.f;
  const T* kr = ks + lane * L.kstride;
#pragma unroll
  for (int c = 0; c < d; c += VEC) {
    float kf[VEC];
    load16(kr + c, kf);
#pragma unroll
    for (int i = 0; i < RPW; ++i) {
      const float* qr = qs + (warp + NW * i) * d + c;
#pragma unroll
      for (int e = 0; e < VEC; e += 4) {
        const float4 q4 = *reinterpret_cast<const float4*>(qr + e);
        s[i][0] = fmaf(q4.x, kf[e], s[i][0]);
        s[i][1] = fmaf(q4.y, kf[e + 1], s[i][1]);
        s[i][2] = fmaf(q4.z, kf[e + 2], s[i][2]);
        s[i][3] = fmaf(q4.w, kf[e + 3], s[i][3]);
      }
    }
  }

  const int pos = t0 + lane;
#pragma unroll
  for (int i = 0; i < RPW; ++i) {
    float x = (s[i][0] + s[i][1]) + (s[i][2] + s[i][3]);
    if (softcap > 0.f) x = softcap * tanhf(x / softcap);
    const bool ok = pos < rend[i];
    x = ok ? x : NEG_INF;
    const float m_new = fmaxf(m[i], warp_max(x));
    const float corr = expf(m[i] - m_new);
    const float p = ok ? expf(x - m_new) : 0.f;
    l[i] = fmaf(l[i], corr, p);
    m[i] = m_new;
    ps[(warp + NW * i) * TILE + lane] = p;
#pragma unroll
    for (int jj = 0; jj < NDV; ++jj) acc[i][jj] *= corr;
  }
  __syncwarp();

#pragma unroll 4
  for (int j = 0; j < nj; ++j) {
    const T* vr = vs + j * L.vstride;
    float vv[NDV];
#pragma unroll
    for (int jj = 0; jj < NDV; ++jj) {
      const int col = lane + 32 * jj;
      vv[jj] = (DK || col < dv) ? to_f(vr[col]) : 0.f;
    }
#pragma unroll
    for (int i = 0; i < RPW; ++i) {
      const float pj = ps[(warp + NW * i) * TILE + j];
#pragma unroll
      for (int jj = 0; jj < NDV; ++jj) acc[i][jj] = fmaf(pj, vv[jj], acc[i][jj]);
    }
  }
}

// The whole KV loop of one block over [start, end) (empty when end <=
// start): a ring of NS stages, the next NS - 1 tiles in flight while the
// current one is computed.  The caller has written the q rows and anything
// row_of reads, and synchronised if row_of reads shared memory (the first
// tile's barrier publishes the q rows).  busy: this warp owns a row below
// nr.
template <typename T, int DK, int RPW, int NS, typename RowOf>
__device__ __forceinline__ void kv_loop(unsigned char* smem, const Layout& L, int d, int dv,
                                        const T* kg, const T* vg, size_t k_ld, size_t v_ld,
                                        int start, int end, RowOf row_of, bool busy,
                                        const int (&rend)[RPW], float softcap,
                                        float (&m)[RPW], float (&l)[RPW],
                                        float (&acc)[RPW][(DK ? DK : MAXD) / 32]) {
  const float* qs = reinterpret_cast<const float*>(smem + L.q);
  float* ps = reinterpret_cast<float*>(smem + L.p);
  auto ks = [&](int st) { return reinterpret_cast<T*>(smem + st * L.stage); };
  auto vs = [&](int st) { return ks(st) + TILE * L.kstride; };
  const int ntiles = end > start ? (end - start + TILE - 1) / TILE : 0;
#pragma unroll
  for (int st = 0; st < NS - 1; ++st) {
    if (st < ntiles)
      stage_tile<T>(ks(st), vs(st), L, d, dv, kg, vg, k_ld, v_ld, start + st * TILE, end,
                    row_of);
    cp_async_commit();
  }
  for (int it = 0; it < ntiles; ++it) {
    const int nx = it + NS - 1;
    if (nx < ntiles)
      stage_tile<T>(ks(nx % NS), vs(nx % NS), L, d, dv, kg, vg, k_ld, v_ld,
                    start + nx * TILE, end, row_of);
    cp_async_commit();
    cp_async_wait<NS - 1>();
    __syncthreads();
    const int t0 = start + it * TILE;
    if (busy)
      tile_update<T, DK, RPW>(ks(it % NS), vs(it % NS), L, d, dv, qs, ps, t0,
                              min(TILE, end - t0), rend, softcap, m, l, acc);
    __syncthreads();
  }
#pragma unroll
  for (int i = 0; i < RPW; ++i) l[i] = warp_sum(l[i]);
}

// Leave this block's partials in its shared memory, then rank 0 of the
// cluster merges the splits' partials in rank order, as combine_partials of
// the reference (weights exp(m_i - max m), num / max(den, 1e-30)), and
// writes row r's output through out_row(r) for r < nr.  Every block of the
// cluster must call this: it holds two cluster barriers.
template <typename T, int DK, int RPW, typename OutRow>
__device__ __forceinline__ void combine(unsigned char* smem, const Layout& L, int dv, int nr,
                                        int splits, const float (&m)[RPW],
                                        const float (&l)[RPW],
                                        const float (&acc)[RPW][(DK ? DK : MAXD) / 32],
                                        OutRow out_row) {
  constexpr int NDV = (DK ? DK : MAXD) / 32;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  float* pm = reinterpret_cast<float*>(smem + L.m);
  float* pl = reinterpret_cast<float*>(smem + L.l);
  float* pacc = reinterpret_cast<float*>(smem + L.acc);
#pragma unroll
  for (int i = 0; i < RPW; ++i) {
    const int r = warp + NW * i;
    if (lane == 0) {
      pm[r] = m[i];
      pl[r] = l[i];
    }
#pragma unroll
    for (int jj = 0; jj < NDV; ++jj) {
      const int col = lane + 32 * jj;
      if (DK || col < dv) pacc[r * dv + col] = acc[i][jj];
    }
  }
  cg::cluster_group cluster = cg::this_cluster();
  cluster.sync();
  if (cluster.block_rank() == 0) {
    // Every remote load of a step is issued before any is used: one round
    // trip through distributed shared memory for (m, l), one for acc.
    float* w = reinterpret_cast<float*>(smem + L.w);
    float* wl = reinterpret_cast<float*>(smem + L.wl);
    float* den = reinterpret_cast<float*>(smem + L.den);
    for (int i = threadIdx.x; i < nr * splits; i += NT) {
      const int r = i / splits, sp = i - r * splits;
      w[i] = cluster.map_shared_rank(pm, sp)[r];
      wl[i] = cluster.map_shared_rank(pl, sp)[r];
    }
    __syncthreads();
    for (int r = threadIdx.x; r < nr; r += NT) {
      float mx = NEG_INF;
      for (int sp = 0; sp < splits; ++sp) mx = fmaxf(mx, w[r * splits + sp]);
      float dn = 0.f;
      for (int sp = 0; sp < splits; ++sp) {
        const float wt = expf(w[r * splits + sp] - mx);
        w[r * splits + sp] = wt;
        dn = fmaf(wl[r * splits + sp], wt, dn);
      }
      den[r] = fmaxf(dn, 1e-30f);
    }
    __syncthreads();
    const int n4 = dv / 4;
    for (int i = threadIdx.x; i < nr * n4; i += NT) {
      const int r = i / n4, c = (i - r * n4) * 4;
      float4 part[MAX_SPLITS];
#pragma unroll
      for (int sp = 0; sp < MAX_SPLITS; ++sp)
        if (sp < splits)
          part[sp] = *reinterpret_cast<const float4*>(cluster.map_shared_rank(pacc, sp) +
                                                      r * dv + c);
      float num[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
      for (int sp = 0; sp < MAX_SPLITS; ++sp)
        if (sp < splits) {
          const float wt = w[r * splits + sp];
          num[0] = fmaf(part[sp].x, wt, num[0]);
          num[1] = fmaf(part[sp].y, wt, num[1]);
          num[2] = fmaf(part[sp].z, wt, num[2]);
          num[3] = fmaf(part[sp].w, wt, num[3]);
        }
      T* out = out_row(r) + c;
#pragma unroll
      for (int e = 0; e < 4; ++e) out[e] = from_f<T>(num[e] / den[r]);
    }
  }
  // Peers keep their shared memory alive until rank 0 has read it.
  cluster.sync();
}

// Launch `kern` on grid (splits * chunks, kvh, b) with clusters of `splits`
// blocks along x and `smem` bytes of dynamic shared memory.
template <typename... Params, typename... Args>
cudaError_t launch_clustered(void (*kern)(Params...), dim3 grid, int splits, size_t smem,
                             cudaStream_t stream, Args... args) {
  cudaError_t err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem);
  if (err != cudaSuccess) return err;
  if (splits > 8) {
    err = cudaFuncSetAttribute(kern, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    if (err != cudaSuccess) return err;
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = grid;
  cfg.blockDim = dim3(NT, 1, 1);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = splits;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, kern, args...);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

}  // namespace decode_common
