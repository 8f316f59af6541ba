// Flash-decoding for Hopper (sm_90a), CUDA C++ with fp32 FMA.
//
// Replaces the TPU kernel decode_attention_pallas
// (src/repro/kernels/decode_attention/decode_attention.py:75, body _dec_kernel
// :23): one query token per sequence attends to a contiguous KV cache with a
// per-sequence valid length kv_len; optional window (positions >
// kv_len - 1 - window) and tanh softcap; positions past kv_len are never
// read; online softmax in fp32, output in q's dtype.
//
// Layouts are the JAX package's: q [B, H, D], k [B, S, KV, D],
// v [B, S, KV, Dv], kv_len [B] int32, o [B, H, Dv], all contiguous; f32/bf16;
// D and Dv a multiple of 16 bytes, K and V 16-byte aligned.
//
// What bounds it on the H100: every valid K/V row is read once for only
// 2*G*(D+Dv) operations (G = query heads per KV head): 1.5 operations a
// byte at G = 3 in f32, two orders of magnitude under the card's ridge, so
// it is bound by the bytes of K/V and, at decode sizes (a few MB), by how
// many of them are in flight.  The design (shared with K1,
// decode_common.cuh):
//
// - Split-K.  The grid is (splits x row chunks, KV, B).  The splits of one
//   (batch, KV head, chunk of <= 16 of the G heads) are the blocks of one
//   thread-block cluster.  The host picks their number from the cache's
//   capacity S alone (ceil(S / 64), clamped to [1, 16]) and never reads
//   kv_len.  Each block computes its own slice of [lo, len), len =
//   min(kv_len, S), lo = clamp(kv_len - window, 0, len) with a window, in
//   whole 32-position tiles: ceil((len - lo) / splits) rounded up to a tile.  At B = 4,
//   KV = 3 and S = 1088 that is 192 blocks on 132 SMs, where one block per
//   (batch, KV head) gave 12.  Blocks are short, so a call costs a fixed
//   part (launch, the first loads, the combine) plus the per-tile time of
//   its longest split.
// - cp.async.  K and V rows are copied to shared memory in 16-byte pieces,
//   eight threads to a position, neighbouring threads on neighbouring
//   addresses of a row, into a ring of 3 tiles (2 for the general head
//   widths), so two tiles are in flight while one is computed.  No TMA: a tensor map needs the
//   driver API's cuTensorMapEncodeTiled, which this ctypes-loaded library
//   does not link, and 16-byte cp.async already coalesces each row.
// - Compute from shared memory.  8 warps; warp w owns query rows w and
//   w + 8 of the chunk, and a warp without a row skips the arithmetic.
//   Scores take one position per lane (staged rows padded by 16 bytes, so
//   the lanes' 16-byte reads do not collide in a bank) in four interleaved
//   partial sums; for P.V the lanes own output columns and walk the tile's
//   positions with p from shared memory; l is summed per lane and across
//   the warp once.  No tensor cores: at 1.5 operations a byte fp32 FMA is
//   far from binding.
// - Combine in the same launch.  Each block leaves (m, l, acc) of its rows
//   in shared memory; after a cluster barrier rank 0 reads its peers'
//   partials through distributed shared memory, every load of a step in
//   flight at once, and merges them in rank order as combine_partials does
//   (src/repro/kernels/decode_attention/xla.py:58-73).  No scratch in
//   device memory, no second launch.
//
// Instances: D = Dv = 64 (the main path's width) and a general one for
// D, Dv <= 256.

#include "decode_common.cuh"

namespace {

using namespace decode_common;

template <typename T, int DK, int RPW, int NS>
__global__ void __launch_bounds__(NT, MIN_BLOCKS)
dec_fwd(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
        const int* __restrict__ kv_len, T* __restrict__ o, int s, int h, int kvh,
        int d_arg, int dv_arg, int window, float softcap, float scale, int splits) {
  constexpr int RC = RPW * NW;
  constexpr int NDV = (DK ? DK : MAXD) / 32;
  extern __shared__ __align__(16) unsigned char smem[];
  const int d = DK ? DK : d_arg, dv = DK ? DK : dv_arg;
  const Layout L = make_layout(sizeof(T), NS, RC, d, dv, splits, 0);
  const int rank = (int)cg::this_cluster().block_rank();
  const int group = h / kvh;
  const int g0 = (blockIdx.x / splits) * RC;
  const int nr = min(RC, group - g0);
  const int kh = blockIdx.y, b = blockIdx.z;
  const int warp = threadIdx.x >> 5;
  // The cache has s slots: a length past them reads no further, as the
  // reference's mask over the s slots does; the window starts from the
  // unclamped length (positions > kv_len - 1 - window), as the reference's.
  const int n = kv_len[b];
  const int len = max(0, min(n, s));
  const int lo = window > 0 ? min(max(0, n - window), len) : 0;
  const int per = ((len - lo + splits - 1) / splits + TILE - 1) / TILE * TILE;
  const int start = lo + rank * per;
  const int end = min(start + per, len);

  load_q<T, RC, DK>(reinterpret_cast<float*>(smem + L.q), d, nr, scale,
                    [=](int r) { return q + ((size_t)b * h + kh * group + g0 + r) * d; });

  int rend[RPW];
  float m[RPW], l[RPW], acc[RPW][NDV];
#pragma unroll
  for (int i = 0; i < RPW; ++i) {
    rend[i] = warp + NW * i < nr ? end : 0;
    m[i] = NEG_INF;
    l[i] = 0.f;
#pragma unroll
    for (int jj = 0; jj < NDV; ++jj) acc[i][jj] = 0.f;
  }
  kv_loop<T, DK, RPW, NS>(smem, L, d, dv, k + (size_t)kh * d, v + (size_t)kh * dv,
                          (size_t)kvh * d, (size_t)kvh * dv, start, end,
                          [=](int pos) { return (size_t)b * s + pos; }, warp < nr, rend,
                          softcap, m, l, acc);
  combine<T, DK, RPW>(smem, L, dv, nr, splits, m, l, acc, [=](int r) {
    return o + ((size_t)b * h + kh * group + g0 + r) * dv;
  });
}

struct Call {
  const void *q, *k, *v, *kv_len;
  void* o;
  int b, s, h, kvh, d, dv, window;
  float softcap, scale;
  int splits;
  cudaStream_t stream;
};

template <typename T, int DK, int RPW, int NS>
cudaError_t launch(const Call& a) {
  constexpr int RC = RPW * NW;
  const int chunks = (a.h / a.kvh + RC - 1) / RC;
  const size_t smem =
      make_layout(sizeof(T), NS, RC, DK ? DK : a.d, DK ? DK : a.dv, a.splits, 0).total;
  return launch_clustered(dec_fwd<T, DK, RPW, NS>, dim3(a.splits * chunks, a.kvh, a.b),
                          a.splits, smem, a.stream, static_cast<const T*>(a.q),
                          static_cast<const T*>(a.k), static_cast<const T*>(a.v),
                          static_cast<const int*>(a.kv_len), static_cast<T*>(a.o), a.s, a.h,
                          a.kvh, a.d, a.dv, a.window, a.softcap, a.scale, a.splits);
}

template <typename T, int DK, int NS>
cudaError_t by_rows(const Call& a) {
  const int group = a.h / a.kvh;
  if (group <= NW) return launch<T, DK, 1, NS>(a);
  return launch<T, DK, 2, NS>(a);
}

template <typename T>
cudaError_t dispatch(const Call& a) {
  constexpr int VEC = 16 / sizeof(T);
  if (a.d % VEC || a.dv % VEC || a.d > MAXD || a.dv > MAXD) return cudaErrorInvalidValue;
  if (a.d == 64 && a.dv == 64) return by_rows<T, 64, 3>(a);
  return by_rows<T, 0, 2>(a);
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16.  window <= 0: no window; softcap <= 0: no
// softcap; splits: blocks per (batch, KV head, row chunk), 1..16.  Returns
// the cudaError_t of the launch (0 on success).
extern "C" int decode_attention_fwd(const void* q, const void* k, const void* v,
                                    const void* kv_len, void* o, int dtype, int b,
                                    int s, int h, int kvh, int d, int dv,
                                    int window, float softcap, float scale, int splits,
                                    void* stream) {
  if (splits < 1 || splits > decode_common::MAX_SPLITS || kvh <= 0 || h % kvh)
    return (int)cudaErrorInvalidValue;
  const Call a{q, k, v, kv_len, o, b, s, h, kvh, d, dv, window, softcap, scale, splits,
               static_cast<cudaStream_t>(stream)};
  if (dtype == 0) return (int)dispatch<float>(a);
  if (dtype == 1) return (int)dispatch<__nv_bfloat16>(a);
  return (int)cudaErrorInvalidValue;
}
