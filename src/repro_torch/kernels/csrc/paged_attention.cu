// Paged attention for Hopper (sm_90a), CUDA C++ with fp32 FMA.
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
// o [B, T, H, Dv], all contiguous; f32/bf16; D and Dv a multiple of 16
// bytes, the pools 16-byte aligned.
//
// What is not carried over from the TPU: the 8-sublane row padding of the
// GQA group (_group_pad) and the power-of-two bucketing of nb (bucket_nb,
// _pad_tables), which only cap jit recompiles; nb is a runtime int here.
// Scalar prefetch becomes each block loading its own table entries once,
// into shared memory, and only for the pages its rows can see.
//
// What bounds it on the H100: every valid K/V row is read once for only
// 2*T*G*(D+Dv) operations (G = query heads per KV head): 1.5 operations a
// byte at T = 1, G = 3 in f32, far under the card's ridge, so it is bound
// by the bytes of the valid K/V rows and, at decode sizes, by how many are
// in flight.  The design (shared with K3, decode_common.cuh):
//
// - Split-K over pages.  The grid is (splits x row chunks, KV, B); the
//   splits of one (batch, KV head, chunk of <= 16 of the T*G query rows;
//   row r = t*G + g) form one thread-block cluster.  The host picks the
//   split count from the table width nb and the page size bs alone
//   (ceil(nb*bs / 64), clamped to [1, 16]) and P = ceil(nb / splits) pages
//   a split: split i covers logical pages [i*P, (i+1)*P); 14 splits of 5
//   pages for the 66-page tables of 1k-token prompts.  A block loads the
//   table entries of its pages below ceil(len / bs), len = the largest
//   limit of its rows, so entries past the last valid page are never read;
//   a block whose pages lie past every row's limit reads nothing and leaves
//   the empty partial (m = -1e30, l = 0, acc = 0).  With up to 16 rows a
//   block, the T = 5 verify window at G = 3 (15 rows) reads each page once.
// - A row's result depends only on its own limit, bit for bit: split
//   boundaries depend on nb, bs and the split count only, tiles start at
//   the split's first page, and positions at or past a row's limit leave
//   its state exactly unchanged.  So the window's row t equals the decode
//   entry at the same limit (test_paged_window_rows_do_not_depend_on_t).
// - cp.async.  Within a page the rows of one KV head are runs of D
//   elements (256 bytes at D = 64, f32); they are copied in 16-byte pieces,
//   eight threads to a position (one table lookup each), neighbouring
//   threads on neighbouring addresses, into a ring of 3 tiles of 32
//   positions (2 for the general head widths).  q is loaded beside kv_len;
//   the table entries need kv_len, so K1 starts its copies one round trip
//   after K3.  No TMA: the tiles are gathers through the block table, and
//   a tensor map would need the driver API's cuTensorMapEncodeTiled, which
//   this ctypes-loaded library does not link.
// - Compute from shared memory, as K3: 8 warps, warp w owns rows w and
//   w + 8; one position per lane for the scores; lanes own output columns
//   for P.V.  No tensor cores: fp32 FMA is far from binding at 1.5
//   operations a byte.
// - Combine in the same launch: rank 0 of the cluster gathers the splits'
//   (m, l, acc) through distributed shared memory, all loads of a step in
//   flight at once, and merges them in rank order, as combine_partials
//   (src/repro/kernels/decode_attention/xla.py:58-73).
//
// Instances: D = Dv = 64 (the main path's width) and a general one for
// D, Dv <= 256.

#include "decode_common.cuh"

namespace {

using namespace decode_common;

template <typename T, int DK, int RPW, int NS>
__global__ void __launch_bounds__(NT, MIN_BLOCKS)
paged_fwd(const T* __restrict__ q, const T* __restrict__ kp, const T* __restrict__ vp,
          const int* __restrict__ bt, const int* __restrict__ kv_len, T* __restrict__ o,
          int tw, int h, int kvh, int d_arg, int dv_arg, int bs, int nb, int offset,
          float softcap, float scale, int splits, int pps) {
  constexpr int RC = RPW * NW;
  constexpr int NDV = (DK ? DK : MAXD) / 32;
  extern __shared__ __align__(16) unsigned char smem[];
  const int d = DK ? DK : d_arg, dv = DK ? DK : dv_arg;
  const Layout L = make_layout(sizeof(T), NS, RC, d, dv, splits, pps);
  const int rank = (int)cg::this_cluster().block_rank();
  const int group = h / kvh;
  const int r0 = (blockIdx.x / splits) * RC;
  const int nr = min(RC, tw * group - r0);
  const int kh = blockIdx.y, b = blockIdx.z;
  const int warp = threadIdx.x >> 5;
  const int base = kv_len[b] + offset;
  const int cap = nb * bs;
  // q does not depend on the lengths: its loads overlap kv_len's.
  load_q<T, RC, DK>(reinterpret_cast<float*>(smem + L.q), d, nr, scale, [=](int r) {
    const int row = r0 + r, t = row / group, g = row - t * group;
    return q + (((size_t)b * tw + t) * h + kh * group + g) * d;
  });

  // Row i of the block is window position t = (r0 + i) / group, query head
  // kh * group + (r0 + i) % group; it sees positions < limit(i).
  auto limit = [&](int i) {
    return i < nr ? max(0, min(base + (r0 + i) / group + 1, cap)) : 0;
  };
  int len = 0;
#pragma unroll
  for (int i = 0; i < RC; ++i) len = max(len, limit(i));
  const int p0 = rank * pps;                       // first logical page of the split
  const int start = p0 * bs;
  const int send = min(p0 + pps, nb) * bs;
  const int end = min(send, len);
  const int npages = end > start ? (end - 1) / bs + 1 - p0 : 0;

  int* pg = reinterpret_cast<int*>(smem + L.ints);
  for (int i = threadIdx.x; i < npages; i += NT) pg[i] = bt[(size_t)b * nb + p0 + i];
  __syncthreads();

  int rend[RPW];
  float m[RPW], l[RPW], acc[RPW][NDV];
#pragma unroll
  for (int i = 0; i < RPW; ++i) {
    rend[i] = min(send, limit(warp + NW * i));
    m[i] = NEG_INF;
    l[i] = 0.f;
#pragma unroll
    for (int jj = 0; jj < NDV; ++jj) acc[i][jj] = 0.f;
  }
  kv_loop<T, DK, RPW, NS>(
      smem, L, d, dv, kp + (size_t)kh * d, vp + (size_t)kh * dv, (size_t)kvh * d,
      (size_t)kvh * dv, start, end,
      [=](int pos) {
        const int page = pos / bs;
        return (size_t)pg[page - p0] * bs + (pos - page * bs);
      },
      warp < nr, rend, softcap, m, l, acc);
  combine<T, DK, RPW>(smem, L, dv, nr, splits, m, l, acc, [=](int r) {
    const int row = r0 + r, t = row / group, g = row - t * group;
    return o + (((size_t)b * tw + t) * h + kh * group + g) * dv;
  });
}

struct Call {
  const void *q, *kp, *vp, *bt, *kv_len;
  void* o;
  int b, tw, h, kvh, d, dv, bs, nb, offset;
  float softcap, scale;
  int splits, pps;
  cudaStream_t stream;
};

template <typename T, int DK, int RPW, int NS>
cudaError_t launch(const Call& a) {
  constexpr int RC = RPW * NW;
  const int chunks = (a.tw * (a.h / a.kvh) + RC - 1) / RC;
  const size_t smem =
      make_layout(sizeof(T), NS, RC, DK ? DK : a.d, DK ? DK : a.dv, a.splits, a.pps).total;
  return launch_clustered(
      paged_fwd<T, DK, RPW, NS>, dim3(a.splits * chunks, a.kvh, a.b), a.splits, smem,
      a.stream, static_cast<const T*>(a.q), static_cast<const T*>(a.kp),
      static_cast<const T*>(a.vp), static_cast<const int*>(a.bt),
      static_cast<const int*>(a.kv_len), static_cast<T*>(a.o), a.tw, a.h, a.kvh, a.d, a.dv,
      a.bs, a.nb, a.offset, a.softcap, a.scale, a.splits, a.pps);
}

template <typename T, int DK, int NS>
cudaError_t by_rows(const Call& a) {
  const int rows = a.tw * (a.h / a.kvh);
  if (rows <= NW) return launch<T, DK, 1, NS>(a);
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

// dtype: 0 = float32, 1 = bfloat16.  softcap <= 0: no softcap.  Row t of a
// sequence attends positions <= kv_len + offset + t.  splits blocks per
// (batch, KV head, row chunk), 1..16, each over pps logical pages; they must
// cover the nb pages of the table.  Returns the cudaError_t of the launch
// (0 on success).
extern "C" int paged_attention_fwd(const void* q, const void* k_pool,
                                   const void* v_pool, const void* block_tables,
                                   const void* kv_len, void* o, int dtype, int b,
                                   int tw, int h, int kvh, int d, int dv, int bs,
                                   int nb, int offset, float softcap, float scale,
                                   int splits, int pps, void* stream) {
  if (bs <= 0 || nb <= 0 || tw <= 0 || kvh <= 0 || h % kvh || splits < 1 ||
      splits > decode_common::MAX_SPLITS || pps < 1 || (long long)splits * pps < nb)
    return (int)cudaErrorInvalidValue;
  const Call a{q, k_pool, v_pool, block_tables, kv_len, o, b, tw, h, kvh, d, dv, bs, nb,
               offset, softcap, scale, splits, pps, static_cast<cudaStream_t>(stream)};
  if (dtype == 0) return (int)dispatch<float>(a);
  if (dtype == 1) return (int)dispatch<__nv_bfloat16>(a);
  return (int)cudaErrorInvalidValue;
}
