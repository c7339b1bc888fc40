// Ragged paged attention for Hopper (sm_90a) (K2, and K2q over int8 pages).
//
// Replaces the Pallas kernel of paddle_tpu/kernels/ragged_paged_attention.py
// (_ragged_pallas :184, pallas_call at :232; numerics oracle
// _reference_ragged at :89). Row b of the batch holds up to C new query
// tokens of one sequence; query j sits at absolute position start[b] + j
// and attends keys 0 .. start[b] + j of that sequence, read from
// [KVH, P, ps, D] pages through the block table page_indices[b, :]. GQA:
// query head h reads kv head h / (H / KVH). Rows j >= num_valid[b] (and
// whole idle lanes, num_valid = 0) are written as exactly 0, never NaN.
// K2q (quantized=True there, scales at :150-155) reads int8 pages whose
// (kv head, page, slot) rows carry one float32 scale ([KVH, P, ps]
// planes); an element is float(int8) * scale, the plain version's
// dequantization bit for bit.
//
// Design: flash-decoding over the ragged batch, two kernels counted as
// one K2 (or K2q) call. The TPU walks a row's pages as a sequential grid
// axis and carries (m, l, acc) from step to step; blocks on a GPU run in
// no order, so the walk is cut into chunks that run side by side.
// 1. ragged_split_kernel, grid (nsplit, KVH, B): the keys of the table,
//    maxp * ps of them, are cut into chunks of `chunk` keys (whole pages;
//    paged_attention.py split_geometry, a function of the table's shape
//    alone, never of the lengths, which live on the device). A chunk at or
//    past start + num_valid exits at once. A block serves every query
//    head of its kv head and every one of the row's num_valid queries, so
//    each K/V page row is read from device memory once a call. It finds
//    its keys' pool rows through the block table (an entry out of range
//    reads page 0), stages K, then V, with 16-byte cp.async in two commit
//    groups (the scores start once K is in), in the pages' own dtype;
//    int8 rows come with their scale entries and are dequantized at use.
//    The query rows r = j * G + g (G query heads a kv head) go in tiles of
//    16, one mma row tile, so any C and G fit: per tile,
//      scores   S = q k^T, a warp a quarter of the chunk's keys. float32
//               (q, or any q over int8 pages): 3xTF32 on mma.m16n8k8, q
//               scaled by sm_scale in float32 first, as the plain version
//               does, each operand split into tf32 hi + lo at use.
//               bfloat16: mma.m16n8k16 on the raw bf16 q and K, S scaled
//               after (q * scale rounded to bf16 would add an error the
//               plain version does not make);
//      softmax  over the chunk, 8 threads a row. Row j sees the chunk's
//               keys kk < min(nk, start + j - k0 + 1): the causal mask
//               cuts only the chunk that holds the diagonal. A row that
//               sees none of them (a prefill query ahead of a later chunk)
//               writes l = 0;
//      P V      a warp a quarter of the head dim, P from shared memory
//               (bf16: P rounded to bf16 for the product, l summed from
//               the unrounded P, as the flash forward does);
//    and writes a float32 partial (m, l, acc) per (row, query, head,
//    split). Blocks of at most `dot_rows` query rows (a decode row)
//    take the scores a thread a (row, key) and P V a thread a (row,
//    column) from shared memory instead (K13's dot-product path), in
//    float32.
// 2. ragged_merge_kernel, grid (H, C, B): merges a query's partials in
//    split order (an l = 0 partial weighs 0) and writes every element of
//    out (rows j >= num_valid as 0). The sum order is fixed: two calls
//    give the same bits, with no atomics, and a row's output depends on
//    its own start, num_valid, block table and the table's shape alone,
//    whatever rows run beside it.
// Keys past start + num_valid in a row's last page (stale rows) and the
// junk page 0 are never staged past nk, and every key past a query's
// diagonal gets p = 0, so neither is ever summed.
//
// Bound: memory. The least traffic is the K/V pages the rows need,
// sum_b ceil((start_b + num_valid_b) / ps) * ps * D * 2 * KVH elements
// (int8: D + 4 bytes a slot), plus q and out. Each needed page row is
// read once a call; the partials add live (query, head, split) rows of
// D + 2 floats, written and read once.

#include <math.h>

#include <type_traits>

#include "common.cuh"
#include "mma.cuh"

namespace {

constexpr float kNegInf = -1e30f;   // the JAX package's NEG_INF
constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxChunk = 64;       // paged_attention.py CHUNK_KEYS
constexpr int kTile = 16;           // query rows of a tile: one mma row tile
constexpr int kSLd = kMaxChunk + 8;  // row stride of the scores, in floats
static_assert(kMaxChunk <= kThreads, "a thread finds a key's pool row");
static_assert(kThreads == 8 * kTile, "8 threads a row in the softmax");
static_assert(kMaxChunk == 16 * kWarps, "a warp scores 16 keys");
static_assert(2 * kThreads >= 256, "a merge thread writes 2 of D <= 256");
static_assert(kTile * 32 % kThreads == 0, "whole q tiles a thread");

// Byte offsets of a block's shared-memory regions, every one 16-byte
// aligned whatever D and dtype: the chunk's pool rows (int64), its K and
// V rows (KT, rows padded by 16 bytes so consecutive rows shift by 4
// banks), the int8 pages' scale entries, a tile of query rows (float32,
// or bf16 in the same space) and the tile's scores (float32).
template <typename T, typename KT, int DP>
struct Layout {
  static constexpr bool kQuant = std::is_same<KT, int8_t>::value;
  // bf16 q over bf16 pages multiplies in bf16; all else in 3xTF32
  static constexpr bool kBf16 =
      std::is_same<T, __nv_bfloat16>::value && !kQuant;
  static constexpr int LDK = DP + 16 / static_cast<int>(sizeof(KT));
  static constexpr int LDQ = DP + 4;   // float32 q rows
  static constexpr int LDQB = DP + 8;  // bf16 q rows
  static constexpr int kv = kMaxChunk * LDK * static_cast<int>(sizeof(KT));
  static constexpr int sc = kQuant ? 4 * kMaxChunk : 0;
  static constexpr int k = 8 * kMaxChunk;
  static constexpr int v = k + kv;
  static constexpr int ks = v + kv;
  static constexpr int vs = ks + sc;
  static constexpr int q = vs + sc;
  static constexpr int s = q + 4 * kTile * LDQ;
  static constexpr int bytes = s + 4 * kTile * kSLd;
  static_assert(kv % 16 == 0 && sc % 16 == 0 && k % 16 == 0 &&
                    (4 * kTile * LDQ) % 16 == 0,
                "every region starts 16-byte aligned");
  static_assert(2 * kTile * LDQB <= 4 * kTile * LDQ,
                "bf16 q rows fit the float32 rows' space");
};

// Element (row, col) of a staged K or V tile as float32; int8 rows times
// their scale.
template <typename KT>
__device__ __forceinline__ float kv_at(const KT* s, const float* scales,
                                       int row, int ld, int col) {
  float x = pt::to_float(s[row * ld + col]);
  if constexpr (std::is_same<KT, int8_t>::value) x *= scales[row];
  return x;
}

__device__ __forceinline__ uint32_t ld32(const void* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// S[16 rows, this warp's 16 keys] = q k^T on the tensor cores, into sS.
template <typename T, typename KT, int DP>
__device__ __forceinline__ void mma_scores(const unsigned char* sQ,
                                           const KT* sK, const float* sKs,
                                           float* sS, int nkp,
                                           float sm_scale) {
  using L = Layout<T, KT, DP>;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int kb = 16 * warp;
  if (kb >= nkp) return;   // no key of the chunk here
  float acc[2][4] = {};
  if constexpr (L::kBf16) {
    const __nv_bfloat16* q = reinterpret_cast<const __nv_bfloat16*>(sQ);
#pragma unroll 4
    for (int d0 = 0; d0 < DP; d0 += 16) {
      uint32_t a[4];
      a[0] = ld32(q + g * L::LDQB + d0 + 2 * t);
      a[1] = ld32(q + (g + 8) * L::LDQB + d0 + 2 * t);
      a[2] = ld32(q + g * L::LDQB + d0 + 2 * t + 8);
      a[3] = ld32(q + (g + 8) * L::LDQB + d0 + 2 * t + 8);
#pragma unroll
      for (int n = 0; n < 2; ++n) {
        const KT* kr = sK + (kb + 8 * n + g) * L::LDK + d0 + 2 * t;
        pt::mma::mma_bf16(acc[n], a, ld32(kr), ld32(kr + 8));
      }
    }
  } else {
    const float* q = reinterpret_cast<const float*>(sQ);
#pragma unroll 4
    for (int d0 = 0; d0 < DP; d0 += 8) {
      uint32_t ah[4], al[4];
      pt::mma::split_tf32(q[g * L::LDQ + d0 + t], ah[0], al[0]);
      pt::mma::split_tf32(q[(g + 8) * L::LDQ + d0 + t], ah[1], al[1]);
      pt::mma::split_tf32(q[g * L::LDQ + d0 + t + 4], ah[2], al[2]);
      pt::mma::split_tf32(q[(g + 8) * L::LDQ + d0 + t + 4], ah[3], al[3]);
#pragma unroll
      for (int n = 0; n < 2; ++n) {
        const int row = kb + 8 * n + g;
        uint32_t bh0, bl0, bh1, bl1;
        pt::mma::split_tf32(kv_at(sK, sKs, row, L::LDK, d0 + t), bh0, bl0);
        pt::mma::split_tf32(kv_at(sK, sKs, row, L::LDK, d0 + t + 4), bh1,
                            bl1);
        pt::mma::mma_tf32(acc[n], al, bh0, bh1);
        pt::mma::mma_tf32(acc[n], ah, bl0, bl1);
        pt::mma::mma_tf32(acc[n], ah, bh0, bh1);
      }
    }
  }
  const float sc = L::kBf16 ? sm_scale : 1.f;   // float32 q came scaled
#pragma unroll
  for (int n = 0; n < 2; ++n) {
    const int c = kb + 8 * n + 2 * t;
    *reinterpret_cast<float2*>(sS + g * kSLd + c) =
        make_float2(acc[n][0] * sc, acc[n][1] * sc);
    *reinterpret_cast<float2*>(sS + (g + 8) * kSLd + c) =
        make_float2(acc[n][2] * sc, acc[n][3] * sc);
  }
}

// acc[16 rows, this warp's DP / 4 columns] = P V on the tensor cores.
// float32: k runs in the order (2t, 2t + 1) -> (t, t + 4) inside each 8
// keys (as mma.cuh warp_mma_pb), so P's pairs load as float2 and V's
// fragment loads are free of bank conflicts.
template <typename T, typename KT, int DP>
__device__ __forceinline__ void mma_pv(const float* sS, const KT* sV,
                                       const float* sVs, int nkp,
                                       float (&acc)[DP / 32][4]) {
  using L = Layout<T, KT, DP>;
  constexpr int OT = DP / 32;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int cw = warp * (DP / 4);
#pragma unroll
  for (int o = 0; o < OT; ++o)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[o][e] = 0.f;
  if constexpr (L::kBf16) {
    const uint16_t* v = reinterpret_cast<const uint16_t*>(sV);
    for (int kk0 = 0; kk0 < nkp; kk0 += 16) {
      const float2 p00 =
          *reinterpret_cast<const float2*>(sS + g * kSLd + kk0 + 2 * t);
      const float2 p10 = *reinterpret_cast<const float2*>(
          sS + (g + 8) * kSLd + kk0 + 2 * t);
      const float2 p01 =
          *reinterpret_cast<const float2*>(sS + g * kSLd + kk0 + 2 * t + 8);
      const float2 p11 = *reinterpret_cast<const float2*>(
          sS + (g + 8) * kSLd + kk0 + 2 * t + 8);
      const uint32_t a[4] = {pt::mma::pack_bf16(p00.x, p00.y),
                             pt::mma::pack_bf16(p10.x, p10.y),
                             pt::mma::pack_bf16(p01.x, p01.y),
                             pt::mma::pack_bf16(p11.x, p11.y)};
#pragma unroll
      for (int o = 0; o < OT; ++o) {
        const uint16_t* vr = v + (kk0 + 2 * t) * L::LDK + cw + 8 * o + g;
        const uint32_t b0 = vr[0] | (static_cast<uint32_t>(vr[L::LDK]) << 16);
        const uint32_t b1 = vr[8 * L::LDK] |
                            (static_cast<uint32_t>(vr[9 * L::LDK]) << 16);
        pt::mma::mma_bf16(acc[o], a, b0, b1);
      }
    }
  } else {
    for (int kk0 = 0; kk0 < nkp; kk0 += 8) {
      const float2 p0 =
          *reinterpret_cast<const float2*>(sS + g * kSLd + kk0 + 2 * t);
      const float2 p1 = *reinterpret_cast<const float2*>(
          sS + (g + 8) * kSLd + kk0 + 2 * t);
      uint32_t ah[4], al[4];
      pt::mma::split_tf32(p0.x, ah[0], al[0]);
      pt::mma::split_tf32(p1.x, ah[1], al[1]);
      pt::mma::split_tf32(p0.y, ah[2], al[2]);
      pt::mma::split_tf32(p1.y, ah[3], al[3]);
#pragma unroll
      for (int o = 0; o < OT; ++o) {
        const int col = cw + 8 * o + g;
        uint32_t bh0, bl0, bh1, bl1;
        pt::mma::split_tf32(kv_at(sV, sVs, kk0 + 2 * t, L::LDK, col), bh0,
                            bl0);
        pt::mma::split_tf32(kv_at(sV, sVs, kk0 + 2 * t + 1, L::LDK, col),
                            bh1, bl1);
        pt::mma::mma_tf32(acc[o], al, bh0, bh1);
        pt::mma::mma_tf32(acc[o], ah, bl0, bl1);
        pt::mma::mma_tf32(acc[o], ah, bh0, bh1);
      }
    }
  }
}

__device__ __forceinline__ float dot_k(const float* k, const float*,
                                       int row, int ld, const float* q,
                                       int D, int vec) {
  return pt::dot_row(k + row * ld, q, D, vec);
}
__device__ __forceinline__ float dot_k(const __nv_bfloat16* k, const float*,
                                       int row, int ld, const float* q,
                                       int D, int vec) {
  return pt::dot_row(k + row * ld, q, D, vec);
}
__device__ __forceinline__ float dot_k(const int8_t* k, const float* scales,
                                       int row, int ld, const float* q,
                                       int D, int vec) {
  return pt::dot_row(k + row * ld, scales[row], q, D, vec);
}

template <typename T, typename KT, int DP>
__global__ void __launch_bounds__(kThreads)
    ragged_split_kernel(const T* __restrict__ q,             // [B, C, H, D]
                        const KT* __restrict__ k_pages,      // [KVH, P, ps, D]
                        const KT* __restrict__ v_pages,      // [KVH, P, ps, D]
                        const float* __restrict__ k_scales,  // [KVH, P, ps]
                        const float* __restrict__ v_scales,  // (int8 KT only)
                        const int* __restrict__ start_pos,   // [B]
                        const int* __restrict__ num_valid,   // [B]
                        const int* __restrict__ tables,      // [B, maxp]
                        float* __restrict__ part_acc,  // [B, C, H, nsplit, D]
                        float* __restrict__ part_ml,   // [B, C, H, nsplit, 2]
                        int C, int H, int D, int KVH, int P, int ps,
                        int maxp, int chunk, int nsplit, float sm_scale,
                        int vec, int dot_rows) {
  using L = Layout<T, KT, DP>;
  extern __shared__ __align__(16) unsigned char smem[];
  int64_t* sRow = reinterpret_cast<int64_t*>(smem);         // [kMaxChunk]
  KT* sK = reinterpret_cast<KT*>(smem + L::k);               // [64, LDK]
  KT* sV = reinterpret_cast<KT*>(smem + L::v);               // [64, LDK]
  float* sKs = reinterpret_cast<float*>(smem + L::ks);       // [64] int8
  float* sVs = reinterpret_cast<float*>(smem + L::vs);       // [64] int8
  unsigned char* sQ = smem + L::q;                           // [16, LDQ]
  float* sQf = reinterpret_cast<float*>(sQ);
  float* sS = reinterpret_cast<float*>(smem + L::s);         // [16, kSLd]

  const int split = blockIdx.x, kvh = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x;
  const int G = H / KVH, h0 = kvh * G;
  const int k0 = split * chunk;
  // the block-table entry of a thread's key is read beside the lengths,
  // not after them
  const int key = k0 + tid;
  int page = tid < chunk && key < maxp * ps
                 ? tables[static_cast<int64_t>(b) * maxp + key / ps]
                 : 0;
  const int start = start_pos[b];
  const int nv = min(num_valid[b], C);
  // the keys any query of the row attends, within the table
  const int total = min(start + nv, maxp * ps);
  if (nv <= 0 || k0 >= total) return;   // no query sees this chunk
  const int nk = min(chunk, total - k0);  // keys staged
  const int nkp = (nk + 15) & ~15;        // keys the products cover
  const int M = nv * G;                   // query rows r = j * G + g
  const bool dot = M <= dot_rows;

  // each key's (kv head, page, slot) row in the pools
  if (tid < nk) {
    if (page < 0 || page >= P) page = 0;   // never read outside the pool
    sRow[tid] = (static_cast<int64_t>(kvh) * P + page) * ps + key % ps;
  }
  __syncthreads();
  // K, then V, in two cp.async groups; rows nk .. nkp and columns past D
  // are zeros (finite, so p = 0 times them adds nothing)
  auto stage = [&](KT* dst, const KT* src) {
    if (vec) {
      constexpr int CH = 16 / static_cast<int>(sizeof(KT)), NCH = DP / CH;
      for (int it = tid; it < nkp * NCH; it += kThreads) {
        const int i = it / NCH, c = (it - i * NCH) * CH;
        const bool ok = i < nk && c < D;
        pt::mma::cp_async16(dst + i * L::LDK + c,
                            ok ? src + sRow[i] * D + c : src, ok);
      }
    } else {
      for (int it = tid; it < nkp * DP; it += kThreads) {
        const int i = it / DP, c = it - i * DP;
        dst[i * L::LDK + c] = (i < nk && c < D) ? src[sRow[i] * D + c]
                                                : static_cast<KT>(0.f);
      }
    }
    pt::mma::cp_async_commit();
  };
  stage(sK, k_pages);
  stage(sV, v_pages);
  // the int8 rows' scales, plain loads behind the copies (read after the
  // first tile's barrier)
  if constexpr (L::kQuant) {
    if (tid < kMaxChunk) {
      sKs[tid] = tid < nk ? k_scales[sRow[tid]] : 0.f;
      sVs[tid] = tid < nk ? v_scales[sRow[tid]] : 0.f;
    }
  }

  for (int r0 = 0; r0 < M; r0 += kTile) {
    if (r0 > 0) __syncthreads();   // the last tile's q rows and p are read
    // the tile's query rows: float32 scaled by sm_scale first (as the
    // plain version), or raw bf16 for the bf16 products; zeros past M, D.
    // Every load is issued before the first store waits on one.
    constexpr int QPT = kTile * DP / kThreads;
    T xq[QPT];
#pragma unroll
    for (int u = 0; u < QPT; ++u) {
      const int it = tid + u * kThreads, i = it / DP, c = it - i * DP;
      const int r = r0 + i, j = r / G, g = r - j * G;
      xq[u] = r < M && c < D
                  ? q[((static_cast<int64_t>(b) * C + j) * H + h0 + g) * D +
                      c]
                  : static_cast<T>(0.f);
    }
#pragma unroll
    for (int u = 0; u < QPT; ++u) {
      const int it = tid + u * kThreads, i = it / DP, c = it - i * DP;
      if (L::kBf16 && !dot)
        reinterpret_cast<T*>(sQ)[i * L::LDQB + c] = xq[u];
      else
        sQf[i * L::LDQ + c] = pt::to_float(xq[u]) * sm_scale;
    }
    pt::mma::cp_async_wait<1>();   // K is in (V may still be on its way)
    __syncthreads();
    const int rows = min(kTile, M - r0);
    if (dot) {   // a thread a (row, key)
      const int kvec = (D * static_cast<int>(sizeof(KT))) % 16 == 0;
      for (int it = tid; it < rows * nk; it += kThreads) {
        const int i = it / nk, kk = it - i * nk;
        sS[i * kSLd + kk] = dot_k(sK, sKs, kk, L::LDK, sQf + i * L::LDQ, D,
                                  kvec);
      }
    } else {
      mma_scores<T, KT, DP>(sQ, sK, sKs, sS, nkp, sm_scale);
    }
    pt::mma::cp_async_wait<0>();
    __syncthreads();
    // the softmax over the chunk, 8 threads a row: p in place of s
    {
      const int i = tid >> 3, sub = tid & 7, r = r0 + i;
      const int j = r / G;
      // row r sees the chunk's keys kk < lim (its diagonal cuts the chunk
      // that holds it); rows past M see none
      const int lim = r < M ? min(nk, start + j - k0 + 1) : 0;
      float* srow = sS + i * kSLd;
      float mx = -INFINITY;
      for (int kk = sub; kk < kMaxChunk; kk += 8)
        if (kk < lim) mx = fmaxf(mx, srow[kk]);
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 4));
      float l = 0.f;
      for (int kk = sub; kk < kMaxChunk; kk += 8) {
        const float p = kk < lim ? expf(srow[kk] - mx) : 0.f;
        srow[kk] = p;
        l += p;
      }
      l += __shfl_xor_sync(0xffffffffu, l, 1);
      l += __shfl_xor_sync(0xffffffffu, l, 2);
      l += __shfl_xor_sync(0xffffffffu, l, 4);
      if (sub == 0 && r < M) {
        const int g = r - j * G;
        float* ml = part_ml +
                    (((static_cast<int64_t>(b) * C + j) * H + h0 + g) *
                         nsplit + split) * 2;
        ml[0] = lim > 0 ? mx : kNegInf;
        ml[1] = l;   // 0 when the row sees none of the chunk
      }
    }
    __syncthreads();
    if (dot) {   // a thread a (row, column), keys in order
      for (int it = tid; it < rows * D; it += kThreads) {
        const int i = it / D, c = it - i * D, r = r0 + i;
        const float* p = sS + i * kSLd;
        float a0 = 0.f, a1 = 0.f, a2 = 0.f, a3 = 0.f;   // keys kk % 4
        int kk = 0;
        for (; kk + 4 <= nk; kk += 4) {
          a0 = fmaf(p[kk], kv_at(sV, sVs, kk, L::LDK, c), a0);
          a1 = fmaf(p[kk + 1], kv_at(sV, sVs, kk + 1, L::LDK, c), a1);
          a2 = fmaf(p[kk + 2], kv_at(sV, sVs, kk + 2, L::LDK, c), a2);
          a3 = fmaf(p[kk + 3], kv_at(sV, sVs, kk + 3, L::LDK, c), a3);
        }
        for (; kk < nk; ++kk)
          a0 = fmaf(p[kk], kv_at(sV, sVs, kk, L::LDK, c), a0);
        const int j = r / G, g = r - j * G;
        part_acc[(((static_cast<int64_t>(b) * C + j) * H + h0 + g) * nsplit +
                  split) * D + c] = (a0 + a1) + (a2 + a3);
      }
    } else {
      float acc[DP / 32][4];
      mma_pv<T, KT, DP>(sS, sV, sVs, nkp, acc);
      const int warp = tid >> 5, lane = tid & 31;
      const int g8 = lane >> 2, t = lane & 3;
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        const int r = r0 + g8 + 8 * hh;
        if (r >= M) continue;
        const int j = r / G, g = r - j * G;
        float* dst = part_acc +
                     (((static_cast<int64_t>(b) * C + j) * H + h0 + g) *
                          nsplit + split) * D;
#pragma unroll
        for (int o = 0; o < DP / 32; ++o) {
          const int c = warp * (DP / 4) + 8 * o + 2 * t;
          const float x0 = acc[o][2 * hh], x1 = acc[o][2 * hh + 1];
          if (c + 1 < D && (D & 1) == 0) {   // an aligned pair
            *reinterpret_cast<float2*>(dst + c) = make_float2(x0, x1);
          } else {
            if (c < D) dst[c] = x0;
            if (c + 1 < D) dst[c + 1] = x1;
          }
        }
      }
    }
  }
}

// KT names the variant (K2 or K2q) in a profile; the merge reads float32
// partials either way. The (m, l) of a tile of splits load side by side
// into shared memory (a split a thread), so no thread walks them one
// dependent load at a time; l and the output then sum in split order.
template <typename T, typename KT>
__global__ void __launch_bounds__(kThreads)
    ragged_merge_kernel(const float* __restrict__ part_acc,
                        const float* __restrict__ part_ml,
                        const int* __restrict__ start_pos,
                        const int* __restrict__ num_valid,
                        T* __restrict__ out, int C, int H, int D, int chunk,
                        int nsplit, int max_keys) {
  __shared__ float sw[kThreads];    // a tile's weights exp(m - mm), 0: skip
  __shared__ float slw[kThreads];   // and its l * weight
  __shared__ float smax[kWarps];
  const int h = blockIdx.x, j = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x;
  const int nv = num_valid[b], start = start_pos[b];
  int used = 0;   // the splits that hold keys query j sees, in order
  if (j < min(nv, C)) {
    const int n = min(start + j + 1, max_keys);
    used = n > 0 ? min(nsplit, (n + chunk - 1) / chunk) : 0;
  }
  const int64_t row = (static_cast<int64_t>(b) * C + j) * H + h;
  const float* ml = part_ml + row * nsplit * 2;
  const float* acc = part_acc + row * nsplit * D;
  // the largest m of the partials with l > 0 (an l = 0 one is skipped)
  float mx = kNegInf;
  for (int s = tid; s < used; s += kThreads)
    if (ml[2 * s + 1] > 0.f) mx = fmaxf(mx, ml[2 * s]);
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
  if ((tid & 31) == 0) smax[tid >> 5] = mx;
  __syncthreads();
  float mm = smax[0];
#pragma unroll
  for (int w = 1; w < kWarps; ++w) mm = fmaxf(mm, smax[w]);
  float ll = 0.f, o0 = 0.f, o1 = 0.f;   // columns tid, tid + kThreads
  for (int s0 = 0; s0 < used; s0 += kThreads) {
    const int n = min(kThreads, used - s0);
    if (s0 > 0) __syncthreads();   // the last tile is read
    if (tid < n) {
      const float l = ml[2 * (s0 + tid) + 1];
      const float w = l > 0.f ? expf(ml[2 * (s0 + tid)] - mm) : 0.f;
      sw[tid] = w;
      slw[tid] = l * w;
    }
    __syncthreads();
    for (int i = 0; i < n; ++i) ll += slw[i];
    // a skipped partial has weight 0 (its acc, written as 0, adds 0): the
    // loads carry no branch, so 8 are in flight at once
    const float* a = acc + static_cast<int64_t>(s0) * D;
    for (int i0 = 0; i0 < n; i0 += 8) {
      float x0[8], x1[8];
#pragma unroll
      for (int u = 0; u < 8; ++u) {
        const int64_t e = static_cast<int64_t>(i0 + u) * D + tid;
        x0[u] = i0 + u < n && tid < D ? a[e] : 0.f;
        x1[u] = i0 + u < n && tid + kThreads < D ? a[e + kThreads] : 0.f;
      }
#pragma unroll
      for (int u = 0; u < 8; ++u) {
        if (i0 + u < n) {
          o0 += x0[u] * sw[i0 + u];
          o1 += x1[u] * sw[i0 + u];
        }
      }
    }
  }
  const bool ok = ll > 0.f;
  const float inv = ok ? 1.f / ll : 0.f;
  if (tid < D) out[row * D + tid] = pt::from_float<T>(ok ? o0 * inv : 0.f);
  if (tid + kThreads < D)
    out[row * D + tid + kThreads] = pt::from_float<T>(ok ? o1 * inv : 0.f);
}

// The arguments every launch carries, past the template choices.
struct Args {
  const void *q, *kp, *vp;
  const float *ks, *vs;
  const int *start, *nvalid, *tables;
  void* out;
  float *part_acc, *part_ml;
  int B, C, H, D, KVH, P, ps, maxp, chunk, nsplit;
  float sm_scale;
  int dot_rows;
  cudaStream_t s;
};

template <typename T, typename KT, int DP>
int launch(const Args& a) {
  // the one statement of the block's shared memory: a size the card
  // refuses (float32 at D = 256 takes 155 KB) comes back as the error
  constexpr int smem = Layout<T, KT, DP>::bytes;
  auto kern = ragged_split_kernel<T, KT, DP>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int vec = (a.D * sizeof(KT)) % 16 == 0 &&
                  reinterpret_cast<uintptr_t>(a.kp) % 16 == 0 &&
                  reinterpret_cast<uintptr_t>(a.vp) % 16 == 0;
  kern<<<dim3(a.nsplit, a.KVH, a.B), kThreads, smem, a.s>>>(
      static_cast<const T*>(a.q), static_cast<const KT*>(a.kp),
      static_cast<const KT*>(a.vp), a.ks, a.vs, a.start, a.nvalid, a.tables,
      a.part_acc, a.part_ml, a.C, a.H, a.D, a.KVH, a.P, a.ps, a.maxp,
      a.chunk, a.nsplit, a.sm_scale, vec, a.dot_rows);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  ragged_merge_kernel<T, KT><<<dim3(a.H, a.C, a.B), kThreads, 0, a.s>>>(
      a.part_acc, a.part_ml, a.start, a.nvalid, static_cast<T*>(a.out), a.C,
      a.H, a.D, a.chunk, a.nsplit, a.maxp * a.ps);
  return static_cast<int>(cudaGetLastError());
}

// the head dim padded to a multiple of 32 (a quarter a warp in P V)
template <typename T, typename KT>
int dispatch_dim(const Args& a) {
  if (a.D <= 32) return launch<T, KT, 32>(a);
  if (a.D <= 64) return launch<T, KT, 64>(a);
  if (a.D <= 128) return launch<T, KT, 128>(a);
  return launch<T, KT, 256>(a);
}

// Validates the shapes and picks the template arguments: the page dtype
// is q's own, or int8 for K2q (kQuant).
template <bool kQuant>
int run(const void* q, const void* k_pages, const void* v_pages,
        const void* k_scales, const void* v_scales, const void* start_pos,
        const void* num_valid, const void* page_indices, void* out,
        void* part_acc, void* part_ml, int B, int C, int H, int D, int KVH,
        int P, int ps, int maxp, int chunk, int nsplit, float sm_scale,
        int dot_rows, int dtype, void* stream) {
  if (B <= 0 || C <= 0) return 0;
  if (D <= 0 || D > 256 || C > 64 || KVH <= 0 || H % KVH != 0 || ps <= 0 ||
      maxp <= 0 || P <= 0 || chunk <= 0 || chunk > kMaxChunk ||
      static_cast<int64_t>(nsplit) * chunk < static_cast<int64_t>(maxp) * ps)
    return static_cast<int>(cudaErrorInvalidValue);
  Args a;
  a.q = q;
  a.kp = k_pages;
  a.vp = v_pages;
  a.ks = static_cast<const float*>(k_scales);
  a.vs = static_cast<const float*>(v_scales);
  a.start = static_cast<const int*>(start_pos);
  a.nvalid = static_cast<const int*>(num_valid);
  a.tables = static_cast<const int*>(page_indices);
  a.out = out;
  a.part_acc = static_cast<float*>(part_acc);
  a.part_ml = static_cast<float*>(part_ml);
  a.B = B;
  a.C = C;
  a.H = H;
  a.D = D;
  a.KVH = KVH;
  a.P = P;
  a.ps = ps;
  a.maxp = maxp;
  a.chunk = chunk;
  a.nsplit = nsplit;
  a.sm_scale = sm_scale;
  a.dot_rows = dot_rows;
  a.s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case pt::kFloat32:
      return dispatch_dim<float, typename std::conditional<kQuant, int8_t,
                                                           float>::type>(a);
    case pt::kBFloat16:
      return dispatch_dim<__nv_bfloat16,
                          typename std::conditional<kQuant, int8_t,
                                                    __nv_bfloat16>::type>(a);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// q, out: [B, C, H, D]; k_pages, v_pages: [KVH, P, ps, D]; all of one
// dtype (float32 or bfloat16), contiguous. start_pos, num_valid: [B]
// int32; page_indices: [B, maxp] int32. chunk, nsplit:
// split_geometry(maxp, ps) of paged_attention.py; part_acc: float32
// [B, C, H, nsplit, D] and part_ml [B, C, H, nsplit, 2], the partials'
// workspace (only the live ones are written and read). dot_rows: blocks
// of at most that many query rows (num_valid * H / KVH) take the
// dot-product path. Limits (checked again by the Python wrapper):
// D <= 256, C <= 64, H % KVH == 0, 0 < chunk <= 64,
// nsplit * chunk >= maxp * ps, and the block's shared memory (Layout)
// within the card's.
extern "C" int pt_ragged_paged_attention(
    const void* q, const void* k_pages, const void* v_pages,
    const void* start_pos, const void* num_valid, const void* page_indices,
    void* out, void* part_acc, void* part_ml, int B, int C, int H, int D,
    int KVH, int P, int ps, int maxp, int chunk, int nsplit, float sm_scale,
    int dot_rows, int dtype, void* stream) {
  return run<false>(q, k_pages, v_pages, nullptr, nullptr, start_pos,
                    num_valid, page_indices, out, part_acc, part_ml, B, C, H,
                    D, KVH, P, ps, maxp, chunk, nsplit, sm_scale, dot_rows,
                    dtype, stream);
}

// K2q: as above with int8 k_pages / v_pages and their float32 scale
// planes k_scales, v_scales [KVH, P, ps]; q and out float32 or
// bfloat16 (dtype).
extern "C" int pt_ragged_paged_attention_q(
    const void* q, const void* k_pages, const void* v_pages,
    const void* k_scales, const void* v_scales, const void* start_pos,
    const void* num_valid, const void* page_indices, void* out,
    void* part_acc, void* part_ml, int B, int C, int H, int D, int KVH, int P,
    int ps, int maxp, int chunk, int nsplit, float sm_scale, int dot_rows,
    int dtype, void* stream) {
  return run<true>(q, k_pages, v_pages, k_scales, v_scales, start_pos,
                   num_valid, page_indices, out, part_acc, part_ml, B, C, H,
                   D, KVH, P, ps, maxp, chunk, nsplit, sm_scale, dot_rows,
                   dtype, stream);
}
