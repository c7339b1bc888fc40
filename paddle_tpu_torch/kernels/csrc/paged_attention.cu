// Paged decode attention for Hopper (sm_90a) (K13).
//
// Replaces paddle_tpu/kernels/paged_attention.py paged_attention (:104),
// which wraps JAX's library Pallas kernel
// jax.experimental.pallas.ops.tpu.paged_attention (:127); numerics
// oracle _reference_paged_attention (:56-85). One query row per
// sequence: q [B, H, D] attends the first lengths[b] keys of sequence b,
// read from [KVH, P, ps, D] pages through the block table
// page_indices[b, :]. GQA: query head h reads kv head h / (H / KVH). The
// reference scales q in float32 first, masks keys at or past the length
// with -1e30 and defines a length-0 row as zeros; so does this kernel,
// with the softmax taken per chunk of keys and the chunks merged.
//
// Design: flash-decoding, two kernels counted as one K13 call.
// 1. paged_attention_kernel, grid (nsplit, KVH, B): the key walk of a
//    row is cut into chunks of `chunk` keys (whole pages; the geometry is
//    paged_attention.py split_geometry, chosen from maxp * ps, which the
//    host knows, never from the lengths, which live on the device). A
//    block serves every query head of its kv head, so each K/V row is
//    read from device memory once. It stages its chunk's K and V rows
//    through the block table with 16-byte cp.async loads (page indices
//    out of range read page 0), one thread a (head, key) dot
//    product from shared memory (no shuffle a key), a warp a head for
//    the chunk's max and sum, one thread a (head, column) for P V, and
//    writes a float32 partial (m, l, acc) of the chunk. A chunk at or
//    past its row's length writes l = 0 and exits.
// 2. paged_attention_merge_kernel, grid (H, B): merges a row's partials
//    in split order, so the sum order is fixed: two calls give the same
//    bits, without atomics, and a row's output depends on its own length
//    and maxp * ps alone, whatever rows run beside it. A length-0 row is
//    exactly 0.
//
// Bound: memory. The least traffic is the K and V rows the lengths
// attend, sum_b min(lengths_b, maxp * ps) * D * 2 * KVH elements, plus q
// and out; the partials add B * H * nsplit * (D + 2) floats written and
// read, a few percent of that at decode's lengths.

#include "common.cuh"
#include "mma.cuh"

namespace {

constexpr float kNegInf = -1e30f;  // the JAX package's NEG_INF
constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
// the most keys a block holds: paged_attention.py CHUNK_KEYS
constexpr int kMaxChunk = 64;
static_assert(kMaxChunk <= kThreads, "a thread stages a key's pool row");

// row stride of a staged K or V row, in elements: 16 bytes of pad keep
// rows 16-byte aligned and shift consecutive rows by 4 banks
template <typename T>
__host__ __device__ __forceinline__ int row_ld(int D) {
  return D + 16 / static_cast<int>(sizeof(T));
}

__host__ __device__ __forceinline__ int round16(int bytes) {
  return (bytes + 15) & ~15;
}

// byte offsets of a block's shared-memory regions, each 16-byte aligned
// (the vec path's cp.async and float4 / uint4 reads need it whatever
// chunk, D and dtype): the chunk's pool rows (int64), its K and V rows,
// the G scaled query rows (float32) and the G rows of scores (float32)
struct SplitSmem {
  int k, v, q, s, bytes;
};
template <typename T>
__host__ __device__ __forceinline__ SplitSmem split_smem(int D, int G,
                                                         int chunk) {
  SplitSmem m;
  m.k = round16(static_cast<int>(sizeof(int64_t)) * chunk);
  m.v = m.k + round16(chunk * row_ld<T>(D) * static_cast<int>(sizeof(T)));
  m.q = m.v + round16(chunk * row_ld<T>(D) * static_cast<int>(sizeof(T)));
  m.s = m.q + round16(static_cast<int>(sizeof(float)) * G * D);
  m.bytes = m.s + static_cast<int>(sizeof(float)) * G * chunk;
  return m;
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
    paged_attention_kernel(const T* __restrict__ q,        // [B, H, D]
                           const T* __restrict__ k_pages,  // [KVH, P, ps, D]
                           const T* __restrict__ v_pages,  // [KVH, P, ps, D]
                           const int* __restrict__ lengths,  // [B]
                           const int* __restrict__ tables,   // [B, maxp]
                           float* __restrict__ part_acc,  // [B, H, ns, D]
                           float* __restrict__ part_ml,   // [B, H, ns, 2]
                           int H, int D, int KVH, int P, int ps, int maxp,
                           int chunk, int nsplit, float sm_scale, int vec) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int LD = row_ld<T>(D);
  const int G = H / KVH;
  const SplitSmem lay = split_smem<T>(D, G, chunk);
  int64_t* sRow = reinterpret_cast<int64_t*>(smem);        // [chunk]
  T* sK = reinterpret_cast<T*>(smem + lay.k);              // [chunk, LD]
  T* sV = reinterpret_cast<T*>(smem + lay.v);              // [chunk, LD]
  float* sq = reinterpret_cast<float*>(smem + lay.q);      // [G, D]
  float* sS = reinterpret_cast<float*>(smem + lay.s);      // [G, chunk]

  const int split = blockIdx.x, kvh = blockIdx.y, b = blockIdx.z;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int h0 = kvh * G;
  const int start = split * chunk;
  // the block-table entry of a thread's key is read beside the length,
  // not after it (keys past the length are never staged)
  const int key = start + threadIdx.x;
  int page = threadIdx.x < chunk && key < maxp * ps
                 ? tables[static_cast<int64_t>(b) * maxp + key / ps]
                 : 0;
  int n = lengths[b];
  n = n < maxp * ps ? n : maxp * ps;
  const int nk = min(chunk, n - start);   // keys of this chunk
  const int64_t prow = (static_cast<int64_t>(b) * H + h0) * nsplit + split;
  if (nk <= 0) {   // an empty partial: the merge skips it
    for (int g = threadIdx.x; g < G; g += kThreads) {
      part_ml[(prow + static_cast<int64_t>(g) * nsplit) * 2] = kNegInf;
      part_ml[(prow + static_cast<int64_t>(g) * nsplit) * 2 + 1] = 0.f;
    }
    return;
  }
  // each key's row in the pools (chunk <= kThreads: a thread a key)
  if (threadIdx.x < nk) {
    if (page < 0 || page >= P) page = 0;  // never read outside the pool
    sRow[threadIdx.x] =
        ((static_cast<int64_t>(kvh) * P + page) * ps + key % ps) * D;
  }
  __syncthreads();
  // K, then V, in two cp.async groups: the scores start when K is in
  auto stage = [&](T* dst, const T* src) {
    if (vec) {
      constexpr int CH = 16 / sizeof(T);
      const int per = D / CH;
      for (int it = threadIdx.x; it < nk * per; it += kThreads) {
        const int i = it / per, c = (it - i * per) * CH;
        pt::mma::cp_async16(dst + i * LD + c, src + sRow[i] + c, true);
      }
    } else {
      for (int it = threadIdx.x; it < nk * D; it += kThreads) {
        const int i = it / D, c = it - i * D;
        dst[i * LD + c] = src[sRow[i] + c];
      }
    }
    pt::mma::cp_async_commit();
  };
  stage(sK, k_pages);
  stage(sV, v_pages);
  // the G query rows, scaled in float32 first as the reference does
  for (int i = threadIdx.x; i < G * D; i += kThreads) {
    const int g = i / D, d = i - g * D;
    sq[g * D + d] =
        pt::to_float(q[(static_cast<int64_t>(b) * H + h0 + g) * D + d]) *
        sm_scale;
  }
  pt::mma::cp_async_wait<1>();
  __syncthreads();
  for (int it = threadIdx.x; it < G * nk; it += kThreads) {
    const int g = it / nk, i = it - g * nk;
    sS[g * chunk + i] = pt::dot_row(sK + i * LD, sq + g * D, D, vec);
  }
  pt::mma::cp_async_wait<0>();
  __syncthreads();
  // a warp a head: the chunk's max and sum, p in place of the score
  for (int g = warp; g < G; g += kWarps) {
    float* srow = sS + g * chunk;
    float mx = kNegInf;
    for (int i = lane; i < nk; i += 32) mx = fmaxf(mx, srow[i]);
#pragma unroll
    for (int o = 16; o > 0; o >>= 1)
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
    float l = 0.f;
    for (int i = lane; i < nk; i += 32) {
      const float p = expf(srow[i] - mx);
      srow[i] = p;
      l += p;
    }
    l = pt::warp_sum(l);
    if (lane == 0) {
      part_ml[(prow + static_cast<int64_t>(g) * nsplit) * 2] = mx;
      part_ml[(prow + static_cast<int64_t>(g) * nsplit) * 2 + 1] = l;
    }
  }
  __syncthreads();
  // P V: a thread a (head, column), keys in order
  for (int it = threadIdx.x; it < G * D; it += kThreads) {
    const int g = it / D, d = it - g * D;
    const float* p = sS + g * chunk;
    float a0 = 0.f, a1 = 0.f, a2 = 0.f, a3 = 0.f;   // keys i % 4
    int i = 0;
    for (; i + 4 <= nk; i += 4) {
      a0 = fmaf(p[i], pt::to_float(sV[i * LD + d]), a0);
      a1 = fmaf(p[i + 1], pt::to_float(sV[(i + 1) * LD + d]), a1);
      a2 = fmaf(p[i + 2], pt::to_float(sV[(i + 2) * LD + d]), a2);
      a3 = fmaf(p[i + 3], pt::to_float(sV[(i + 3) * LD + d]), a3);
    }
    for (; i < nk; ++i) a0 = fmaf(p[i], pt::to_float(sV[i * LD + d]), a0);
    part_acc[(prow + static_cast<int64_t>(g) * nsplit) * D + d] =
        (a0 + a1) + (a2 + a3);
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
    paged_attention_merge_kernel(const float* __restrict__ part_acc,
                                 const float* __restrict__ part_ml,
                                 const int* __restrict__ lengths,
                                 T* __restrict__ out, int H, int D,
                                 int chunk, int nsplit, int max_keys) {
  const int h = blockIdx.x, b = blockIdx.y;
  int n = lengths[b];
  n = n < max_keys ? n : max_keys;
  const int used = n > 0 ? min(nsplit, (n + chunk - 1) / chunk) : 0;
  const int64_t row = static_cast<int64_t>(b) * H + h;
  const float* ml = part_ml + row * nsplit * 2;
  const float* acc = part_acc + row * nsplit * D;
  float mm = kNegInf;
  for (int j = 0; j < used; ++j)
    if (ml[2 * j + 1] > 0.f) mm = fmaxf(mm, ml[2 * j]);
  float ll = 0.f;
  for (int j = 0; j < used; ++j)
    if (ml[2 * j + 1] > 0.f) ll += ml[2 * j + 1] * expf(ml[2 * j] - mm);
  const bool ok = used > 0 && ll > 0.f;
  const float inv = ok ? 1.f / ll : 0.f;
  for (int d = threadIdx.x; d < D; d += kThreads) {
    float o = 0.f;
    for (int j = 0; j < used; ++j)
      if (ml[2 * j + 1] > 0.f)
        o += acc[static_cast<int64_t>(j) * D + d] * expf(ml[2 * j] - mm);
    out[row * D + d] = pt::from_float<T>(ok ? o * inv : 0.f);
  }
}

template <typename T>
int launch(const void* q, const void* kp, const void* vp, const int* lengths,
           const int* tables, void* out, float* part_acc, float* part_ml,
           int B, int H, int D, int KVH, int P, int ps, int maxp, int chunk,
           int nsplit, float sm_scale, cudaStream_t s) {
  // more heads a kv head than a block's shared memory holds at this D:
  // the attribute is refused and the error returned
  const int smem = split_smem<T>(D, H / KVH, chunk).bytes;
  auto kern = paged_attention_kernel<T>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int vec =
      (D * sizeof(T)) % 16 == 0 &&
      reinterpret_cast<uintptr_t>(kp) % 16 == 0 &&
      reinterpret_cast<uintptr_t>(vp) % 16 == 0;
  kern<<<dim3(nsplit, KVH, B), kThreads, smem, s>>>(
      static_cast<const T*>(q), static_cast<const T*>(kp),
      static_cast<const T*>(vp), lengths, tables, part_acc, part_ml, H, D,
      KVH, P, ps, maxp, chunk, nsplit, sm_scale, vec);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  paged_attention_merge_kernel<T><<<dim3(H, B), kThreads, 0, s>>>(
      part_acc, part_ml, lengths, static_cast<T*>(out), H, D, chunk, nsplit,
      maxp * ps);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// q, out: [B, H, D]; k_pages, v_pages: [KVH, P, ps, D]; all of one dtype
// (float32 or bfloat16), contiguous. lengths: [B] int32, the keys each
// row attends (the row just written included); page_indices: [B, maxp]
// int32. chunk, nsplit: split_geometry(maxp, ps) of paged_attention.py;
// part_acc: float32 [B, H, nsplit, D] and part_ml [B, H, nsplit, 2], the
// partials' workspace. Limits: D <= 256, H % KVH == 0 (checked again by
// the Python wrapper), 0 < chunk <= kMaxChunk, nsplit * chunk >= maxp * ps,
// and a block's shared memory (split_smem) within the card's.
extern "C" int pt_paged_attention(const void* q, const void* k_pages,
                                  const void* v_pages, const void* lengths,
                                  const void* page_indices, void* out,
                                  void* part_acc, void* part_ml, int B,
                                  int H, int D, int KVH, int P, int ps,
                                  int maxp, int chunk, int nsplit,
                                  float sm_scale, int dtype, void* stream) {
  if (B <= 0 || H <= 0) return 0;
  if (D <= 0 || D > 256 || KVH <= 0 || H % KVH != 0 || ps <= 0 || maxp <= 0 ||
      P <= 0 || chunk <= 0 || chunk > kMaxChunk ||
      static_cast<int64_t>(nsplit) * chunk < static_cast<int64_t>(maxp) * ps)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int* len = static_cast<const int*>(lengths);
  const int* tab = static_cast<const int*>(page_indices);
  float* pa = static_cast<float*>(part_acc);
  float* pm = static_cast<float*>(part_ml);
  switch (dtype) {
    case pt::kFloat32:
      return launch<float>(q, k_pages, v_pages, len, tab, out, pa, pm, B, H,
                           D, KVH, P, ps, maxp, chunk, nsplit, sm_scale, s);
    case pt::kBFloat16:
      return launch<__nv_bfloat16>(q, k_pages, v_pages, len, tab, out, pa,
                                   pm, B, H, D, KVH, P, ps, maxp, chunk,
                                   nsplit, sm_scale, s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
