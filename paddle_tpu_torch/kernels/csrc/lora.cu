// Batched LoRA (K12) for Hopper (sm_90a).
//
// Replaces the Pallas kernel of paddle_tpu/kernels/lora.py
// (_lora_delta_pallas :168, body _make_lora_kernel :129; numerics
// oracle _reference_lora_delta :119). In place, for every bucket j in
// order and every activation row m whose slot s = slots[m / rep][j] is
// not 0 (the zero adapter):
//
//   out[m, :] += ((x[m, :] @ A_j[s]) @ B_j[s]) * scale_j[s]
//
// x [M, K], out [M, N] float32; A_j [S_j, K, r_j], B_j [S_j, r_j, N],
// scale_j [S_j] float32; slots [R, slot_cols] int32, M = R * rep (a
// ragged-step lane's rep = chunk rows share its slots). Slot-0 rows are
// never touched, so they stay bitwise the base product.
//
// Design. The TPU kernel loops every slot on its grid and masks rows,
// S-fold work; here only rows with a nonzero slot do anything, in two
// kernels a call:
//   shrink: a block per (slot row, 256-row slice of K, bucket) stages
//   its rows of x and its slice of A[s] in shared memory (coalesced
//   loads) and writes the slice's partial u = x @ A[s] to a scratch
//   buffer: the thread that owns a (row, rank) pair adds the 256
//   products in k order.
//   expand: a block per (slot row, 1024 output columns) sums the
//   partials in slice order into u (shared memory), then each thread
//   adds sum_i u[row][i] * B[s][i][col] in rank order for its 4
//   columns, and out += d * scale.
// The slices are fixed by K alone, so a row's result depends on its own
// x and slot alone, never on M or on which other slots are present.
// Any rank >= 1 works (ranks go 16 at a time). Every bucket of a row is
// added in bucket order by the same expand block, so one call covers
// all buckets of a target.
//
// Bound: memory (the factors of each slot present, read once, plus the
// adapter rows of x and out). Splitting K over blocks keeps each
// block's serial walk short; the partials are M x ceil(K / 256) x r
// floats, a few hundred KB at the serving shape.

#include <stdint.h>

#include "common.cuh"

namespace {

constexpr int kMaxBuckets = 4;
constexpr int kThreads = 256, kCols = 4, kBN = kThreads * kCols;
constexpr int kRows = 16;      // activation rows a pass
constexpr int kRanks = 16;     // ranks a pass: kRows * kRanks == kThreads
constexpr int kKS = 256;       // rows of K a shrink block takes

struct Buckets {
  const float* a[kMaxBuckets];
  const float* b[kMaxBuckets];
  const float* sc[kMaxBuckets];
  float* part[kMaxBuckets];    // [nsplit, M, r] partials of u
  int r[kMaxBuckets];
  int S[kMaxBuckets];
};

__device__ __forceinline__ int slot_of(const int* slots, const Buckets& bk,
                                       int row, int j, int slot_cols) {
  const int s = slots[int64_t(row) * slot_cols + j];
  return (s <= 0 || s >= bk.S[j]) ? 0 : s;  // 0: the zero adapter
}

__global__ void __launch_bounds__(kThreads)
    lora_shrink_kernel(const float* __restrict__ x,     // [M, K]
                       const int* __restrict__ slots,   // [R, slot_cols]
                       Buckets bk, int slot_cols, int M, int K, int rep) {
  __shared__ float xs[kRows][kKS + 1];
  __shared__ float as[kKS][kRanks];
  const int row = blockIdx.x, split = blockIdx.y, j = blockIdx.z;
  const int s = slot_of(slots, bk, row, j, slot_cols);
  if (s == 0) return;
  const int r = bk.r[j];
  const int k0 = split * kKS;
  const int kc = min(kKS, K - k0);
  const float* A = bk.a[j] + int64_t(s) * K * r;
  float* part = bk.part[j] + int64_t(split) * M * r;
  const int tid = threadIdx.x;
  const int mi = tid / kRanks, ii = tid % kRanks;
  for (int m0 = row * rep; m0 < (row + 1) * rep; m0 += kRows) {
    const int rows = min(kRows, (row + 1) * rep - m0);
    __syncthreads();  // the previous pass's x is consumed
    for (int e = tid; e < kRows * kKS; e += kThreads) {
      const int rr = e / kKS, kk = e % kKS;
      xs[rr][kk] = (rr < rows && kk < kc)
                       ? x[int64_t(m0 + rr) * K + k0 + kk] : 0.f;
    }
    for (int i0 = 0; i0 < r; i0 += kRanks) {
      const int ri = min(kRanks, r - i0);
      __syncthreads();  // xs is written; the previous A slice consumed
      for (int e = tid; e < kc * ri; e += kThreads) {
        const int kk = e / ri, q = e % ri;
        as[kk][q] = A[int64_t(k0 + kk) * r + i0 + q];
      }
      __syncthreads();
      if (mi < rows && ii < ri) {
        float v = 0.f;
        for (int kk = 0; kk < kc; ++kk) v = fmaf(xs[mi][kk], as[kk][ii], v);
        part[int64_t(m0 + mi) * r + i0 + ii] = v;
      }
    }
  }
}

__global__ void __launch_bounds__(kThreads)
    lora_expand_kernel(float* __restrict__ out,         // [M, N]
                       const int* __restrict__ slots,   // [R, slot_cols]
                       Buckets bk, int nb, int slot_cols, int M, int N,
                       int rep, int nsplit) {
  __shared__ float u[kRows][kRanks + 1];
  const int row = blockIdx.x;
  const int n0 = blockIdx.y * kBN;
  const int tid = threadIdx.x;
  const int mi = tid / kRanks, ii = tid % kRanks;

  for (int j = 0; j < nb; ++j) {
    const int s = slot_of(slots, bk, row, j, slot_cols);
    if (s == 0) continue;
    const int r = bk.r[j];
    const float* B = bk.b[j] + int64_t(s) * r * N;
    const float* part = bk.part[j];
    const float sc = bk.sc[j][s];
    for (int m0 = row * rep; m0 < (row + 1) * rep; m0 += kRows) {
      const int rows = min(kRows, (row + 1) * rep - m0);
      float d[kRows][kCols];
#pragma unroll
      for (int a = 0; a < kRows; ++a)
#pragma unroll
        for (int c = 0; c < kCols; ++c) d[a][c] = 0.f;
      for (int i0 = 0; i0 < r; i0 += kRanks) {
        const int ri = min(kRanks, r - i0);
        __syncthreads();  // u of the previous rank chunk is consumed
        float v = 0.f;
        if (mi < rows && ii < ri) {
          for (int sp = 0; sp < nsplit; ++sp)   // slice order: fixed
            v += part[(int64_t(sp) * M + m0 + mi) * r + i0 + ii];
        }
        u[mi][ii] = v;
        __syncthreads();
#pragma unroll
        for (int c = 0; c < kCols; ++c) {
          const int n = n0 + tid + c * kThreads;
          if (n >= N) continue;
          for (int q = 0; q < ri; ++q) {
            const float bv = B[int64_t(i0 + q) * N + n];
#pragma unroll
            for (int a = 0; a < kRows; ++a)
              d[a][c] = fmaf(u[a][q], bv, d[a][c]);
          }
        }
      }
#pragma unroll
      for (int c = 0; c < kCols; ++c) {
        const int n = n0 + tid + c * kThreads;
        if (n >= N) continue;
#pragma unroll
        for (int a = 0; a < kRows; ++a) {
          if (a >= rows) continue;
          float* o = out + int64_t(m0 + a) * N + n;
          // the plain version's (d * scale), then out + delta: two
          // roundings, never contracted into one FMA
          *o = __fadd_rn(*o, __fmul_rn(d[a][c], sc));
        }
      }
    }
  }
}

}  // namespace

// Rows of K a shrink block takes: the wrapper sizes the partials buffer
// as ceil(K / this) x M x r floats per bucket.
extern "C" int pt_batched_lora_split_rows() { return kKS; }

// x [M, K], out [M, N] float32; slots [R, slot_cols] int32, M = R * rep;
// per bucket j < nb <= 4: a_ptrs[j] -> A [nslots[j], K, ranks[j]],
// b_ptrs[j] -> B [nslots[j], ranks[j], N], sc_ptrs[j] -> scale
// [nslots[j]], part_ptrs[j] -> scratch [ceil(K / kKS), M, ranks[j]], all
// float32 and contiguous.
extern "C" int pt_batched_lora_add(const void* x, void* out,
                                   const void* slots,
                                   const void* const* a_ptrs,
                                   const void* const* b_ptrs,
                                   const void* const* sc_ptrs,
                                   void* const* part_ptrs,
                                   const int* ranks, const int* nslots,
                                   int nb, int slot_cols, int M, int K,
                                   int N, int rep, void* stream) {
  if (M <= 0 || N <= 0 || nb <= 0) return 0;
  if (K <= 0 || rep <= 0 || M % rep != 0 || nb > kMaxBuckets ||
      slot_cols < nb)
    return static_cast<int>(cudaErrorInvalidValue);
  Buckets bk = {};
  for (int j = 0; j < nb; ++j) {
    if (ranks[j] <= 0 || nslots[j] <= 0)
      return static_cast<int>(cudaErrorInvalidValue);
    bk.a[j] = static_cast<const float*>(a_ptrs[j]);
    bk.b[j] = static_cast<const float*>(b_ptrs[j]);
    bk.sc[j] = static_cast<const float*>(sc_ptrs[j]);
    bk.part[j] = static_cast<float*>(part_ptrs[j]);
    bk.r[j] = ranks[j];
    bk.S[j] = nslots[j];
  }
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int nsplit = (K + kKS - 1) / kKS;
  const int* sl = static_cast<const int*>(slots);
  lora_shrink_kernel<<<dim3(M / rep, nsplit, nb), kThreads, 0, st>>>(
      static_cast<const float*>(x), sl, bk, slot_cols, M, K, rep);
  const int rc = static_cast<int>(cudaGetLastError());
  if (rc != 0) return rc;
  lora_expand_kernel<<<dim3(M / rep, (N + kBN - 1) / kBN), kThreads, 0,
                       st>>>(static_cast<float*>(out), sl, bk, nb, slot_cols,
                             M, N, rep, nsplit);
  return static_cast<int>(cudaGetLastError());
}
