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
// Bound: memory (the factors of each slot present, the adapter rows of
// x, out read and written), a few MB at the serving step; the work is
// tens of MFLOP, so float32 on the FMA units. What sets the time is
// latency: a lane's shrink must finish before its expand can start. The
// design keeps many 16-byte loads in flight in both kernels and
// overlaps the two:
//
//   shrink (lora_shrink_kernel<KS>): a block per (lane pass of 16 rows,
//   slice of K); the slices of a lane pass, at most 16, are one
//   thread-block cluster, and a block takes every live bucket in turn.
//   It stages its x rows and A[s] rows in shared memory KS rows at a
//   time with 16-byte loads, all issued at once (x before the slots are
//   read, the next stage's during this one's compute; a slice of one
//   stage stages x once for every bucket). Thread (row m,
//   k-lane c) adds x[m][k] * A[k][q] over k = c + 16 t of the slice (t
//   in order) into 16 independent rank accumulators, the 16 k-lanes of
//   a row meet in a butterfly (xor 8, 4, 2, 1), and lane c keeps rank c
//   of the slice's partial in shared memory. After a cluster barrier
//   the cluster's first block reads every slice's partial from
//   distributed shared memory and sums them in slice order into u [M,
//   r] (global).
//   expand (lora_expand_kernel): a block per (lane pass, chunk of 128
//   columns), launched with programmatic dependent launch: its blocks
//   start while the shrink runs, stage their out rows and B[s] rows in
//   shared memory with 16-byte cp.async, then wait for the shrink grid
//   (griddepcontrol.wait) and read u. A thread owns one
//   16-byte column vector of 4 rows: d = sum_q u[m][q] * B[q][n] in rank
//   order, then out = out + (d * scale), two roundings as the plain
//   version, bucket after bucket.
// The slicing of K (and so every sum's order) is a function of K alone,
// given by lora_geometry in kernels/lora.py: a row's result depends on
// its own x row, its slot's factors and the geometry, never on M, its
// lane, the other rows' slots, the pool's slot count or the slot index.
// No atomics; the one cross-block sum (the partials) is read in slice
// order by one block of the cluster. Unaligned inputs or widths
// that are not whole vectors take element loads into the same
// registers: same bits.

#include <cooperative_groups.h>
#include <stdint.h>

#include "common.cuh"
#include "mma.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kMaxBuckets = 4;
constexpr int kRows = 16;         // activation rows a lane pass
constexpr int kKLanes = 16;       // shrink: threads across K a row
constexpr int kShrinkThreads = kRows * kKLanes;
constexpr int kRankChunk = 16;    // ranks a pass of both kernels
constexpr int kAStride = 20;      // floats a staged A row: conflict-free
                                  // float4 reads by 8 consecutive rows
constexpr int kExpandVectors = 32;                // a warp's 16-byte vectors
constexpr int kExpandThreads = 4 * kExpandVectors;  // warp w: rows 4w..4w+3
constexpr int kChunk = 4 * kExpandVectors;        // columns a chunk
constexpr int kMaxSplits = 16;    // slices of K a cluster (its blocks)

struct Buckets {
  const float* a[kMaxBuckets];
  const float* b[kMaxBuckets];
  const float* sc[kMaxBuckets];
  int64_t u[kMaxBuckets];         // float offset of bucket j's u [M, r]
  int r[kMaxBuckets];
  int S[kMaxBuckets];
};

__device__ __forceinline__ int slot_of(const int* slots, const Buckets& bk,
                                       int row, int j, int slot_cols) {
  const int s = slots[int64_t(row) * slot_cols + j];
  return (s <= 0 || s >= bk.S[j]) ? 0 : s;  // 0: the zero adapter
}

__device__ __forceinline__ float4 zero4() {
  return make_float4(0.f, 0.f, 0.f, 0.f);
}

// float4 at p (16-byte aligned) when vec, else the elements below lim
// (the rest 0): the same values either way.
__device__ __forceinline__ float4 load4(const float* p, int lim, int vec) {
  if (vec) return *reinterpret_cast<const float4*>(p);
  float4 v = zero4();
  if (lim > 0) v.x = p[0];
  if (lim > 1) v.y = p[1];
  if (lim > 2) v.z = p[2];
  if (lim > 3) v.w = p[3];
  return v;
}

__device__ __forceinline__ void store4(float* p, float4 v, int lim, int vec) {
  if (vec) {
    *reinterpret_cast<float4*>(p) = v;
    return;
  }
  if (lim > 0) p[0] = v.x;
  if (lim > 1) p[1] = v.y;
  if (lim > 2) p[2] = v.z;
  if (lim > 3) p[3] = v.w;
}

__device__ __forceinline__ float& lane_of(float4& v, int e) {
  return e == 0 ? v.x : e == 1 ? v.y : e == 2 ? v.z : v.w;
}

// x_vec: K % 4 == 0 and x 16-byte aligned; a_vec: every bucket's A
// 16-byte aligned (a bucket with r % 4 == 0 and r <= 16 then stages its
// rows as whole vectors). A block's slice of K is `stages` stages of KS
// rows; the cluster is the lane pass's splits slice blocks, every live
// bucket in turn. Dynamic shared memory: the slice's partials [sum of
// r][kRows] (bucket j's rank q at row roff_j + q, roff_j the ranks of
// the buckets before j).
template <int KS>
__global__ void __launch_bounds__(kShrinkThreads)
    lora_shrink_kernel(const float* __restrict__ x,      // [M, K]
                       const int* __restrict__ slots,    // [R, slot_cols]
                       float* __restrict__ scratch, Buckets bk, int nb,
                       int slot_cols, int K, int rep, int passes,
                       int stages, int splits, int x_vec, int a_vec) {
  // the expand grid may launch once every shrink block runs: it waits
  // for this grid to finish before it reads u
  asm volatile("griddepcontrol.launch_dependents;");
  constexpr int XS = KS + 16;   // floats a staged x row: the warp's two
                                // rows on other banks
  constexpr int XV = KS / 4;    // vectors a staged x row
  constexpr int XLOADS = kRows * XV / kShrinkThreads;
  constexpr int ALOADS = KS * kRankChunk / 4 / kShrinkThreads;
  __shared__ __align__(16) float xs[kRows * XS];
  __shared__ __align__(16) float as[KS * kAStride];
  extern __shared__ __align__(16) float part_s[];

  const int lane_row = blockIdx.x / passes;
  const int pass = blockIdx.x - lane_row * passes;
  const int split = blockIdx.y;   // the block's rank in the cluster
  const int m0 = lane_row * rep + pass * kRows;
  const int rows = min(kRows, rep - pass * kRows);
  const int k0 = split * stages * KS;
  const int tid = threadIdx.x;

  // one (rank chunk, stage) item's x rows m0 .. m0 + rows and A rows
  // kb .. kb + KS (zeros past K, rows and rc): the vector paths load
  // into registers ahead of staging, the element paths as they stage
  float4 xv[XLOADS], av[ALOADS];
  auto load_x = [&](int kb) {
    if (!x_vec) return;
#pragma unroll
    for (int i = 0; i < XLOADS; ++i) {
      const int f = tid + i * kShrinkThreads;
      const int m = f / XV, k = kb + 4 * (f % XV);
      xv[i] = (m < rows && k < K)
                  ? *reinterpret_cast<const float4*>(x + int64_t(m0 + m) * K +
                                                     k)
                  : zero4();
    }
  };
  auto stage_x = [&](int kb) {
    if (x_vec) {
#pragma unroll
      for (int i = 0; i < XLOADS; ++i) {
        const int f = tid + i * kShrinkThreads;
        *reinterpret_cast<float4*>(xs + (f / XV) * XS + 4 * (f % XV)) = xv[i];
      }
      return;
    }
    for (int f = tid; f < kRows * KS; f += kShrinkThreads) {
      const int m = f / KS, kk = f % KS;
      xs[m * XS + kk] = (m < rows && kb + kk < K)
                            ? x[int64_t(m0 + m) * K + kb + kk] : 0.f;
    }
  };
  // A rows of a stage (r <= 16 whole vectors: KS * r contiguous floats)
  auto load_a = [&](const float* A, int r, bool a_rows, int kb) {
    if (!a_rows) return;
    const int nv = KS * r / 4;
#pragma unroll
    for (int i = 0; i < ALOADS; ++i) {
      const int f = tid + i * kShrinkThreads;
      av[i] = (f < nv && kb + (4 * f) / r < K)
                  ? *reinterpret_cast<const float4*>(A + int64_t(kb) * r +
                                                     4 * f)
                  : zero4();
    }
  };
  // the first stage's x, issued before the slots are known: it does not
  // depend on them
  load_x(k0);
  int sj[kMaxBuckets];
  int first = -1;
#pragma unroll
  for (int j = 0; j < kMaxBuckets; ++j) {
    sj[j] = j < nb ? slot_of(slots, bk, lane_row, j, slot_cols) : 0;
    if (sj[j] != 0 && first < 0) first = j;
  }
  if (first < 0) return;   // the whole cluster: every bucket on slot 0
  cg::cluster_group cluster = cg::this_cluster();

  const int m = tid / kKLanes, c = tid % kKLanes;
  // xv holds the x of the next stage to stage (loaded ahead); with one
  // stage a slice, xs keeps it for every item of every bucket
  bool x_ready = true, x_kept = false;
  int roff = 0;
#pragma unroll
  for (int j = 0; j < kMaxBuckets; ++j) {
    if (j >= nb) break;
    const int r = bk.r[j];
    if (sj[j] == 0) {
      roff += r;
      continue;
    }
    const float* A = bk.a[j] + int64_t(sj[j]) * K * r;
    const bool a_rows = a_vec && r <= kRankChunk && (r & 3) == 0;
    auto stage_a = [&](int kb, int q0, int rc) {
      if (a_rows) {
        const int nv = KS * r / 4;
#pragma unroll
        for (int i = 0; i < ALOADS; ++i) {
          const int f = tid + i * kShrinkThreads;
          if (f < nv) {
            const int kk = (4 * f) / r, q = 4 * f - kk * r;
            *reinterpret_cast<float4*>(as + kk * kAStride + q) = av[i];
          }
        }
        return;
      }
      // rc need not be whole vectors: ranks rc .. 15 staged as 0
      for (int f = tid; f < KS * kRankChunk; f += kShrinkThreads) {
        const int kk = f / kRankChunk, q = f % kRankChunk;
        as[kk * kAStride + q] = (q < rc && kb + kk < K)
                                    ? A[int64_t(kb + kk) * r + q0 + q] : 0.f;
      }
    };
    load_a(A, r, a_rows, k0);
    const int items = (r + kRankChunk - 1) / kRankChunk * stages;
    float acc[kRankChunk];
    for (int it = 0; it < items; ++it) {
      const int q0 = it / stages * kRankChunk, st = it % stages;
      const int kb = k0 + st * KS, rc = min(kRankChunk, r - q0);
      if (st == 0) {
#pragma unroll
        for (int q = 0; q < kRankChunk; ++q) acc[q] = 0.f;
      }
      __syncthreads();   // the last item's stage is consumed
      if (!x_kept) {
        if (!x_ready) load_x(kb);
        stage_x(kb);
        x_ready = false;
        x_kept = stages == 1;
      }
      stage_a(kb, q0, rc);
      __syncthreads();
      if (it + 1 < items) {   // the next item's loads fly during this one
        const int kn = k0 + (it + 1) % stages * KS;
        if (stages > 1) {
          load_x(kn);
          x_ready = true;
        }
        load_a(A, r, a_rows, kn);
      }
#pragma unroll
      for (int t = 0; t < KS / kKLanes; ++t) {
        const int kk = c + kKLanes * t;
        const float xk = xs[m * XS + kk];
        const float4* ar =
            reinterpret_cast<const float4*>(as + kk * kAStride);
#pragma unroll
        for (int q4 = 0; q4 < kRankChunk / 4; ++q4) {
          if (4 * q4 < rc) {
            const float4 a = ar[q4];
            acc[4 * q4 + 0] = fmaf(xk, a.x, acc[4 * q4 + 0]);
            acc[4 * q4 + 1] = fmaf(xk, a.y, acc[4 * q4 + 1]);
            acc[4 * q4 + 2] = fmaf(xk, a.z, acc[4 * q4 + 2]);
            acc[4 * q4 + 3] = fmaf(xk, a.w, acc[4 * q4 + 3]);
          }
        }
      }
      if (st < stages - 1) continue;
      // the row's 16 k-lanes meet: lane c adds lane c ^ o, o = 8, 4, 2, 1
#pragma unroll
      for (int o = kKLanes / 2; o > 0; o >>= 1) {
#pragma unroll
        for (int q = 0; q < kRankChunk; ++q)
          acc[q] += __shfl_xor_sync(0xffffffffu, acc[q], o);
      }
      float mine = 0.f;
#pragma unroll
      for (int q = 0; q < kRankChunk; ++q)
        if (q == c) mine = acc[q];
      if (c < rc) part_s[(roff + q0 + c) * kRows + m] = mine;
    }
    roff += r;
  }

  cluster.sync();   // every slice's partials are in its block
  if (split == 0) {   // u = the slices' partials in slice order
    roff = 0;
#pragma unroll
    for (int j = 0; j < kMaxBuckets; ++j) {
      if (j >= nb) break;
      const int r = bk.r[j];
      if (sj[j] != 0) {
        for (int e = tid; e < kRows * r; e += kShrinkThreads) {
          const int q = e / kRows, mm = e % kRows;
          float t[kMaxSplits];
#pragma unroll
          for (int sp = 0; sp < kMaxSplits; ++sp)
            t[sp] = sp < splits
                        ? cluster.map_shared_rank(part_s, sp)[roff * kRows + e]
                        : 0.f;
          float u = 0.f;
#pragma unroll
          for (int sp = 0; sp < kMaxSplits; ++sp)
            if (sp < splits) u += t[sp];
          if (mm < rows) scratch[bk.u[j] + int64_t(m0 + mm) * r + q] = u;
        }
      }
      roff += r;
    }
  }
  cluster.sync();   // read before any block of the cluster exits
}

// vec: N % 4 == 0 and out and every bucket's B 16-byte aligned. Shared
// memory: u [sum of r][kRows] (bucket j's rank q at row roff_j + q,
// roff_j the ranks of the buckets before j), then the block's out tile
// [kRows][kChunk] and one rank chunk of B [kRankChunk][kChunk], staged
// with 16-byte cp.async (element copies when !vec), so a thread holds
// few registers and many blocks stay resident.
__global__ void __launch_bounds__(kExpandThreads)
    lora_expand_kernel(float* __restrict__ out,          // [M, N]
                       const int* __restrict__ slots,    // [R, slot_cols]
                       const float* __restrict__ scratch, Buckets bk, int nb,
                       int slot_cols, int N, int rep, int passes, int vec) {
  extern __shared__ __align__(16) float dyn[];
  const int lane_row = blockIdx.x / passes;
  const int pass = blockIdx.x - lane_row * passes;
  const int m0 = lane_row * rep + pass * kRows;
  const int rows = min(kRows, rep - pass * kRows);
  int sj[kMaxBuckets];
  int first = -1, rsum = 0;
#pragma unroll
  for (int j = 0; j < kMaxBuckets; ++j) {
    sj[j] = j < nb ? slot_of(slots, bk, lane_row, j, slot_cols) : 0;
    if (sj[j] != 0 && first < 0) first = j;
    if (j < nb) rsum += bk.r[j];
  }
  if (first < 0) return;   // every bucket on slot 0: nothing to add

  float* u_s = dyn;
  float* os = u_s + rsum * kRows;
  float* bs = os + kRows * kChunk;
  const int tid = threadIdx.x;
  const int v = tid % kExpandVectors, w = tid / kExpandVectors;
  const int n0 = blockIdx.y * kChunk, n = n0 + 4 * v;
  // B rows q0 .. q0 + rc of the block's columns, shared by its 4 warps
  auto stage_b = [&](const float* B, int rc) {
    for (int e = tid; e < rc * kExpandVectors; e += kExpandThreads) {
      const int q = e / kExpandVectors, c4 = 4 * (e % kExpandVectors);
      const int col = n0 + c4;
      float* dst = bs + q * kChunk + c4;
      const float* src = B + int64_t(q) * N + col;
      if (vec)
        pt::mma::cp_async16(dst, col < N ? src : B, col < N);
      else
        *reinterpret_cast<float4*>(dst) =
            col < N ? load4(src, N - col, 0) : zero4();
    }
  };

  // out's rows (each thread its own vectors) and the first live bucket's
  // B, issued before the wait: they do not depend on the shrink
#pragma unroll
  for (int a = 0; a < 4; ++a) {
    const int row = 4 * w + a;
    const bool ok = row < rows && n < N;
    float* dst = os + row * kChunk + 4 * v;
    const float* src = out + int64_t(m0 + row) * N + n;
    if (vec)
      pt::mma::cp_async16(dst, ok ? src : out, ok);
    else
      *reinterpret_cast<float4*>(dst) = ok ? load4(src, N - n, 0) : zero4();
  }
  stage_b(bk.b[first] + int64_t(sj[first]) * bk.r[first] * N,
          min(kRankChunk, bk.r[first]));
  pt::mma::cp_async_commit();
  asm volatile("griddepcontrol.wait;" ::: "memory");

  int roff = 0;
#pragma unroll
  for (int j = 0; j < kMaxBuckets; ++j) {
    if (j >= nb) break;
    const int r = bk.r[j];
    if (sj[j] != 0) {
      const float* u = scratch + bk.u[j] + int64_t(m0) * r;
      for (int e = tid; e < kRows * r; e += kExpandThreads) {
        const int m = e / r, q = e - m * r;
        u_s[(roff + q) * kRows + m] = m < rows ? __ldcg(u + e) : 0.f;
      }
    }
    roff += r;
  }
  pt::mma::cp_async_wait<0>();
  __syncthreads();

  float4 o[4];
#pragma unroll
  for (int a = 0; a < 4; ++a)
    o[a] = *reinterpret_cast<const float4*>(os + (4 * w + a) * kChunk +
                                            4 * v);
  bool staged = true;   // bs holds the first live bucket's first ranks
  roff = 0;
#pragma unroll
  for (int j = 0; j < kMaxBuckets; ++j) {
    if (j >= nb) break;
    const int r = bk.r[j];
    if (sj[j] == 0) {
      roff += r;
      continue;
    }
    const float* B = bk.b[j] + int64_t(sj[j]) * r * N;
    const float sc = bk.sc[j][sj[j]];
    float4 d[4];
#pragma unroll
    for (int a = 0; a < 4; ++a) d[a] = zero4();
    for (int q0 = 0; q0 < r; q0 += kRankChunk) {
      const int rc = min(kRankChunk, r - q0);
      if (!staged) {
        __syncthreads();   // the last chunk of B is consumed
        stage_b(B + int64_t(q0) * N, rc);
        pt::mma::cp_async_commit();
        pt::mma::cp_async_wait<0>();
        __syncthreads();
      }
      staged = false;
#pragma unroll
      for (int q = 0; q < kRankChunk; ++q) {
        if (q < rc) {
          const float4 u = *reinterpret_cast<const float4*>(
              u_s + (roff + q0 + q) * kRows + 4 * w);
          const float4 b =
              *reinterpret_cast<const float4*>(bs + q * kChunk + 4 * v);
#pragma unroll
          for (int a = 0; a < 4; ++a) {
            const float ua = a == 0 ? u.x : a == 1 ? u.y : a == 2 ? u.z : u.w;
            d[a].x = fmaf(ua, b.x, d[a].x);
            d[a].y = fmaf(ua, b.y, d[a].y);
            d[a].z = fmaf(ua, b.z, d[a].z);
            d[a].w = fmaf(ua, b.w, d[a].w);
          }
        }
      }
    }
    // the plain version's (d * scale), then out + delta: two roundings,
    // never contracted into one FMA
#pragma unroll
    for (int a = 0; a < 4; ++a)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        lane_of(o[a], e) = __fadd_rn(lane_of(o[a], e),
                                     __fmul_rn(lane_of(d[a], e), sc));
    roff += r;
  }
  if (n < N) {
#pragma unroll
    for (int a = 0; a < 4; ++a)
      if (4 * w + a < rows)
        store4(out + int64_t(m0 + 4 * w + a) * N + n, o[a], N - n, vec);
  }
}

bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

// The shrink as clusters of `splits` blocks along y (one (lane pass,
// bucket) each); past 8 blocks a cluster is the H100's non-portable
// size, allowed once a kernel.
template <int KS>
cudaError_t launch_shrink(dim3 grid, size_t smem, cudaStream_t st,
                          const float* x, const int* sl, float* scratch,
                          const Buckets& bk, int nb, int slot_cols, int K,
                          int rep, int passes, int stages, int splits,
                          int x_vec, int a_vec) {
  static bool wide = false;
  static size_t smem_set = 48 << 10;   // the default limit
  if (splits > 8 && !wide) {
    const cudaError_t err = cudaFuncSetAttribute(
        lora_shrink_kernel<KS>,
        cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    if (err != cudaSuccess) return err;
    wide = true;
  }
  const size_t total = smem + sizeof(float) * (kRows * (KS + 16) +
                                               KS * kAStride);
  if (total > smem_set) {
    const cudaError_t err = cudaFuncSetAttribute(
        lora_shrink_kernel<KS>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return err;
    smem_set = total;
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = grid;
  cfg.blockDim = dim3(kShrinkThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = st;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = 1;
  attr[0].val.clusterDim.y = splits;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cudaLaunchKernelEx(&cfg, lora_shrink_kernel<KS>, x, sl, scratch, bk,
                            nb, slot_cols, K, rep, passes, stages, splits,
                            x_vec, a_vec);
}

}  // namespace

// x [M, K], out [M, N] float32; slots [R, slot_cols] int32, M = R * rep;
// per bucket j < nb <= 4: a_ptrs[j] -> A [nslots[j], K, ranks[j]],
// b_ptrs[j] -> B [nslots[j], ranks[j], N], sc_ptrs[j] -> scale
// [nslots[j]], all float32 and contiguous. scratch: M * sum(ranks)
// floats, every bucket's u [M, ranks[j]] in bucket order. The geometry
// (slice_rows of K a shrink block, in stages of stage_rows; splits =
// ceil(K / slice_rows) <= 16 blocks a cluster; tiles = ceil(N / 128)
// expand blocks a lane pass) is lora_geometry's in kernels/lora.py.
extern "C" int pt_batched_lora_add(const void* x, void* out,
                                   const void* slots, void* scratch,
                                   const void* const* a_ptrs,
                                   const void* const* b_ptrs,
                                   const void* const* sc_ptrs,
                                   const int* ranks, const int* nslots,
                                   int nb, int slot_cols, int M, int K,
                                   int N, int rep, int slice_rows,
                                   int stage_rows, int splits, int tiles,
                                   void* stream) {
  if (M <= 0 || N <= 0 || nb <= 0) return 0;
  if ((stage_rows != 128 && stage_rows != 256) ||
      slice_rows <= 0 || slice_rows % stage_rows != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  if (K <= 0 || rep <= 0 || M % rep != 0 || nb > kMaxBuckets ||
      slot_cols < nb || splits != (K + slice_rows - 1) / slice_rows ||
      splits > kMaxSplits || int64_t(tiles) * kChunk < N)
    return static_cast<int>(cudaErrorInvalidValue);
  int rsum = 0;
  for (int j = 0; j < nb; ++j) {
    if (ranks[j] <= 0 || nslots[j] <= 0)
      return static_cast<int>(cudaErrorInvalidValue);
    rsum += ranks[j];
  }
  Buckets bk = {};
  int64_t uoff = 0;
  int a_vec = 1, b_vec = 1;
  for (int j = 0; j < nb; ++j) {
    bk.a[j] = static_cast<const float*>(a_ptrs[j]);
    bk.b[j] = static_cast<const float*>(b_ptrs[j]);
    bk.sc[j] = static_cast<const float*>(sc_ptrs[j]);
    bk.u[j] = uoff;
    bk.r[j] = ranks[j];
    bk.S[j] = nslots[j];
    uoff += int64_t(M) * ranks[j];
    a_vec &= aligned16(a_ptrs[j]) ? 1 : 0;
    b_vec &= aligned16(b_ptrs[j]) ? 1 : 0;
  }
  const int x_vec = (K % 4 == 0 && aligned16(x)) ? 1 : 0;
  const int vec = (N % 4 == 0 && aligned16(out) && b_vec) ? 1 : 0;
  // the expand's u, out tile and B tile
  const size_t smem =
      sizeof(float) * (size_t(rsum) * kRows + (kRows + kRankChunk) * kChunk);
  static size_t smem_set = 48 << 10;   // the default opt-in limit
  if (smem > smem_set) {
    const cudaError_t err = cudaFuncSetAttribute(
        lora_expand_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
    smem_set = smem;
  }
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int passes = (rep + kRows - 1) / kRows;
  const int lanes = (M / rep) * passes;
  const float* xf = static_cast<const float*>(x);
  const int* sl = static_cast<const int*>(slots);
  float* sf = static_cast<float*>(scratch);
  const dim3 sgrid(lanes, splits);
  const size_t psmem = sizeof(float) * size_t(rsum) * kRows;
  const int stages = slice_rows / stage_rows;
  cudaError_t err;
  if (stage_rows == 128)
    err = launch_shrink<128>(sgrid, psmem, st, xf, sl, sf, bk, nb, slot_cols,
                             K, rep, passes, stages, splits, x_vec, a_vec);
  else
    err = launch_shrink<256>(sgrid, psmem, st, xf, sl, sf, bk, nb, slot_cols,
                             K, rep, passes, stages, splits, x_vec, a_vec);
  if (err != cudaSuccess) return static_cast<int>(err);

  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(lanes, tiles);
  cfg.blockDim = dim3(kExpandThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = st;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[0].val.programmaticStreamSerializationAllowed = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, lora_expand_kernel, static_cast<float*>(out),
                           sl, static_cast<const float*>(sf), bk, nb,
                           slot_cols, N, rep, passes, vec);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}
