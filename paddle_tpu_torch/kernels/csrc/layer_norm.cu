// Layer norm over [R, C] rows, forward (K1) and backward (K3), for
// Hopper (sm_90a).
//
// K1 replaces the Pallas kernel of paddle_tpu/kernels/layer_norm.py
// (_fwd_impl, pallas_call at :124): y = (x - mean) * rstd * gamma + beta
// per row, population variance taken about the mean (two passes, never
// E[x^2] - E[x]^2), rstd = rsqrt(var + eps), accumulation in float32, y
// in x's dtype. The per-row mean and rstd (float32 [R]) are written when
// the caller passes buffers for them: the backward needs them, the
// serving path does not (the TPU kernel's lane-replicated [R, 128] stats
// are a Mosaic layout rule and are not carried over).
//
// K3 replaces _vjp_bwd (:155, pallas_call at :164):
//   dx = rstd * (dy*g - mean(dy*g) - xhat * mean(dy*g*xhat))
//   dgamma = sum_rows(dy * xhat), dbeta = sum_rows(dy)
//
// Bound: memory. K1 must move x in and y out (2 * R * C * itemsize) plus
// gamma and beta; K3 x and dy in and dx out (3 * R * C * itemsize) plus
// gamma, the stats and dgamma/dbeta. At the serving shape [128, 2048]
// K1's bytes take 0.6 us, under a launch: there it is latency that
// counts, so every load of a row is issued before any is used.
//
// Design. A thread owns fixed 16-byte vectors of a row (4 float32 or 8
// bfloat16 values): vector j = t + k * T of the row's T threads, k <
// nvec. It loads them once, keeps them in registers in their storage
// type (converted at use) and sums its own elements in (k, element)
// order; a row's sums then take a butterfly in each warp and, for more
// than one warp a row, one shared-memory round over the warps' sums
// (row_sum). The geometry (threads a row, vectors a thread, rows a
// block, K3's row runs) comes from the wrapper (kernels/layer_norm.py
// ln_fwd_geometry, ln_bwd_geometry), a function of C, R and the element
// size alone, never of the card: the same inputs give the same bits on
// any card, and a row's result never depends on the rows beside it.
//
// Vector and scalar paths: 16-byte loads and stores need every pointer
// 16-byte aligned and C a multiple of the vector; otherwise (C = 33, an
// input at an odd storage offset) the same kernels load and store
// element by element, zero past C. Both paths own the same columns and
// sum in the same order, so they give the same bits.
//
// K1: a block per row, about 2 vectors a thread (at most 512 threads, 2
// vectors); a row of at most 64 vectors takes one warp, 4 rows a block.
// x, gamma and beta are loaded first; the mean, then the centred
// variance from the registers, each one row_sum; y is written as
// 16-byte stores. Past 1024 vectors a row the looped kernel walks the
// row three times (the re-reads hit L1/L2).
//
// K3: a block per run of rows (runs of up to 8 rows, at least 256 runs
// where R allows, G * C at most 2^19: the wrapper fixes them from R and
// C). gamma is loaded once a block; for each row, x and dy are
// loaded once, and the next row's x and dy are issued before this row's
// reduction (a register double buffer). One row_sum a row reduces the
// pair (sum dy*g, sum dy*g*xhat) with one barrier (the shared buffers
// alternate between rows). dgamma/dbeta partials stay in the owning
// thread's registers over the block's rows and are written once, a row
// of a [G, C] scratch each: no shared-memory accumulator, so no cap on
// C. Rows wider than 2 vectors a thread at 512 threads take the looped
// kernel (a thread walks its columns, the partials read-modify-written
// in the scratch row it owns). The column pass sums the G partial rows
// without float atomics, in a fixed order: a block per 32 columns, warp
// w of 32 sums its contiguous slice of the G rows in row order (a
// 128-byte read per warp and row), the warps' sums added in warp order.

#include <type_traits>

#include "common.cuh"

namespace {

constexpr int kMaxThreads = 512;   // threads a block (the launch bound)
constexpr int kMaxColumnWarps = 32;

template <typename T>
constexpr int kVec = 16 / static_cast<int>(sizeof(T));   // values a vector

__device__ __forceinline__ uint32_t word(const uint4& u, int i) {
  return i == 0 ? u.x : i == 1 ? u.y : i == 2 ? u.z : u.w;
}

// Value i of a vector as float32 (integer instructions for bfloat16).
template <typename T>
__device__ __forceinline__ float elem(const uint4& u, int i) {
  if constexpr (std::is_same<T, float>::value) {
    return __uint_as_float(word(u, i));
  } else {
    const uint32_t w = word(u, i >> 1);
    return __uint_as_float((i & 1) ? (w & 0xffff0000u) : (w << 16));
  }
}

__device__ __forceinline__ uint32_t bf16_bits(float v) {
  return __bfloat16_as_ushort(__float2bfloat16(v));
}

// kVec<T> float32 values as a vector of T (bfloat16: round to nearest
// even, as torch's cast).
template <typename T>
__device__ __forceinline__ uint4 pack(const float* v) {
  if constexpr (std::is_same<T, float>::value) {
    return make_uint4(__float_as_uint(v[0]), __float_as_uint(v[1]),
                      __float_as_uint(v[2]), __float_as_uint(v[3]));
  } else {
    uint32_t w[4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
      w[i] = bf16_bits(v[2 * i]) | (bf16_bits(v[2 * i + 1]) << 16);
    return make_uint4(w[0], w[1], w[2], w[3]);
  }
}

// Vector j of a row (columns j * V ..): one 16-byte load (VEC), or
// element by element with zeros past C.
template <typename T, bool VEC>
__device__ __forceinline__ uint4 load_vec(const T* __restrict__ row, int j,
                                          int C) {
  constexpr int V = kVec<T>;
  if constexpr (VEC) {
    return *reinterpret_cast<const uint4*>(row + static_cast<int64_t>(j) * V);
  } else {
    uint32_t w[4] = {0u, 0u, 0u, 0u};
    const int c0 = j * V;
#pragma unroll
    for (int i = 0; i < V; ++i) {
      if (c0 + i < C) {
        if constexpr (std::is_same<T, float>::value)
          w[i] = __float_as_uint(row[c0 + i]);
        else
          w[i >> 1] |= static_cast<uint32_t>(__bfloat16_as_ushort(row[c0 + i]))
                       << (16 * (i & 1));
      }
    }
    return make_uint4(w[0], w[1], w[2], w[3]);
  }
}

template <typename T, bool VEC>
__device__ __forceinline__ void store_vec(T* __restrict__ row, int j, int C,
                                          const float* v) {
  constexpr int V = kVec<T>;
  if constexpr (VEC) {
    *reinterpret_cast<uint4*>(row + static_cast<int64_t>(j) * V) = pack<T>(v);
  } else {
    const int c0 = j * V;
#pragma unroll
    for (int i = 0; i < V; ++i)
      if (c0 + i < C) row[c0 + i] = pt::from_float<T>(v[i]);
  }
}

// Column c0 + i of a vector lies in the row (always on the vector path,
// where C is a multiple of the vector).
template <bool VEC>
__device__ __forceinline__ bool in_row(int c0, int i, int C) {
  return VEC || c0 + i < C;
}

// The totals of N per-thread sums over the row's threads, in a fixed
// order: a butterfly in each warp (every lane gets the same bits), then,
// for more than one warp a row, the warps' sums through buf (32 * N
// floats) and a butterfly over them in warp order, zeros past the last
// warp. One barrier; buf must not be written again before the next
// barrier of the block (callers alternate two buffers).
template <int N>
__device__ __forceinline__ void row_sum(float (&v)[N], float* buf,
                                        int warps) {
#pragma unroll
  for (int i = 0; i < N; ++i) v[i] = pt::warp_sum(v[i]);
  if (warps == 1) return;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  if (lane == 0) {
#pragma unroll
    for (int i = 0; i < N; ++i) buf[warp * N + i] = v[i];
  }
  __syncthreads();
#pragma unroll
  for (int i = 0; i < N; ++i)
    v[i] = pt::warp_sum(lane < warps ? buf[lane * N + i] : 0.f);
}

// ---- K1 ------------------------------------------------------------------

// A row's NVEC vectors a thread in registers. A block holds blockDim.x /
// row_threads rows (more than one only when a row is one warp).
template <typename T, int NVEC, bool VEC>
__global__ void __launch_bounds__(kMaxThreads)
layer_norm_fwd_kernel(const T* __restrict__ x, const T* __restrict__ gamma,
                      const T* __restrict__ beta, T* __restrict__ y,
                      float* __restrict__ mean_out,
                      float* __restrict__ rstd_out, int R, int C, float eps,
                      int row_threads) {
  constexpr int V = kVec<T>;
  __shared__ float buf[2][32];
  const int sub = threadIdx.x / row_threads;
  const int t = threadIdx.x - sub * row_threads;
  const int64_t row =
      static_cast<int64_t>(blockIdx.x) * (blockDim.x / row_threads) + sub;
  const bool live = row < R;
  const int nv = (C + V - 1) / V;
  const T* xr = x + (live ? row : 0) * C;

  uint4 xv[NVEC], gv[NVEC], bv[NVEC];
  const uint4 zero = make_uint4(0u, 0u, 0u, 0u);
#pragma unroll
  for (int k = 0; k < NVEC; ++k) {
    const int j = t + k * row_threads;
    xv[k] = live && j < nv ? load_vec<T, VEC>(xr, j, C) : zero;
  }
#pragma unroll
  for (int k = 0; k < NVEC; ++k) {
    const int j = t + k * row_threads;
    gv[k] = j < nv ? load_vec<T, VEC>(gamma, j, C) : zero;
    bv[k] = j < nv ? load_vec<T, VEC>(beta, j, C) : zero;
  }

  float s[1] = {0.f};
#pragma unroll
  for (int k = 0; k < NVEC; ++k)
#pragma unroll
    for (int i = 0; i < V; ++i) s[0] += elem<T>(xv[k], i);
  row_sum(s, buf[0], row_threads >> 5);
  const float mean = s[0] / static_cast<float>(C);

  float q[1] = {0.f};
#pragma unroll
  for (int k = 0; k < NVEC; ++k) {
    const int j = t + k * row_threads;
    if (j < nv) {
#pragma unroll
      for (int i = 0; i < V; ++i) {
        if (in_row<VEC>(j * V, i, C)) {
          const float d = elem<T>(xv[k], i) - mean;
          q[0] += d * d;
        }
      }
    }
  }
  row_sum(q, buf[1], row_threads >> 5);
  const float rstd = rsqrtf(q[0] / static_cast<float>(C) + eps);

  if (!live) return;
  T* yr = y + row * C;
#pragma unroll
  for (int k = 0; k < NVEC; ++k) {
    const int j = t + k * row_threads;
    if (j < nv) {
      float o[V];
#pragma unroll
      for (int i = 0; i < V; ++i)
        o[i] = (elem<T>(xv[k], i) - mean) * rstd * elem<T>(gv[k], i) +
               elem<T>(bv[k], i);
      store_vec<T, VEC>(yr, j, C, o);
    }
  }
  if (t == 0 && mean_out != nullptr) {
    mean_out[row] = mean;
    rstd_out[row] = rstd;
  }
}

// A row too wide for the registers: a block per row walks it three
// times, each thread its vectors j = t + k * blockDim.x in k order (the
// order of the register kernel).
template <typename T, bool VEC>
__global__ void __launch_bounds__(kMaxThreads)
layer_norm_fwd_looped_kernel(const T* __restrict__ x,
                             const T* __restrict__ gamma,
                             const T* __restrict__ beta, T* __restrict__ y,
                             float* __restrict__ mean_out,
                             float* __restrict__ rstd_out, int R, int C,
                             float eps, int row_threads) {
  constexpr int V = kVec<T>;
  __shared__ float buf[2][32];
  const int64_t row = blockIdx.x;
  const int t = threadIdx.x, T_ = blockDim.x;
  const int nv = (C + V - 1) / V;
  const T* xr = x + row * C;

  float s[1] = {0.f};
  for (int j = t; j < nv; j += T_) {
    const uint4 xv = load_vec<T, VEC>(xr, j, C);
#pragma unroll
    for (int i = 0; i < V; ++i) s[0] += elem<T>(xv, i);
  }
  row_sum(s, buf[0], T_ >> 5);
  const float mean = s[0] / static_cast<float>(C);

  float q[1] = {0.f};
  for (int j = t; j < nv; j += T_) {
    const uint4 xv = load_vec<T, VEC>(xr, j, C);
#pragma unroll
    for (int i = 0; i < V; ++i) {
      if (in_row<VEC>(j * V, i, C)) {
        const float d = elem<T>(xv, i) - mean;
        q[0] += d * d;
      }
    }
  }
  row_sum(q, buf[1], T_ >> 5);
  const float rstd = rsqrtf(q[0] / static_cast<float>(C) + eps);

  T* yr = y + row * C;
  for (int j = t; j < nv; j += T_) {
    const uint4 xv = load_vec<T, VEC>(xr, j, C);
    const uint4 gv = load_vec<T, VEC>(gamma, j, C);
    const uint4 bv = load_vec<T, VEC>(beta, j, C);
    float o[V];
#pragma unroll
    for (int i = 0; i < V; ++i)
      o[i] = (elem<T>(xv, i) - mean) * rstd * elem<T>(gv, i) +
             elem<T>(bv, i);
    store_vec<T, VEC>(yr, j, C, o);
  }
  if (t == 0 && mean_out != nullptr) {
    mean_out[row] = mean;
    rstd_out[row] = rstd;
  }
}

// ---- K3 ------------------------------------------------------------------

// Block b takes rows [b * rows_per_block, ...) with NVEC vectors a
// thread in registers, and writes its dgamma/dbeta partials to row b of
// dg_part and db_part ([G, C] float32).
template <typename T, int NVEC, bool VEC>
__global__ void __launch_bounds__(kMaxThreads)
layer_norm_bwd_kernel(const T* __restrict__ x, const T* __restrict__ gamma,
                      const T* __restrict__ dy,
                      const float* __restrict__ mean,
                      const float* __restrict__ rstd, T* __restrict__ dx,
                      float* __restrict__ dg_part,
                      float* __restrict__ db_part, int R, int C,
                      int rows_per_block) {
  constexpr int V = kVec<T>;
  __shared__ float buf[2][64];
  const int t = threadIdx.x, T_ = blockDim.x, warps = T_ >> 5;
  const int nv = (C + V - 1) / V;
  const float inv_c = 1.f / static_cast<float>(C);
  const int64_t r0 = static_cast<int64_t>(blockIdx.x) * rows_per_block;
  const int64_t r1 = min(r0 + rows_per_block, static_cast<int64_t>(R));
  const uint4 zero = make_uint4(0u, 0u, 0u, 0u);

  uint4 xc[NVEC], dc[NVEC], xn[NVEC], dn[NVEC], gv[NVEC];
#pragma unroll
  for (int k = 0; k < NVEC; ++k) {
    const int j = t + k * T_;
    xc[k] = j < nv ? load_vec<T, VEC>(x + r0 * C, j, C) : zero;
    dc[k] = j < nv ? load_vec<T, VEC>(dy + r0 * C, j, C) : zero;
  }
  float mu = mean[r0], rs = rstd[r0];
#pragma unroll
  for (int k = 0; k < NVEC; ++k) {
    const int j = t + k * T_;
    gv[k] = j < nv ? load_vec<T, VEC>(gamma, j, C) : zero;
  }
  float dg[NVEC][V], db[NVEC][V];
#pragma unroll
  for (int k = 0; k < NVEC; ++k)
#pragma unroll
    for (int i = 0; i < V; ++i) dg[k][i] = db[k][i] = 0.f;

  for (int64_t row = r0; row < r1; ++row) {
    // the next row's loads go out before this row's reduction
    float mu_n = 0.f, rs_n = 0.f;
    if (row + 1 < r1) {
#pragma unroll
      for (int k = 0; k < NVEC; ++k) {
        const int j = t + k * T_;
        xn[k] = j < nv ? load_vec<T, VEC>(x + (row + 1) * C, j, C) : zero;
        dn[k] = j < nv ? load_vec<T, VEC>(dy + (row + 1) * C, j, C) : zero;
      }
      mu_n = mean[row + 1];
      rs_n = rstd[row + 1];
    }
    float s[2] = {0.f, 0.f};
#pragma unroll
    for (int k = 0; k < NVEC; ++k) {
      const int j = t + k * T_;
      if (j < nv) {
#pragma unroll
        for (int i = 0; i < V; ++i) {
          if (in_row<VEC>(j * V, i, C)) {
            const float xh = (elem<T>(xc[k], i) - mu) * rs;
            const float dyg = elem<T>(dc[k], i) * elem<T>(gv[k], i);
            s[0] += dyg;
            s[1] += dyg * xh;
          }
        }
      }
    }
    row_sum(s, buf[(row - r0) & 1], warps);
    const float m1 = s[0] * inv_c, m2 = s[1] * inv_c;
    T* dxr = dx + row * C;
#pragma unroll
    for (int k = 0; k < NVEC; ++k) {
      const int j = t + k * T_;
      if (j < nv) {
        float o[V];
#pragma unroll
        for (int i = 0; i < V; ++i) {
          const float xh = (elem<T>(xc[k], i) - mu) * rs;
          const float d = elem<T>(dc[k], i);
          o[i] = rs * (d * elem<T>(gv[k], i) - m1 - xh * m2);
          dg[k][i] += d * xh;
          db[k][i] += d;
        }
        store_vec<T, VEC>(dxr, j, C, o);
      }
    }
#pragma unroll
    for (int k = 0; k < NVEC; ++k) {
      xc[k] = xn[k];
      dc[k] = dn[k];
    }
    mu = mu_n;
    rs = rs_n;
  }

  float* dgo = dg_part + static_cast<int64_t>(blockIdx.x) * C;
  float* dbo = db_part + static_cast<int64_t>(blockIdx.x) * C;
#pragma unroll
  for (int k = 0; k < NVEC; ++k) {
    const int j = t + k * T_;
    if (j >= nv) continue;
    if constexpr (VEC) {   // C is a multiple of V, so of 4: aligned rows
#pragma unroll
      for (int h = 0; h < V; h += 4) {
        *reinterpret_cast<float4*>(dgo + j * V + h) =
            make_float4(dg[k][h], dg[k][h + 1], dg[k][h + 2], dg[k][h + 3]);
        *reinterpret_cast<float4*>(dbo + j * V + h) =
            make_float4(db[k][h], db[k][h + 1], db[k][h + 2], db[k][h + 3]);
      }
    } else {
#pragma unroll
      for (int i = 0; i < V; ++i) {
        if (j * V + i < C) {
          dgo[j * V + i] = dg[k][i];
          dbo[j * V + i] = db[k][i];
        }
      }
    }
  }
}

// A row too wide for the registers: each row is walked twice (the pair
// sums, then dx), a thread its vectors in k order, and the partials are
// read-modify-written in the block's own scratch row (each column by the
// one thread that owns it, in row order: the register kernel's sums).
template <typename T, bool VEC>
__global__ void __launch_bounds__(kMaxThreads)
layer_norm_bwd_looped_kernel(const T* __restrict__ x,
                             const T* __restrict__ gamma,
                             const T* __restrict__ dy,
                             const float* __restrict__ mean,
                             const float* __restrict__ rstd,
                             T* __restrict__ dx, float* __restrict__ dg_part,
                             float* __restrict__ db_part, int R, int C,
                             int rows_per_block) {
  constexpr int V = kVec<T>;
  __shared__ float buf[2][64];
  const int t = threadIdx.x, T_ = blockDim.x, warps = T_ >> 5;
  const int nv = (C + V - 1) / V;
  const float inv_c = 1.f / static_cast<float>(C);
  const int64_t r0 = static_cast<int64_t>(blockIdx.x) * rows_per_block;
  const int64_t r1 = min(r0 + rows_per_block, static_cast<int64_t>(R));
  float* dgo = dg_part + static_cast<int64_t>(blockIdx.x) * C;
  float* dbo = db_part + static_cast<int64_t>(blockIdx.x) * C;

  for (int64_t row = r0; row < r1; ++row) {
    const float mu = mean[row], rs = rstd[row];
    const T* xr = x + row * C;
    const T* dyr = dy + row * C;
    float s[2] = {0.f, 0.f};
    for (int j = t; j < nv; j += T_) {
      const uint4 xv = load_vec<T, VEC>(xr, j, C);
      const uint4 dv = load_vec<T, VEC>(dyr, j, C);
      const uint4 gv = load_vec<T, VEC>(gamma, j, C);
#pragma unroll
      for (int i = 0; i < V; ++i) {
        if (in_row<VEC>(j * V, i, C)) {
          const float xh = (elem<T>(xv, i) - mu) * rs;
          const float dyg = elem<T>(dv, i) * elem<T>(gv, i);
          s[0] += dyg;
          s[1] += dyg * xh;
        }
      }
    }
    row_sum(s, buf[(row - r0) & 1], warps);
    const float m1 = s[0] * inv_c, m2 = s[1] * inv_c;
    T* dxr = dx + row * C;
    for (int j = t; j < nv; j += T_) {
      const uint4 xv = load_vec<T, VEC>(xr, j, C);
      const uint4 dv = load_vec<T, VEC>(dyr, j, C);
      const uint4 gv = load_vec<T, VEC>(gamma, j, C);
      float o[V];
#pragma unroll
      for (int i = 0; i < V; ++i) {
        const float xh = (elem<T>(xv, i) - mu) * rs;
        const float d = elem<T>(dv, i);
        o[i] = rs * (d * elem<T>(gv, i) - m1 - xh * m2);
        const int c = j * V + i;
        if (in_row<VEC>(j * V, i, C)) {
          dgo[c] = (row == r0 ? 0.f : dgo[c]) + d * xh;
          dbo[c] = (row == r0 ? 0.f : dbo[c]) + d;
        }
      }
      store_vec<T, VEC>(dxr, j, C, o);
    }
  }
}

// dgamma, dbeta: a block per 32 columns; warp w sums partial rows
// [w * rows_per_warp, ...) of its column in row order, then warp 0 adds
// the warps' sums in warp order.
template <typename T>
__global__ void layer_norm_bwd_columns_kernel(const float* __restrict__ dg_part,
                                              const float* __restrict__ db_part,
                                              T* __restrict__ dgamma,
                                              T* __restrict__ dbeta, int G,
                                              int C, int rows_per_warp) {
  __shared__ float sums[2][kMaxColumnWarps][32];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int W = blockDim.x >> 5;
  const int c = blockIdx.x * 32 + lane;
  const int g0 = min(warp * rows_per_warp, G);
  const int g1 = min(g0 + rows_per_warp, G);
  float a = 0.f, b = 0.f;
  if (c < C) {
    int g = g0;
    for (; g + 8 <= g1; g += 8) {   // 16 loads in flight, summed in order
      float va[8], vb[8];
#pragma unroll
      for (int u = 0; u < 8; ++u) {
        va[u] = dg_part[static_cast<int64_t>(g + u) * C + c];
        vb[u] = db_part[static_cast<int64_t>(g + u) * C + c];
      }
#pragma unroll
      for (int u = 0; u < 8; ++u) {
        a += va[u];
        b += vb[u];
      }
    }
    for (; g < g1; ++g) {
      a += dg_part[static_cast<int64_t>(g) * C + c];
      b += db_part[static_cast<int64_t>(g) * C + c];
    }
  }
  sums[0][warp][lane] = a;
  sums[1][warp][lane] = b;
  __syncthreads();
  if (warp == 0 && c < C) {
    float ta = 0.f, tb = 0.f;
    for (int w = 0; w < W; ++w) {
      ta += sums[0][w][lane];
      tb += sums[1][w][lane];
    }
    dgamma[c] = pt::from_float<T>(ta);
    dbeta[c] = pt::from_float<T>(tb);
  }
}

bool aligned16(const void* p) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0;
}

template <typename T>
using FwdKernel = void (*)(const T*, const T*, const T*, T*, float*, float*,
                           int, int, float, int);

template <typename T, bool VEC>
FwdKernel<T> fwd_kernel(int nvec) {
  switch (nvec) {
    case 0: return layer_norm_fwd_looped_kernel<T, VEC>;
    case 1: return layer_norm_fwd_kernel<T, 1, VEC>;
    case 2: return layer_norm_fwd_kernel<T, 2, VEC>;
    default: return nullptr;
  }
}

template <typename T>
int launch_fwd(const void* x, const void* gamma, const void* beta, void* y,
               float* mean, float* rstd, int R, int C, float eps,
               int row_threads, int rows_per_block, int nvec,
               cudaStream_t s) {
  constexpr int V = kVec<T>;
  const int threads = row_threads * rows_per_block;
  const int64_t covered = static_cast<int64_t>(row_threads) * nvec * V;
  if (row_threads % 32 != 0 || row_threads < 32 || rows_per_block < 1 ||
      threads > kMaxThreads || (rows_per_block > 1 && row_threads != 32) ||
      (nvec == 0 && rows_per_block != 1) || (nvec > 0 && covered < C))
    return static_cast<int>(cudaErrorInvalidValue);
  const bool vec = C % V == 0 && aligned16(x) && aligned16(gamma) &&
                   aligned16(beta) && aligned16(y);
  const FwdKernel<T> k = vec ? fwd_kernel<T, true>(nvec)
                             : fwd_kernel<T, false>(nvec);
  if (k == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  const unsigned blocks = (R + rows_per_block - 1) / rows_per_block;
  k<<<blocks, threads, 0, s>>>(
      static_cast<const T*>(x), static_cast<const T*>(gamma),
      static_cast<const T*>(beta), static_cast<T*>(y), mean, rstd, R, C, eps,
      row_threads);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
using BwdKernel = void (*)(const T*, const T*, const T*, const float*,
                           const float*, T*, float*, float*, int, int, int);

template <typename T, bool VEC>
BwdKernel<T> bwd_kernel(int nvec) {
  switch (nvec) {
    case 0: return layer_norm_bwd_looped_kernel<T, VEC>;
    case 1: return layer_norm_bwd_kernel<T, 1, VEC>;
    case 2: return layer_norm_bwd_kernel<T, 2, VEC>;
    default: return nullptr;
  }
}

template <typename T>
int launch_bwd(const void* x, const void* gamma, const void* dy,
               const float* mean, const float* rstd, void* dx,
               float* scratch, void* dgamma, void* dbeta, int R, int C,
               int threads, int nvec, int rows_per_block, int blocks,
               int column_warps, cudaStream_t s) {
  constexpr int V = kVec<T>;
  const int64_t covered = static_cast<int64_t>(threads) * nvec * V;
  const bool runs_ok =
      R == 0 ? blocks == 0
             : (static_cast<int64_t>(blocks - 1) * rows_per_block < R &&
                R <= static_cast<int64_t>(blocks) * rows_per_block);
  if (threads % 32 != 0 || threads < 32 || threads > kMaxThreads ||
      rows_per_block < 1 || !runs_ok || column_warps < 1 ||
      column_warps > kMaxColumnWarps || (nvec > 0 && covered < C))
    return static_cast<int>(cudaErrorInvalidValue);
  const bool vec = C % V == 0 && aligned16(x) && aligned16(gamma) &&
                   aligned16(dy) && aligned16(dx);
  const BwdKernel<T> k = vec ? bwd_kernel<T, true>(nvec)
                             : bwd_kernel<T, false>(nvec);
  if (k == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  float* dg_part = scratch;
  float* db_part = scratch + static_cast<int64_t>(blocks) * C;
  if (R > 0) {
    k<<<blocks, threads, 0, s>>>(
        static_cast<const T*>(x), static_cast<const T*>(gamma),
        static_cast<const T*>(dy), mean, rstd, static_cast<T*>(dx), dg_part,
        db_part, R, C, rows_per_block);
    cudaError_t e = cudaGetLastError();
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  const int rows_per_warp = (blocks + column_warps - 1) / column_warps;
  layer_norm_bwd_columns_kernel<T><<<(C + 31) / 32, 32 * column_warps, 0, s>>>(
      dg_part, db_part, static_cast<T*>(dgamma), static_cast<T*>(dbeta),
      blocks, C, rows_per_warp);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// x, y: [R, C] contiguous; gamma, beta: [C]; all of one dtype. mean and
// rstd: float32 [R], or both null (not written). The geometry is
// ln_fwd_geometry(C, itemsize) of kernels/layer_norm.py: row_threads
// threads a row, rows_per_block rows a block (more than one only for a
// row of one warp), nvec vectors a thread in registers (1 or 2; 0:
// the looped kernel, one row a block).
extern "C" int pt_layer_norm_fwd(const void* x, const void* gamma,
                                 const void* beta, void* y, void* mean,
                                 void* rstd, int R, int C, float eps,
                                 int dtype, int row_threads,
                                 int rows_per_block, int nvec, void* stream) {
  if (R <= 0 || C <= 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* m = static_cast<float*>(mean);
  float* r = static_cast<float*>(rstd);
  switch (dtype) {
    case pt::kFloat32:
      return launch_fwd<float>(x, gamma, beta, y, m, r, R, C, eps,
                               row_threads, rows_per_block, nvec, s);
    case pt::kBFloat16:
      return launch_fwd<__nv_bfloat16>(x, gamma, beta, y, m, r, R, C, eps,
                                       row_threads, rows_per_block, nvec, s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

// x, dy, dx: [R, C]; gamma, dgamma, dbeta: [C]; all of one dtype. mean,
// rstd: float32 [R] from the forward. The geometry is
// ln_bwd_geometry(R, C, itemsize) of kernels/layer_norm.py: threads a
// block, nvec vectors a thread in registers (1 or 2; 0: the looped
// kernel), rows_per_block rows a block, blocks = G runs of rows, and
// column_warps warps a block of the column pass. scratch: float32
// [2 * blocks, C] (the dgamma, then the dbeta partial rows). R = 0
// writes zero dgamma and dbeta.
extern "C" int pt_layer_norm_bwd(const void* x, const void* gamma,
                                 const void* dy, const void* mean,
                                 const void* rstd, void* dx, void* scratch,
                                 void* dgamma, void* dbeta, int R, int C,
                                 int dtype, int threads, int nvec,
                                 int rows_per_block, int blocks,
                                 int column_warps, void* stream) {
  if (R < 0 || C <= 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* m = static_cast<const float*>(mean);
  const float* r = static_cast<const float*>(rstd);
  float* sc = static_cast<float*>(scratch);
  switch (dtype) {
    case pt::kFloat32:
      return launch_bwd<float>(x, gamma, dy, m, r, dx, sc, dgamma, dbeta, R,
                               C, threads, nvec, rows_per_block, blocks,
                               column_warps, s);
    case pt::kBFloat16:
      return launch_bwd<__nv_bfloat16>(x, gamma, dy, m, r, dx, sc, dgamma,
                                       dbeta, R, C, threads, nvec,
                                       rows_per_block, blocks, column_warps,
                                       s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
