// Flash attention, forward and backward, for Hopper (sm_90a).
//
// Replaces the Pallas kernels of paddle_tpu/kernels/flash_attention.py:
//   forward  _flash_fwd_pallas (:169, pallas_call :204; S <= 2048) and
//            _flash_fwd_stream (:286, pallas_call :315; S > 2048)
//   backward _flash_bwd_pallas (:641, pallas_calls :670/:731/:768) and
//            _flash_bwd_stream (:454, pallas_calls :478/:504).
// The TPU splits each pair by a VMEM rule (_panel_max, :72): a full K/V
// panel per (b, h) when it fits, KV-block streaming when it does not. A
// GPU block has at most 227 KB of shared memory, so every sequence
// length streams here, and one kernel serves both regimes.
//
// What is computed, on q, k, v [B, H, S, D] (float32 or bfloat16, one
// dtype), in float32:
//   s = q k^T * scale + bias[b|0, h|0] + mask[b][key]; causal keys past
//   the query are *replaced* by NEG_INF (-1e30), as :136-147 do;
//   o = softmax(s) v in the input dtype; lse = m + log(sum exp(s - m))
//   float32 [B, H, S] (the TPU's lane-replicated [B, H, S, 128] is a
//   TPU layout rule and does not carry over), written only when the
//   backward will need it.
//   delta = rowsum(dO * o); p = exp(s - lse); dlogits = p (dP - delta)
//   with dP = dO v^T; dq = dlogits * scale k; dk = (dlogits * scale)^T q;
//   dv = p^T dO; dbias = dlogits summed over the dims the bias
//   broadcasts (:570-578, :681-747).
// Keys past S do not exist (the TPU pads and force-masks them; here the
// tiles are bounds-checked, which gives the same result).
//
// Forward. 256 threads a block, as a 16 x 16 grid; tiles of BT = 64
// query rows and 64 keys (32 for D > 128), each thread owning a 4 x 4
// (2 x 2) piece of every score tile and 4 (2) rows x D/16 columns of every
// accumulator, on the FP32 units. Tiles are staged in shared memory as
// float32 with a row stride of D + 1, so the column-walking reads of the
// score product hit 32 different banks. The online softmax state (m, l)
// and the output accumulator stay in registers (:265-275); each thread
// keeps a partial l of its own columns, summed across its 16 row-mates
// once at the end.
//
// Backward, on the tensor cores: three kernels, delta (one warp a row),
// dq (a block per query tile walks the key tiles) and dk/dv (a block per
// key tile walks the query tiles, S transposed). A warp owns 16 rows;
// S = Q K^T and dP = dO V^T are mma products from shared-memory tiles,
// the softmax gradient dS = P (dP - delta) is taken in float32 on the C
// fragments, and dQ += dS K, dV += P^T dO, dK += dS^T Q take P and dS
// straight from those registers as the left operand. bfloat16 inputs:
// bf16 mma.m16n8k16, P and dS rounded to bf16 for the second products
// (as FlashAttention-2). float32 inputs: 3xTF32 on mma.m16n8k8, each
// operand split into a tf32 hi and lo and hi*hi + hi*lo + lo*hi summed
// (a single TF32 product would miss the float32 tolerance). The streamed
// tiles go through a two-stage cp.async ring in dynamic shared memory
// with rows padded so the fragment loads are free of bank conflicts
// (mma.cuh). No float atomics: every output element is summed by one
// thread in a fixed order, so two runs give the same bits. A broadcast
// bias's gradient is reduced inside the dq kernel: a block owns (query
// tile, kept dims) and walks the broadcast dims in order, adding into the
// bias-shaped float32 buffer (zeroed by the wrapper), so no [B, H, S, S]
// intermediate exists.
// Causal: key tiles entirely above the diagonal are skipped (:247).
//
// Bound: forward 4 B H S^2 D flops (half when causal), backward 10 B H
// S^2 D (half when causal), plus the bytes of q, k, v, o, dO, dq, dk, dv
// and lse; at these shapes the flops bound it. The backward's two
// kernels recompute S and dP (14 instead of 10 B H S^2 D) to keep dq
// free of atomics, and run at the bf16 rate (989 TFLOP/s) or the 3xTF32
// rate (495/3) on float32. The forward still runs on the FP32 units (67
// TFLOP/s); its tensor-core redesign can reuse mma.cuh's tile products.

#include <math.h>

#include <initializer_list>

#include "common.cuh"
#include "mma.cuh"

namespace {

constexpr int kThreads = 256;
constexpr float kNegInf = -1e30f;   // NEG_INF of the reference, not -inf

// row stride of a staged [rows, D] tile, in floats
__host__ __device__ __forceinline__ int ld_of(int D) { return D + 1; }

// Stage rows [r0, r0 + BT) of a [S, D] slab into sh (float32, stride
// D + 1); rows past S are zero.
template <typename T, int BT>
__device__ __forceinline__ void load_tile(float* sh, const T* g, int r0,
                                          int S, int D) {
  const int ld = ld_of(D);
  for (int i = threadIdx.x; i < BT * D; i += kThreads) {
    const int r = i / D, c = i - r * D;
    const int gr = r0 + r;
    sh[r * ld + c] =
        gr < S ? pt::to_float(g[static_cast<int64_t>(gr) * D + c]) : 0.f;
  }
}

// max / sum over the 16 lanes that share a tile row (the two halves of
// a warp hold two rows)
__device__ __forceinline__ float row_max16(float v) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}
__device__ __forceinline__ float row_sum16(float v) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// The score of (query r, key c) before the softmax, from the raw dot
// product: the reference's order (scale, + bias, + mask, causal where).
__device__ __forceinline__ float masked_score(float dot, float scale,
                                              const float* bias_bh,
                                              const float* mask_b, int r,
                                              int c, int S, int causal) {
  float x = dot * scale;
  if (bias_bh) x += bias_bh[static_cast<int64_t>(r) * S + c];
  if (mask_b) x += mask_b[c];
  if (causal && c > r) x = kNegInf;
  return x;
}

__device__ __forceinline__ const float* bias_slab(const float* bias, int b,
                                                  int h, int Bb, int Hb,
                                                  int S) {
  if (!bias) return nullptr;
  const int64_t idx = static_cast<int64_t>(Bb > 1 ? b : 0) * Hb +
                      (Hb > 1 ? h : 0);
  return bias + idx * S * S;
}

// ---------------------------------------------------------------------------
// forward: one block per (query tile, b * H + h)
// ---------------------------------------------------------------------------

template <typename T, int BT, int DMAX>
__global__ void __launch_bounds__(kThreads)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, const float* __restrict__ mask,
                 const float* __restrict__ bias, T* __restrict__ o,
                 float* __restrict__ lse, int H, int S, int D, int Bb, int Hb,
                 float scale, int causal) {
  constexpr int R = BT / 16, RD = DMAX / 16;
  extern __shared__ float smem[];
  const int ld = ld_of(D);
  float* sQ = smem;              // [BT, ld]
  float* sKV = sQ + BT * ld;     // [BT, ld]: K, then V of the same tile
  float* sP = sKV + BT * ld;     // [BT, BT + 1]
  const int qt = blockIdx.x, bh = blockIdx.y;
  const int b = bh / H, h = bh - b * H;
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  const int64_t base = static_cast<int64_t>(bh) * S * D;
  const int q0 = qt * BT;
  const float* bias_bh = bias_slab(bias, b, h, Bb, Hb, S);
  const float* mask_b = mask ? mask + static_cast<int64_t>(b) * S : nullptr;

  load_tile<T, BT>(sQ, q + base, q0, S, D);
  float m[R], l[R], acc[R][RD];
#pragma unroll
  for (int i = 0; i < R; ++i) {
    m[i] = kNegInf;   // as the streaming kernel's init (:242)
    l[i] = 0.f;
#pragma unroll
    for (int j = 0; j < RD; ++j) acc[i][j] = 0.f;
  }
  const int nk = (S + BT - 1) / BT;
  const int kt_end = causal ? min(nk, qt + 1) : nk;
  for (int kt = 0; kt < kt_end; ++kt) {
    const int k0 = kt * BT;
    __syncthreads();   // the last tile's P V is done with sKV and sP
    load_tile<T, BT>(sKV, k + base, k0, S, D);
    __syncthreads();
    float s[R][R];
#pragma unroll
    for (int i = 0; i < R; ++i)
#pragma unroll
      for (int j = 0; j < R; ++j) s[i][j] = 0.f;
    for (int d = 0; d < D; ++d) {
      float a[R], kk[R];
#pragma unroll
      for (int i = 0; i < R; ++i) a[i] = sQ[(ty + 16 * i) * ld + d];
#pragma unroll
      for (int j = 0; j < R; ++j) kk[j] = sKV[(tx + 16 * j) * ld + d];
#pragma unroll
      for (int i = 0; i < R; ++i)
#pragma unroll
        for (int j = 0; j < R; ++j) s[i][j] = fmaf(a[i], kk[j], s[i][j]);
    }
#pragma unroll
    for (int i = 0; i < R; ++i) {
      const int r = q0 + ty + 16 * i;
      const int rr = r < S ? r : S - 1;   // rows past S are never written
      float mx = -INFINITY;
#pragma unroll
      for (int j = 0; j < R; ++j) {
        const int c = k0 + tx + 16 * j;
        s[i][j] = c < S ? masked_score(s[i][j], scale, bias_bh, mask_b, rr,
                                       c, S, causal)
                        : -INFINITY;
        mx = fmaxf(mx, s[i][j]);
      }
      const float m_new = fmaxf(m[i], row_max16(mx));
      const float corr = expf(m[i] - m_new);
      float psum = 0.f;
#pragma unroll
      for (int j = 0; j < R; ++j) {
        const float p = expf(s[i][j] - m_new);
        psum += p;
        sP[(ty + 16 * i) * (BT + 1) + tx + 16 * j] = p;
      }
      l[i] = l[i] * corr + psum;
      m[i] = m_new;
#pragma unroll
      for (int j = 0; j < RD; ++j) acc[i][j] *= corr;
    }
    __syncthreads();   // every thread is done with K; sP is complete
    load_tile<T, BT>(sKV, v + base, k0, S, D);
    __syncthreads();
    for (int kk = 0; kk < BT; ++kk) {
      float vv[RD];
#pragma unroll
      for (int j = 0; j < RD; ++j) {
        const int c = tx + 16 * j;
        vv[j] = c < D ? sKV[kk * ld + c] : 0.f;
      }
#pragma unroll
      for (int i = 0; i < R; ++i) {
        const float p = sP[(ty + 16 * i) * (BT + 1) + kk];
#pragma unroll
        for (int j = 0; j < RD; ++j) acc[i][j] = fmaf(p, vv[j], acc[i][j]);
      }
    }
  }
#pragma unroll
  for (int i = 0; i < R; ++i) {
    const float lt = row_sum16(l[i]);
    const int r = q0 + ty + 16 * i;
    if (r >= S) continue;
    const float inv = 1.f / lt;
#pragma unroll
    for (int j = 0; j < RD; ++j) {
      const int c = tx + 16 * j;
      if (c < D)
        o[base + static_cast<int64_t>(r) * D + c] =
            pt::from_float<T>(acc[i][j] * inv);
    }
    if (lse && tx == 0) lse[static_cast<int64_t>(bh) * S + r] = m[i] + logf(lt);
  }
}

// ---------------------------------------------------------------------------
// backward 1: delta = rowsum(dO * o), one warp a row
// ---------------------------------------------------------------------------

template <typename T>
__global__ void __launch_bounds__(kThreads)
flash_delta_kernel(const T* __restrict__ o, const T* __restrict__ dout,
                   float* __restrict__ delta, int64_t rows, int D) {
  const int64_t row =
      static_cast<int64_t>(blockIdx.x) * (kThreads / 32) + (threadIdx.x >> 5);
  if (row >= rows) return;
  const int lane = threadIdx.x & 31;
  float acc = 0.f;
  for (int c = lane; c < D; c += 32)
    acc = fmaf(pt::to_float(dout[row * D + c]), pt::to_float(o[row * D + c]),
               acc);
  acc = pt::warp_sum(acc);
  if (lane == 0) delta[row] = acc;
}

// ---------------------------------------------------------------------------
// backward on the tensor cores. Per (dtype, padded head dim DP) a shape:
// a block of WARPS warps owns 16 * WARPS rows (queries in dq, keys in
// dk/dv), each warp 16 of them, and streams tiles of BN rows of the other
// side through a two-stage cp.async ring; a block writes DO of the DP
// output columns (grid.z = DP / DO: at DP = 256 two blocks share a tile,
// each recomputing S and dP, so that the accumulators fit the registers).
// Shared memory is [rows][DP + Pad] of the input dtype; float32 inputs
// take 3xTF32 products, bfloat16 inputs bf16 products with P and dS
// rounded to bf16 (pt::mma::warp_mma_abt / warp_mma_pb).
// ---------------------------------------------------------------------------

template <typename T, int DP>
struct BwdShape;
template <>
struct BwdShape<__nv_bfloat16, 64> {
  static constexpr int WARPS = 4, BN_DQ = 64, BN_DKV = 64, DO = 64;
};
template <>
struct BwdShape<__nv_bfloat16, 128> {
  static constexpr int WARPS = 4, BN_DQ = 64, BN_DKV = 32, DO = 128;
};
template <>
struct BwdShape<__nv_bfloat16, 256> {
  static constexpr int WARPS = 4, BN_DQ = 32, BN_DKV = 32, DO = 128;
};
template <>
struct BwdShape<float, 64> {
  static constexpr int WARPS = 4, BN_DQ = 64, BN_DKV = 64, DO = 64;
};
template <>
struct BwdShape<float, 128> {
  static constexpr int WARPS = 4, BN_DQ = 64, BN_DKV = 32, DO = 128;
};
template <>
struct BwdShape<float, 256> {
  static constexpr int WARPS = 2, BN_DQ = 32, BN_DKV = 32, DO = 128;
};

template <typename T, int DP>
__host__ __device__ constexpr int bwd_ld() {
  return DP + pt::mma::Pad<T>::value;
}

// ---------------------------------------------------------------------------
// backward 2: dq (and dbias), one block per (query tile, group, column
// chunk); a group is one (b, h) when the bias is absent or full, else the
// kept dims of the bias, whose broadcast dims the block walks in order
// ---------------------------------------------------------------------------

template <typename T, int DP>
__global__ void __launch_bounds__(BwdShape<T, DP>::WARPS * 32, 1)
flash_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
                const T* __restrict__ v, const T* __restrict__ dout,
                const float* __restrict__ lse,
                const float* __restrict__ delta,
                const float* __restrict__ mask,
                const float* __restrict__ bias, T* __restrict__ dq,
                float* __restrict__ dbias, int H, int S, int D, int Bb,
                int Hb, int walk_b, int walk_h, int nb, float scale,
                int causal, int vec) {
  using Shape = BwdShape<T, DP>;
  constexpr int NTH = Shape::WARPS * 32, BM = 16 * Shape::WARPS;
  constexpr int BN = Shape::BN_DQ, LD = bwd_ld<T, DP>();
  constexpr int NT = BN / 8, OT = Shape::DO / 8;
  extern __shared__ __align__(16) unsigned char bwd_smem[];
  T* sQ = reinterpret_cast<T*>(bwd_smem);   // [BM, LD]
  T* sdO = sQ + BM * LD;                    // [BM, LD]
  T* ring = sdO + BM * LD;                  // 2 stages of K, V [BN, LD]
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int qt = blockIdx.x, grp = blockIdx.y, j0 = blockIdx.z * Shape::DO;
  const int q0 = qt * BM;
  const int rows[2] = {q0 + warp * 16 + g, q0 + warp * 16 + g + 8};
  const int nh_out = walk_h ? 1 : H, nh_in = walk_h ? H : 1;
  const int members = (walk_b ? nb : 1) * nh_in;
  const int nk = (S + BN - 1) / BN;
  const int kt_end = causal ? min(nk, (min(q0 + BM, S) - 1) / BN + 1) : nk;
  for (int mem = 0; mem < members; ++mem) {
    const int b = grp / nh_out + mem / nh_in;
    const int h = grp - (grp / nh_out) * nh_out + mem - (mem / nh_in) * nh_in;
    const int bh = b * H + h;
    const int64_t base = static_cast<int64_t>(bh) * S * D;
    const float* bias_bh = bias_slab(bias, b, h, Bb, Hb, S);
    // the column chunks of a tile share its dbias: chunk 0 writes it
    float* dbias_bh =
        (dbias && blockIdx.z == 0) ? dbias + (bias_bh - bias) : nullptr;
    const float* mask_b = mask ? mask + static_cast<int64_t>(b) * S : nullptr;
    __syncthreads();   // the last member's tiles are no longer read
    pt::mma::load_tile<T, BM, DP, LD, NTH>(sQ, q + base, q0, S, D, vec);
    pt::mma::load_tile<T, BM, DP, LD, NTH>(sdO, dout + base, q0, S, D, vec);
    pt::mma::load_tile<T, BN, DP, LD, NTH>(ring, k + base, 0, S, D, vec);
    pt::mma::load_tile<T, BN, DP, LD, NTH>(ring + BN * LD, v + base, 0, S, D,
                                           vec);
    pt::mma::cp_async_commit();
    float lse_r[2], delta_r[2];
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const int r = rows[hh];
      lse_r[hh] = r < S ? lse[static_cast<int64_t>(bh) * S + r] : 0.f;
      delta_r[hh] = r < S ? delta[static_cast<int64_t>(bh) * S + r] : 0.f;
    }
    float acc[OT][4];
#pragma unroll
    for (int j = 0; j < OT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;
    for (int kt = 0; kt < kt_end; ++kt) {
      if (kt + 1 < kt_end) {
        T* nxt = ring + ((kt + 1) & 1) * 2 * BN * LD;
        pt::mma::load_tile<T, BN, DP, LD, NTH>(nxt, k + base, (kt + 1) * BN,
                                               S, D, vec);
        pt::mma::load_tile<T, BN, DP, LD, NTH>(nxt + BN * LD, v + base,
                                               (kt + 1) * BN, S, D, vec);
        pt::mma::cp_async_commit();
        pt::mma::cp_async_wait<1>();
      } else {
        pt::mma::cp_async_wait<0>();
      }
      __syncthreads();
      const T* sK = ring + (kt & 1) * 2 * BN * LD;
      const T* sV = sK + BN * LD;
      float s[NT][4], dp[NT][4];
#pragma unroll
      for (int n = 0; n < NT; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[n][e] = dp[n][e] = 0.f;
      pt::mma::warp_mma_abt<NT, DP, LD>(s, sQ + warp * 16 * LD, sK);
      pt::mma::warp_mma_abt<NT, DP, LD>(dp, sdO + warp * 16 * LD, sV);
      const int k0 = kt * BN;
#pragma unroll
      for (int n = 0; n < NT; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int r = rows[e >> 1], c = k0 + n * 8 + 2 * t + (e & 1);
          float dl = 0.f;
          if (r < S && c < S) {
            const float x = masked_score(s[n][e], scale, bias_bh, mask_b, r,
                                         c, S, causal);
            const float p = expf(x - lse_r[e >> 1]);
            dl = p * (dp[n][e] - delta_r[e >> 1]);
            if (dbias_bh) dbias_bh[static_cast<int64_t>(r) * S + c] += dl;
          }
          s[n][e] = dl * scale;
        }
      pt::mma::warp_mma_pb<NT, OT, LD>(acc, s, sK + j0);
      __syncthreads();   // the next load refills this stage's other half
    }
#pragma unroll
    for (int j = 0; j < OT; ++j) {
      const int c = j0 + j * 8 + 2 * t;
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        const int r = rows[hh];
        if (r >= S) continue;
        T* o = dq + base + static_cast<int64_t>(r) * D;
        if (c < D) o[c] = pt::from_float<T>(acc[j][2 * hh]);
        if (c + 1 < D) o[c + 1] = pt::from_float<T>(acc[j][2 * hh + 1]);
      }
    }
  }
}

// ---------------------------------------------------------------------------
// backward 3: dk, dv, one block per (key tile, b * H + h, column chunk);
// the warps' rows are keys and the streamed tiles queries (S transposed)
// ---------------------------------------------------------------------------

template <typename T, int DP>
__global__ void __launch_bounds__(BwdShape<T, DP>::WARPS * 32, 1)
flash_dkv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, const T* __restrict__ dout,
                 const float* __restrict__ lse,
                 const float* __restrict__ delta,
                 const float* __restrict__ mask,
                 const float* __restrict__ bias, T* __restrict__ dk,
                 T* __restrict__ dv, int H, int S, int D, int Bb, int Hb,
                 float scale, int causal, int vec) {
  using Shape = BwdShape<T, DP>;
  constexpr int NTH = Shape::WARPS * 32, BM = 16 * Shape::WARPS;
  constexpr int BN = Shape::BN_DKV, LD = bwd_ld<T, DP>();
  constexpr int NT = BN / 8, OT = Shape::DO / 8;
  extern __shared__ __align__(16) unsigned char bwd_smem[];
  T* sK = reinterpret_cast<T*>(bwd_smem);   // [BM, LD]
  T* sV = sK + BM * LD;                     // [BM, LD]
  T* ring = sV + BM * LD;                   // 2 stages of Q, dO [BN, LD]
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int kt = blockIdx.x, bh = blockIdx.y, j0 = blockIdx.z * Shape::DO;
  const int b = bh / H, h = bh - b * H;
  const int k0 = kt * BM;
  const int keys[2] = {k0 + warp * 16 + g, k0 + warp * 16 + g + 8};
  const int64_t base = static_cast<int64_t>(bh) * S * D;
  const float* bias_bh = bias_slab(bias, b, h, Bb, Hb, S);
  const float* mask_b = mask ? mask + static_cast<int64_t>(b) * S : nullptr;
  const float* lse_bh = lse + static_cast<int64_t>(bh) * S;
  const float* delta_bh = delta + static_cast<int64_t>(bh) * S;
  const int nq = (S + BN - 1) / BN;
  const int qt0 = causal ? k0 / BN : 0;   // earlier queries see no key here

  pt::mma::load_tile<T, BM, DP, LD, NTH>(sK, k + base, k0, S, D, vec);
  pt::mma::load_tile<T, BM, DP, LD, NTH>(sV, v + base, k0, S, D, vec);
  pt::mma::load_tile<T, BN, DP, LD, NTH>(ring, q + base, qt0 * BN, S, D, vec);
  pt::mma::load_tile<T, BN, DP, LD, NTH>(ring + BN * LD, dout + base,
                                         qt0 * BN, S, D, vec);
  pt::mma::cp_async_commit();
  float dka[OT][4], dva[OT][4];
#pragma unroll
  for (int j = 0; j < OT; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) dka[j][e] = dva[j][e] = 0.f;
  for (int qt = qt0; qt < nq; ++qt) {
    const int i = qt - qt0;
    if (qt + 1 < nq) {
      T* nxt = ring + ((i + 1) & 1) * 2 * BN * LD;
      pt::mma::load_tile<T, BN, DP, LD, NTH>(nxt, q + base, (qt + 1) * BN, S,
                                             D, vec);
      pt::mma::load_tile<T, BN, DP, LD, NTH>(nxt + BN * LD, dout + base,
                                             (qt + 1) * BN, S, D, vec);
      pt::mma::cp_async_commit();
      pt::mma::cp_async_wait<1>();
    } else {
      pt::mma::cp_async_wait<0>();
    }
    __syncthreads();
    const T* sQ = ring + (i & 1) * 2 * BN * LD;
    const T* sdO = sQ + BN * LD;
    float st[NT][4], dpt[NT][4];
#pragma unroll
    for (int n = 0; n < NT; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) st[n][e] = dpt[n][e] = 0.f;
    pt::mma::warp_mma_abt<NT, DP, LD>(st, sK + warp * 16 * LD, sQ);
    pt::mma::warp_mma_abt<NT, DP, LD>(dpt, sV + warp * 16 * LD, sdO);
    const int q0 = qt * BN;
#pragma unroll
    for (int n = 0; n < NT; ++n)
#pragma unroll
      for (int par = 0; par < 2; ++par) {
        const int r = q0 + n * 8 + 2 * t + par;   // query
        const float lr = r < S ? lse_bh[r] : 0.f;
        const float dr = r < S ? delta_bh[r] : 0.f;
#pragma unroll
        for (int hh = 0; hh < 2; ++hh) {
          const int c = keys[hh], e = 2 * hh + par;
          float p = 0.f, ds = 0.f;
          if (r < S && c < S) {
            const float x = masked_score(st[n][e], scale, bias_bh, mask_b, r,
                                         c, S, causal);
            p = expf(x - lr);
            ds = p * (dpt[n][e] - dr) * scale;
          }
          st[n][e] = p;
          dpt[n][e] = ds;
        }
      }
    pt::mma::warp_mma_pb<NT, OT, LD>(dva, st, sdO + j0);
    pt::mma::warp_mma_pb<NT, OT, LD>(dka, dpt, sQ + j0);
    __syncthreads();   // the next load refills this stage's other half
  }
#pragma unroll
  for (int j = 0; j < OT; ++j) {
    const int c = j0 + j * 8 + 2 * t;
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const int r = keys[hh];
      if (r >= S) continue;
      const int64_t off = base + static_cast<int64_t>(r) * D;
      if (c < D) {
        dk[off + c] = pt::from_float<T>(dka[j][2 * hh]);
        dv[off + c] = pt::from_float<T>(dva[j][2 * hh]);
      }
      if (c + 1 < D) {
        dk[off + c + 1] = pt::from_float<T>(dka[j][2 * hh + 1]);
        dv[off + c + 1] = pt::from_float<T>(dva[j][2 * hh + 1]);
      }
    }
  }
}

// ---------------------------------------------------------------------------
// launchers: the tile and register shapes by head dim
// ---------------------------------------------------------------------------

template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, size_t bytes) {
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(bytes));
}

template <typename T, int BT, int DMAX>
cudaError_t launch_fwd(const void* q, const void* k, const void* v,
                       const float* mask, const float* bias, void* o,
                       float* lse, int B, int H, int S, int D, int Bb, int Hb,
                       float scale, int causal, cudaStream_t st) {
  const size_t smem = sizeof(float) * (2 * BT * ld_of(D) + BT * (BT + 1));
  auto kern = flash_fwd_kernel<T, BT, DMAX>;
  cudaError_t err = allow_smem(kern, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((S + BT - 1) / BT, B * H);
  kern<<<grid, kThreads, smem, st>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), mask, bias, static_cast<T*>(o), lse, H, S, D,
      Bb, Hb, scale, causal);
  return cudaGetLastError();
}

// cp.async needs D * sizeof(T) a multiple of 16 and 16-byte aligned slabs
template <typename T>
int bwd_vec(int D, std::initializer_list<const void*> ptrs) {
  if ((D * sizeof(T)) % 16 != 0) return 0;
  for (const void* p : ptrs)
    if (reinterpret_cast<uintptr_t>(p) % 16 != 0) return 0;
  return 1;
}

template <typename T, int DP>
cudaError_t launch_dq(const void* q, const void* k, const void* v,
                      const void* dout, const float* lse, const float* delta,
                      const float* mask, const float* bias, void* dq,
                      float* dbias, int B, int H, int S, int D, int Bb, int Hb,
                      float scale, int causal, cudaStream_t st) {
  using Shape = BwdShape<T, DP>;
  constexpr int BM = 16 * Shape::WARPS;
  const size_t smem =
      sizeof(T) * (2 * BM + 4 * Shape::BN_DQ) * bwd_ld<T, DP>();
  auto kern = flash_dq_kernel<T, DP>;
  cudaError_t err = allow_smem(kern, smem);
  if (err != cudaSuccess) return err;
  // a broadcast bias dim is walked inside the block (dbias reduced in a
  // fixed order); otherwise every (b, h) is its own block
  const int walk_b = (bias && Bb == 1 && B > 1) ? 1 : 0;
  const int walk_h = (bias && Hb == 1 && H > 1) ? 1 : 0;
  const int groups = (walk_b ? 1 : B) * (walk_h ? 1 : H);
  const dim3 grid((S + BM - 1) / BM, groups, DP / Shape::DO);
  kern<<<grid, Shape::WARPS * 32, smem, st>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const T*>(dout), lse, delta, mask,
      bias, static_cast<T*>(dq), dbias, H, S, D, Bb, Hb, walk_b, walk_h, B,
      scale, causal, bwd_vec<T>(D, {q, k, v, dout}));
  return cudaGetLastError();
}

template <typename T, int DP>
cudaError_t launch_dkv(const void* q, const void* k, const void* v,
                       const void* dout, const float* lse,
                       const float* delta, const float* mask,
                       const float* bias, void* dk, void* dv, int B, int H,
                       int S, int D, int Bb, int Hb, float scale, int causal,
                       cudaStream_t st) {
  using Shape = BwdShape<T, DP>;
  constexpr int BM = 16 * Shape::WARPS;
  const size_t smem =
      sizeof(T) * (2 * BM + 4 * Shape::BN_DKV) * bwd_ld<T, DP>();
  auto kern = flash_dkv_kernel<T, DP>;
  cudaError_t err = allow_smem(kern, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((S + BM - 1) / BM, B * H, DP / Shape::DO);
  kern<<<grid, Shape::WARPS * 32, smem, st>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const T*>(dout), lse, delta, mask,
      bias, static_cast<T*>(dk), static_cast<T*>(dv), H, S, D, Bb, Hb, scale,
      causal, bwd_vec<T>(D, {q, k, v, dout}));
  return cudaGetLastError();
}

// D <= 64: 64-tiles, 4 accumulator columns a thread; D <= 128: 64-tiles,
// 8 columns; D <= 256: 32-tiles (shared memory), 16 columns.
#define PT_FLASH_DISPATCH(T, FN, ...)                         \
  (D <= 64    ? FN<T, 64, 64>(__VA_ARGS__)                    \
   : D <= 128 ? FN<T, 64, 128>(__VA_ARGS__)                   \
   : D <= 256 ? FN<T, 32, 256>(__VA_ARGS__)                   \
              : cudaErrorInvalidValue)

#define PT_FLASH_BY_DTYPE(FN, ...)                                  \
  (dtype == pt::kFloat32    ? PT_FLASH_DISPATCH(float, FN, __VA_ARGS__) \
   : dtype == pt::kBFloat16 ? PT_FLASH_DISPATCH(__nv_bfloat16, FN,      \
                                                __VA_ARGS__)            \
                            : cudaErrorInvalidValue)

// the backward's shapes by padded head dim (BwdShape)
#define PT_FLASH_BWD_DISPATCH(T, FN, ...)     \
  (D <= 64    ? FN<T, 64>(__VA_ARGS__)        \
   : D <= 128 ? FN<T, 128>(__VA_ARGS__)       \
   : D <= 256 ? FN<T, 256>(__VA_ARGS__)       \
              : cudaErrorInvalidValue)

#define PT_FLASH_BWD_BY_DTYPE(FN, ...)                                    \
  (dtype == pt::kFloat32 ? PT_FLASH_BWD_DISPATCH(float, FN, __VA_ARGS__)  \
   : dtype == pt::kBFloat16                                               \
       ? PT_FLASH_BWD_DISPATCH(__nv_bfloat16, FN, __VA_ARGS__)            \
       : cudaErrorInvalidValue)

}  // namespace

// q, k, v, o: [B, H, S, D] contiguous, one dtype; mask: float32 [B, S] or
// null; bias: float32 [Bb, Hb, S, S] or null; lse: float32 [B, H, S] or
// null (no backward to follow).
extern "C" int pt_flash_attention_fwd(const void* q, const void* k,
                                      const void* v, const void* mask,
                                      const void* bias, void* o, void* lse,
                                      int B, int H, int S, int D, int Bb,
                                      int Hb, float scale, int causal,
                                      int dtype, void* stream) {
  if (B <= 0 || H <= 0 || S <= 0 || D <= 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* mk = static_cast<const float*>(mask);
  const float* bs = static_cast<const float*>(bias);
  float* ls = static_cast<float*>(lse);
  return static_cast<int>(PT_FLASH_BY_DTYPE(launch_fwd, q, k, v, mk, bs, o,
                                            ls, B, H, S, D, Bb, Hb, scale,
                                            causal, st));
}

// delta: float32 [rows] = rowsum(dO * o) over rows of D.
extern "C" int pt_flash_attention_bwd_delta(const void* o, const void* dout,
                                            void* delta, long long rows,
                                            int D, int dtype, void* stream) {
  if (rows <= 0 || D <= 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int per_block = kThreads / 32;
  const unsigned blocks =
      static_cast<unsigned>((rows + per_block - 1) / per_block);
  float* dl = static_cast<float*>(delta);
  switch (dtype) {
    case pt::kFloat32:
      flash_delta_kernel<float><<<blocks, kThreads, 0, st>>>(
          static_cast<const float*>(o), static_cast<const float*>(dout), dl,
          rows, D);
      break;
    case pt::kBFloat16:
      flash_delta_kernel<__nv_bfloat16><<<blocks, kThreads, 0, st>>>(
          static_cast<const __nv_bfloat16*>(o),
          static_cast<const __nv_bfloat16*>(dout), dl, rows, D);
      break;
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

// dq: [B, H, S, D] of the input dtype; dbias: float32 [Bb, Hb, S, S],
// zeroed by the caller, or null (no bias).
extern "C" int pt_flash_attention_bwd_dq(
    const void* q, const void* k, const void* v, const void* dout,
    const void* lse, const void* delta, const void* mask, const void* bias,
    void* dq, void* dbias, int B, int H, int S, int D, int Bb, int Hb,
    float scale, int causal, int dtype, void* stream) {
  if (B <= 0 || H <= 0 || S <= 0 || D <= 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return static_cast<int>(PT_FLASH_BWD_BY_DTYPE(
      launch_dq, q, k, v, dout, static_cast<const float*>(lse),
      static_cast<const float*>(delta), static_cast<const float*>(mask),
      static_cast<const float*>(bias), dq, static_cast<float*>(dbias), B, H,
      S, D, Bb, Hb, scale, causal, st));
}

// dk, dv: [B, H, S, D] of the input dtype.
extern "C" int pt_flash_attention_bwd_dkv(
    const void* q, const void* k, const void* v, const void* dout,
    const void* lse, const void* delta, const void* mask, const void* bias,
    void* dk, void* dv, int B, int H, int S, int D, int Bb, int Hb,
    float scale, int causal, int dtype, void* stream) {
  if (B <= 0 || H <= 0 || S <= 0 || D <= 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return static_cast<int>(PT_FLASH_BWD_BY_DTYPE(
      launch_dkv, q, k, v, dout, static_cast<const float*>(lse),
      static_cast<const float*>(delta), static_cast<const float*>(mask),
      static_cast<const float*>(bias), dk, dv, B, H, S, D, Bb, Hb, scale,
      causal, st));
}
