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
// Forward, on the tensor cores. A block owns 16 query rows a warp and
// walks the key tiles; each warp loads its Q fragments once, for the
// whole walk, and K and V tiles stream through a cp.async ring (the next
// tiles load while the current one is multiplied). S = Q K^T
// is an mma product; scale, bias, mask and causal are applied and the
// online softmax is taken on the C fragments, the four lanes of a row
// sharing (m, l) by quad shuffles; P goes from those registers straight
// into the A operand of P V. bfloat16 inputs: bf16 mma.m16n8k16, with P
// rounded to bf16 for P V (as FlashAttention-2; the one rounding the
// reference does not make, which keeps P in float32), while l and lse
// sum the unrounded float32 P. float32 inputs: 3xTF32 on mma.m16n8k8;
// Q is split into tf32 hi and lo once, K and V once a tile when it is
// staged (hi in place, lo in a plane beside it), P once a tile in
// registers, so no warp splits an operand another has split.
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
// rate (495/3) on float32, as does the forward.

#include <math.h>

#include <initializer_list>

#include "common.cuh"
#include "mma.cuh"

namespace {

constexpr int kThreads = 256;
constexpr float kNegInf = -1e30f;   // NEG_INF of the reference, not -inf

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
// forward on the tensor cores: one block per (query tile, b * H + h). Per
// (dtype, padded head dim DP) a shape: WARPS warps own 16 query rows
// each; key tiles of BN rows stream through a two-stage cp.async ring.
// QREG: Q's fragments live in registers for the whole key walk; else
// (float32 at DP = 256, where Q's hi and lo would take 256 registers) Q
// is split once into two planes of shared memory. Shared memory is sized
// so that at least two blocks fit an SM at DP <= 128.
// ---------------------------------------------------------------------------

template <typename T, int DP>
struct FwdShape;
template <>
struct FwdShape<__nv_bfloat16, 64> {
  static constexpr int WARPS = 4, BN = 64, MINB = 2;
  static constexpr bool QREG = true;
};
template <>
struct FwdShape<__nv_bfloat16, 128> {
  static constexpr int WARPS = 4, BN = 64, MINB = 2;
  static constexpr bool QREG = true;
};
template <>
struct FwdShape<__nv_bfloat16, 256> {
  static constexpr int WARPS = 4, BN = 32, MINB = 1;
  static constexpr bool QREG = true;
};
template <>
struct FwdShape<float, 64> {
  static constexpr int WARPS = 4, BN = 64, MINB = 2;
  static constexpr bool QREG = true;
};
template <>
struct FwdShape<float, 128> {
  static constexpr int WARPS = 4, BN = 32, MINB = 2;
  static constexpr bool QREG = true;
};
template <>
struct FwdShape<float, 256> {
  static constexpr int WARPS = 2, BN = 16, MINB = 1;
  static constexpr bool QREG = false;
};

template <typename T, int DP>
__host__ __device__ constexpr int fwd_ld() {
  return DP + pt::mma::Pad<T>::value;
}

// bytes of dynamic shared memory: the ring (2 stages of K and V); for
// float32 the lo planes of one K and one V tile, and Q's two planes
// unless Q is held in registers
template <typename T, int DP>
constexpr size_t fwd_smem_bytes() {
  using Shape = FwdShape<T, DP>;
  constexpr size_t tile = static_cast<size_t>(Shape::BN) * fwd_ld<T, DP>();
  size_t n = 4 * tile * sizeof(T);
  if (sizeof(T) == 4) {
    n += 2 * tile * 4;
    if (!Shape::QREG) n += 2 * static_cast<size_t>(16 * Shape::WARPS) *
                           fwd_ld<T, DP>() * 4;
  }
  return n;
}

constexpr float kLog2e = 1.4426950408889634f;

// two adjacent outputs (8-byte or 4-byte aligned) in one store
__device__ __forceinline__ void store_pair(float* p, float a, float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
}
__device__ __forceinline__ void store_pair(__nv_bfloat16* p, float a,
                                           float b) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
}

template <typename T, int DP>
__global__ void __launch_bounds__(FwdShape<T, DP>::WARPS * 32,
                                  FwdShape<T, DP>::MINB)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, const float* __restrict__ mask,
                 const float* __restrict__ bias, T* __restrict__ o,
                 float* __restrict__ lse, int H, int S, int D, int Bb, int Hb,
                 float scale, int causal, int vec) {
  using Shape = FwdShape<T, DP>;
  constexpr bool F32 = sizeof(T) == 4;
  constexpr int NTH = Shape::WARPS * 32, BM = 16 * Shape::WARPS;
  constexpr int BN = Shape::BN, LD = fwd_ld<T, DP>();
  constexpr int NT = BN / 8, OT = DP / 8;
  extern __shared__ __align__(16) unsigned char fwd_smem[];
  T* ring = reinterpret_cast<T*>(fwd_smem);   // 2 stages of K, V [BN, LD]
  uint32_t* lo = reinterpret_cast<uint32_t*>(ring + 4 * BN * LD);  // f32
  uint32_t* sQ = lo + 2 * BN * LD;   // f32, !QREG: Q hi, Q lo [BM, LD]
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  // the last query tiles (the longest causal walks) start first
  const int qt = gridDim.x - 1 - blockIdx.x, bh = blockIdx.y;
  const int b = bh / H, h = bh - b * H;
  const int q0 = qt * BM;
  const int rows[2] = {q0 + warp * 16 + g, q0 + warp * 16 + g + 8};
  const int64_t base = static_cast<int64_t>(bh) * S * D;
  const float* bias_bh = bias_slab(bias, b, h, Bb, Hb, S);
  const float* mask_b = mask ? mask + static_cast<int64_t>(b) * S : nullptr;
  const int nk = (S + BN - 1) / BN;
  const int kt_end = causal ? min(nk, (min(q0 + BM, S) - 1) / BN + 1) : nk;

  // the first K/V tile is on its way while Q is read
  auto load_kv = [&](int kt) {
    T* dst = ring + (kt & 1) * 2 * BN * LD;
    pt::mma::load_tile<T, BN, DP, LD, NTH>(dst, k + base, kt * BN, S, D, vec);
    pt::mma::load_tile<T, BN, DP, LD, NTH>(dst + BN * LD, v + base, kt * BN,
                                           S, D, vec);
    pt::mma::cp_async_commit();
  };
  load_kv(0);
  // Q: bf16 A fragments, or float32 split into tf32 hi and lo, once.
  // bf16: the tile is staged in the ring's second stage, which the walk
  // first fills after its first barrier, and read with ldmatrix; float32
  // (QREG): read straight into the fragments (no stage: at D = 128 the
  // staged read costs registers the split operands need).
  constexpr int QS = F32 ? DP / 8 : DP / 16;
  constexpr int QR = Shape::QREG ? QS : 1;
  uint32_t qa[QR][4], qb[QR][4];   // bf16: qa; float32: qa hi, qb lo
  if constexpr (Shape::QREG && F32) {
    pt::mma::load_a_tf32x3<DP>(qa, qb,
                               reinterpret_cast<const float*>(q) + base,
                               q0 + warp * 16, S, D);
  } else if constexpr (Shape::QREG) {
    static_assert(BM <= 2 * BN, "the Q tile must fit one ring stage");
    T* sQs = ring + 2 * BN * LD;
    pt::mma::load_tile<T, BM, DP, LD, NTH>(sQs, q + base, q0, S, D, vec);
    pt::mma::cp_async_commit();
    pt::mma::cp_async_wait<0>();
    __syncthreads();
    const int mi = lane >> 3, r8 = lane & 7;
    const T* pa = sQs + (warp * 16 + (mi & 1) * 8 + r8) * LD + (mi >> 1) * 8;
#pragma unroll
    for (int st = 0; st < QS; ++st) pt::mma::ldmatrix_x4(qa[st], pa + st * 16);
  } else {
    float* qf = reinterpret_cast<float*>(sQ);
    pt::mma::load_tile<float, BM, DP, LD, NTH>(
        qf, reinterpret_cast<const float*>(q) + base, q0, S, D, vec);
    pt::mma::cp_async_commit();
    pt::mma::cp_async_wait<0>();
    __syncthreads();
    pt::mma::split_planes<NTH>(qf, sQ + BM * LD, BM * LD);
    // the first loop iteration synchronises before the planes are read
  }
  (void)qb;

  float m[2] = {kNegInf, kNegInf};   // as the streaming kernel's init (:242)
  float l[2] = {0.f, 0.f};           // this lane's columns only
  float acc[OT][4];
#pragma unroll
  for (int j = 0; j < OT; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;

  for (int kt = 0; kt < kt_end; ++kt) {
    // tile kt is in, and every warp is done with tile kt - 1, whose stage
    // now takes tile kt + 1 while this one is multiplied (one barrier a
    // tile; float32 takes a second one after the split)
    pt::mma::cp_async_wait<0>();
    __syncthreads();
    if (kt + 1 < kt_end) load_kv(kt + 1);
    T* sK = ring + (kt & 1) * 2 * BN * LD;
    T* sV = sK + BN * LD;
    if constexpr (F32) {
      // K and V split once for every warp: hi in place, lo beside
      pt::mma::split_planes<NTH>(reinterpret_cast<float*>(sK), lo,
                                 2 * BN * LD);
      __syncthreads();
    }
    // without a bias, the mask is a column term (-inf past S), read here
    // so that its load latency hides behind the S product
    const int k0 = kt * BN;
    float col[NT][2];
    if (!bias_bh) {
#pragma unroll
      for (int n = 0; n < NT; ++n)
#pragma unroll
        for (int par = 0; par < 2; ++par) {
          const int c = k0 + n * 8 + 2 * t + par;
          col[n][par] = c < S ? (mask_b ? mask_b[c] : 0.f) : -INFINITY;
        }
    }
    float s[NT][4];
#pragma unroll
    for (int n = 0; n < NT; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[n][e] = 0.f;
    if constexpr (F32) {
      const uint32_t* kh = reinterpret_cast<const uint32_t*>(sK);
      if constexpr (Shape::QREG) {
        pt::mma::warp_mma_rbt_tf32x3<NT, DP, LD>(
            s,
            [&](int st, uint32_t(&ah)[4], uint32_t(&al)[4]) {
#pragma unroll
              for (int e = 0; e < 4; ++e) {
                ah[e] = qa[st][e];
                al[e] = qb[st][e];
              }
            },
            kh, lo);
      } else {
        const int mi = lane >> 3, r8 = lane & 7;
        const int qoff =
            (warp * 16 + (mi & 1) * 8 + r8) * LD + (mi >> 1) * 4;
        const uint32_t* pqh = sQ + qoff;
        const uint32_t* pql = sQ + BM * LD + qoff;
        pt::mma::warp_mma_rbt_tf32x3<NT, DP, LD>(
            s,
            [&](int st, uint32_t(&ah)[4], uint32_t(&al)[4]) {
              pt::mma::ldmatrix_x4(ah, pqh + st * 8);
              pt::mma::ldmatrix_x4(al, pql + st * 8);
            },
            kh, lo);
      }
    } else {
      pt::mma::warp_mma_rbt<NT, DP, LD>(
          s, qa, reinterpret_cast<const __nv_bfloat16*>(sK));
    }
    // the online softmax on the C fragments: e = 2 * hh + (column parity)
    float mx[2] = {-INFINITY, -INFINITY};
    if (bias_bh) {
#pragma unroll
      for (int n = 0; n < NT; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int r = rows[e >> 1], c = k0 + n * 8 + 2 * t + (e & 1);
          const int rr = r < S ? r : S - 1;   // rows past S are never written
          s[n][e] = c < S ? masked_score(s[n][e], scale, bias_bh, mask_b, rr,
                                         c, S, causal)
                          : -INFINITY;
          mx[e >> 1] = fmaxf(mx[e >> 1], s[n][e]);
        }
    } else {
      // only a tile that crosses this warp's diagonal needs the causal test
      const bool diag = causal && k0 + BN - 1 > q0 + warp * 16;
#pragma unroll
      for (int n = 0; n < NT; ++n)
#pragma unroll
        for (int par = 0; par < 2; ++par) {
          const int c = k0 + n * 8 + 2 * t + par;
#pragma unroll
          for (int hh = 0; hh < 2; ++hh) {
            const int e = 2 * hh + par;
            float x = s[n][e] * scale + col[n][par];
            // keys past S stay -inf: only real keys become NEG_INF (the
            // test of c inside the branch keeps the fast path's code)
            if (diag && c > rows[hh]) x = c < S ? kNegInf : -INFINITY;
            s[n][e] = x;
            mx[hh] = fmaxf(mx[hh], x);
          }
        }
    }
    float corr[2];
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      // a row's four lanes (t = 0..3) share its (m, l)
      mx[hh] = fmaxf(mx[hh], __shfl_xor_sync(0xffffffffu, mx[hh], 1));
      mx[hh] = fmaxf(mx[hh], __shfl_xor_sync(0xffffffffu, mx[hh], 2));
      const float m_new = fmaxf(m[hh], mx[hh]);
      corr[hh] = exp2f((m[hh] - m_new) * kLog2e);
      m[hh] = m_new;
      l[hh] *= corr[hh];
    }
#pragma unroll
    for (int n = 0; n < NT; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        // x - m first: a fully masked row (every x = m = NEG_INF) gives 1
        const float p = exp2f((s[n][e] - m[e >> 1]) * kLog2e);
        l[e >> 1] += p;   // from the unrounded p, in bf16 too
        s[n][e] = p;
      }
#pragma unroll
    for (int j = 0; j < OT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[j][e] *= corr[e >> 1];
    // P . V with P straight from the C fragments (bf16: rounded to bf16)
    if constexpr (F32) {
      pt::mma::warp_mma_pb_tf32x3<NT, OT, LD>(
          acc, s, reinterpret_cast<const uint32_t*>(sV), lo + BN * LD);
    } else {
      pt::mma::warp_mma_pb<NT, OT, LD>(
          acc, s, reinterpret_cast<const __nv_bfloat16*>(sV));
    }
  }
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    float lt = l[hh];
    lt += __shfl_xor_sync(0xffffffffu, lt, 1);
    lt += __shfl_xor_sync(0xffffffffu, lt, 2);
    const int r = rows[hh];
    if (r >= S) continue;
    const float inv = 1.f / lt;
    T* orow = o + base + static_cast<int64_t>(r) * D;
#pragma unroll
    for (int j = 0; j < OT; ++j) {
      const int c = j * 8 + 2 * t;
      const float x0 = acc[j][2 * hh] * inv, x1 = acc[j][2 * hh + 1] * inv;
      if (c + 1 < D && (D & 1) == 0) {   // an aligned pair: one store
        store_pair(orow + c, x0, x1);
      } else {
        if (c < D) orow[c] = pt::from_float<T>(x0);
        if (c + 1 < D) orow[c + 1] = pt::from_float<T>(x1);
      }
    }
    if (lse && t == 0) lse[static_cast<int64_t>(bh) * S + r] = m[hh] + logf(lt);
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

// cp.async needs D * sizeof(T) a multiple of 16 and 16-byte aligned slabs
template <typename T>
int vec_ok(int D, std::initializer_list<const void*> ptrs) {
  if ((D * sizeof(T)) % 16 != 0) return 0;
  for (const void* p : ptrs)
    if (reinterpret_cast<uintptr_t>(p) % 16 != 0) return 0;
  return 1;
}

template <typename T, int DP>
cudaError_t launch_fwd(const void* q, const void* k, const void* v,
                       const float* mask, const float* bias, void* o,
                       float* lse, int B, int H, int S, int D, int Bb, int Hb,
                       float scale, int causal, cudaStream_t st) {
  using Shape = FwdShape<T, DP>;
  constexpr int BM = 16 * Shape::WARPS;
  constexpr size_t smem = fwd_smem_bytes<T, DP>();
  auto kern = flash_fwd_kernel<T, DP>;
  cudaError_t err = allow_smem(kern, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((S + BM - 1) / BM, B * H);
  kern<<<grid, Shape::WARPS * 32, smem, st>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), mask, bias, static_cast<T*>(o), lse, H, S, D,
      Bb, Hb, scale, causal, vec_ok<T>(D, {q, k, v}));
  return cudaGetLastError();
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
      scale, causal, vec_ok<T>(D, {q, k, v, dout}));
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
      causal, vec_ok<T>(D, {q, k, v, dout}));
  return cudaGetLastError();
}

// the shapes by padded head dim (FwdShape, BwdShape)
#define PT_FLASH_DISPATCH(T, FN, ...)  \
  (D <= 64    ? FN<T, 64>(__VA_ARGS__)   \
   : D <= 128 ? FN<T, 128>(__VA_ARGS__)  \
   : D <= 256 ? FN<T, 256>(__VA_ARGS__)  \
              : cudaErrorInvalidValue)

#define PT_FLASH_BY_DTYPE(FN, ...)                                   \
  (dtype == pt::kFloat32 ? PT_FLASH_DISPATCH(float, FN, __VA_ARGS__) \
   : dtype == pt::kBFloat16                                          \
       ? PT_FLASH_DISPATCH(__nv_bfloat16, FN, __VA_ARGS__)           \
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
  return static_cast<int>(PT_FLASH_BY_DTYPE(
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
  return static_cast<int>(PT_FLASH_BY_DTYPE(
      launch_dkv, q, k, v, dout, static_cast<const float*>(lse),
      static_cast<const float*>(delta), static_cast<const float*>(mask),
      static_cast<const float*>(bias), dk, dv, B, H, S, D, Bb, Hb, scale,
      causal, st));
}
