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
// Design. 256 threads a block, as a 16 x 16 grid; tiles of BT = 64 query
// rows and 64 keys (32 for D > 128), each thread owning a 4 x 4 (2 x 2)
// piece of every score tile and 4 (2) rows x D/16 columns of every
// accumulator. Tiles are staged in shared memory as float32 with a row
// stride of D + 1, so the column-walking reads of the score product hit
// 32 different banks. The forward keeps the online softmax state (m, l)
// and the output accumulator in registers (:265-275); each thread keeps
// a partial l of its own columns, summed across its 16 row-mates once at
// the end. The backward is three kernels: delta (one warp a row), dq (a
// block per query tile walks the key tiles) and dk/dv (a block per key
// tile walks the query tiles). No float atomics: every output element is
// summed by one thread in a fixed order, so two runs give the same bits.
// A broadcast bias's gradient is reduced inside the dq kernel: a block
// owns (query tile, kept dims) and walks the broadcast dims in order,
// adding into the bias-shaped float32 buffer (zeroed by the wrapper), so
// no [B, H, S, S] intermediate exists.
// Causal: key tiles entirely above the diagonal are skipped (:247).
//
// Bound: forward 4 B H S^2 D flops (half when causal), backward 10 B H
// S^2 D (half when causal), plus the bytes of q, k, v, o, dO, dq, dk, dv
// and lse; at these shapes the flops bound it. This first kernel runs on
// the FP32 units (67 TFLOP/s peak); a tensor-core (wgmma, TMA) redesign
// is later work.

#include <math.h>

#include "common.cuh"

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
// backward 2: dq (and dbias), one block per (query tile, group); a group
// is one (b, h) when the bias is absent or full, else the kept dims of
// the bias, whose broadcast dims the block walks in order
// ---------------------------------------------------------------------------

template <typename T, int BT, int DMAX>
__global__ void __launch_bounds__(kThreads)
flash_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
                const T* __restrict__ v, const T* __restrict__ dout,
                const float* __restrict__ lse,
                const float* __restrict__ delta,
                const float* __restrict__ mask,
                const float* __restrict__ bias, T* __restrict__ dq,
                float* __restrict__ dbias, int H, int S, int D, int Bb,
                int Hb, int walk_b, int walk_h, int nb, float scale,
                int causal) {
  constexpr int R = BT / 16, RD = DMAX / 16;
  extern __shared__ float smem[];
  const int ld = ld_of(D);
  float* sQ = smem;              // [BT, ld]
  float* sdO = sQ + BT * ld;     // [BT, ld]
  float* sK = sdO + BT * ld;     // [BT, ld]
  float* sV = sK + BT * ld;      // [BT, ld]
  float* sdS = sV + BT * ld;     // [BT, BT + 1]
  const int qt = blockIdx.x, g = blockIdx.y;
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  const int q0 = qt * BT;
  const int nh_out = walk_h ? 1 : H, nh_in = walk_h ? H : 1;
  const int members = (walk_b ? nb : 1) * nh_in;
  const int nk = (S + BT - 1) / BT;
  const int kt_end = causal ? min(nk, qt + 1) : nk;
  for (int mem = 0; mem < members; ++mem) {
    const int b = g / nh_out + mem / nh_in;
    const int h = g - (g / nh_out) * nh_out + mem - (mem / nh_in) * nh_in;
    const int bh = b * H + h;
    const int64_t base = static_cast<int64_t>(bh) * S * D;
    const float* bias_bh = bias_slab(bias, b, h, Bb, Hb, S);
    float* dbias_bh = dbias ? dbias + (bias_bh - bias) : nullptr;
    const float* mask_b = mask ? mask + static_cast<int64_t>(b) * S : nullptr;
    __syncthreads();   // the last member's tiles are no longer read
    load_tile<T, BT>(sQ, q + base, q0, S, D);
    load_tile<T, BT>(sdO, dout + base, q0, S, D);
    float lse_r[R], delta_r[R], acc[R][RD];
#pragma unroll
    for (int i = 0; i < R; ++i) {
      const int r = q0 + ty + 16 * i;
      lse_r[i] = r < S ? lse[static_cast<int64_t>(bh) * S + r] : 0.f;
      delta_r[i] = r < S ? delta[static_cast<int64_t>(bh) * S + r] : 0.f;
#pragma unroll
      for (int j = 0; j < RD; ++j) acc[i][j] = 0.f;
    }
    for (int kt = 0; kt < kt_end; ++kt) {
      const int k0 = kt * BT;
      __syncthreads();   // the last tile's dq product is done with sK/sdS
      load_tile<T, BT>(sK, k + base, k0, S, D);
      load_tile<T, BT>(sV, v + base, k0, S, D);
      __syncthreads();
      float s[R][R], dp[R][R];
#pragma unroll
      for (int i = 0; i < R; ++i)
#pragma unroll
        for (int j = 0; j < R; ++j) s[i][j] = dp[i][j] = 0.f;
      for (int d = 0; d < D; ++d) {
        float a[R], gg[R], kk[R], vv[R];
#pragma unroll
        for (int i = 0; i < R; ++i) {
          a[i] = sQ[(ty + 16 * i) * ld + d];
          gg[i] = sdO[(ty + 16 * i) * ld + d];
        }
#pragma unroll
        for (int j = 0; j < R; ++j) {
          kk[j] = sK[(tx + 16 * j) * ld + d];
          vv[j] = sV[(tx + 16 * j) * ld + d];
        }
#pragma unroll
        for (int i = 0; i < R; ++i)
#pragma unroll
          for (int j = 0; j < R; ++j) {
            s[i][j] = fmaf(a[i], kk[j], s[i][j]);
            dp[i][j] = fmaf(gg[i], vv[j], dp[i][j]);
          }
      }
#pragma unroll
      for (int i = 0; i < R; ++i) {
        const int r = q0 + ty + 16 * i;
#pragma unroll
        for (int j = 0; j < R; ++j) {
          const int c = k0 + tx + 16 * j;
          float dl = 0.f;
          if (r < S && c < S) {
            const float x = masked_score(s[i][j], scale, bias_bh, mask_b, r,
                                         c, S, causal);
            const float p = expf(x - lse_r[i]);
            dl = p * (dp[i][j] - delta_r[i]);
            if (dbias_bh) dbias_bh[static_cast<int64_t>(r) * S + c] += dl;
          }
          sdS[(ty + 16 * i) * (BT + 1) + tx + 16 * j] = dl * scale;
        }
      }
      __syncthreads();
      for (int kk = 0; kk < BT; ++kk) {
        float kv[RD];
#pragma unroll
        for (int j = 0; j < RD; ++j) {
          const int c = tx + 16 * j;
          kv[j] = c < D ? sK[kk * ld + c] : 0.f;
        }
#pragma unroll
        for (int i = 0; i < R; ++i) {
          const float ds = sdS[(ty + 16 * i) * (BT + 1) + kk];
#pragma unroll
          for (int j = 0; j < RD; ++j) acc[i][j] = fmaf(ds, kv[j], acc[i][j]);
        }
      }
    }
#pragma unroll
    for (int i = 0; i < R; ++i) {
      const int r = q0 + ty + 16 * i;
      if (r >= S) continue;
#pragma unroll
      for (int j = 0; j < RD; ++j) {
        const int c = tx + 16 * j;
        if (c < D)
          dq[base + static_cast<int64_t>(r) * D + c] =
              pt::from_float<T>(acc[i][j]);
      }
    }
  }
}

// ---------------------------------------------------------------------------
// backward 3: dk, dv, one block per (key tile, b * H + h); the thread
// grid's rows are keys and its columns queries (s transposed)
// ---------------------------------------------------------------------------

template <typename T, int BT, int DMAX>
__global__ void __launch_bounds__(kThreads)
flash_dkv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, const T* __restrict__ dout,
                 const float* __restrict__ lse,
                 const float* __restrict__ delta,
                 const float* __restrict__ mask,
                 const float* __restrict__ bias, T* __restrict__ dk,
                 T* __restrict__ dv, int H, int S, int D, int Bb, int Hb,
                 float scale, int causal) {
  constexpr int R = BT / 16, RD = DMAX / 16;
  extern __shared__ float smem[];
  const int ld = ld_of(D);
  float* sK = smem;              // [BT, ld]
  float* sV = sK + BT * ld;      // [BT, ld]
  float* sQ = sV + BT * ld;      // [BT, ld]
  float* sdO = sQ + BT * ld;     // [BT, ld]
  float* sP = sdO + BT * ld;     // [BT keys, BT + 1]
  float* sdS = sP + BT * (BT + 1);
  const int kt = blockIdx.x, bh = blockIdx.y;
  const int b = bh / H, h = bh - b * H;
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  const int64_t base = static_cast<int64_t>(bh) * S * D;
  const int k0 = kt * BT;
  const float* bias_bh = bias_slab(bias, b, h, Bb, Hb, S);
  const float* mask_b = mask ? mask + static_cast<int64_t>(b) * S : nullptr;

  load_tile<T, BT>(sK, k + base, k0, S, D);
  load_tile<T, BT>(sV, v + base, k0, S, D);
  float dka[R][RD], dva[R][RD];
#pragma unroll
  for (int i = 0; i < R; ++i)
#pragma unroll
    for (int j = 0; j < RD; ++j) dka[i][j] = dva[i][j] = 0.f;
  const int nq = (S + BT - 1) / BT;
  for (int qt = causal ? kt : 0; qt < nq; ++qt) {
    const int q0 = qt * BT;
    __syncthreads();   // the last tile's products are done with sQ, sP
    load_tile<T, BT>(sQ, q + base, q0, S, D);
    load_tile<T, BT>(sdO, dout + base, q0, S, D);
    __syncthreads();
    float st[R][R], dpt[R][R];
#pragma unroll
    for (int i = 0; i < R; ++i)
#pragma unroll
      for (int j = 0; j < R; ++j) st[i][j] = dpt[i][j] = 0.f;
    for (int d = 0; d < D; ++d) {
      float kk[R], vv[R], a[R], gg[R];
#pragma unroll
      for (int i = 0; i < R; ++i) {
        kk[i] = sK[(ty + 16 * i) * ld + d];
        vv[i] = sV[(ty + 16 * i) * ld + d];
      }
#pragma unroll
      for (int j = 0; j < R; ++j) {
        a[j] = sQ[(tx + 16 * j) * ld + d];
        gg[j] = sdO[(tx + 16 * j) * ld + d];
      }
#pragma unroll
      for (int i = 0; i < R; ++i)
#pragma unroll
        for (int j = 0; j < R; ++j) {
          st[i][j] = fmaf(kk[i], a[j], st[i][j]);
          dpt[i][j] = fmaf(vv[i], gg[j], dpt[i][j]);
        }
    }
#pragma unroll
    for (int j = 0; j < R; ++j) {
      const int r = q0 + tx + 16 * j;   // query
      const float lse_r =
          r < S ? lse[static_cast<int64_t>(bh) * S + r] : 0.f;
      const float delta_r =
          r < S ? delta[static_cast<int64_t>(bh) * S + r] : 0.f;
#pragma unroll
      for (int i = 0; i < R; ++i) {
        const int c = k0 + ty + 16 * i;   // key
        float p = 0.f, ds = 0.f;
        if (r < S && c < S) {
          const float x = masked_score(st[i][j], scale, bias_bh, mask_b, r,
                                       c, S, causal);
          p = expf(x - lse_r);
          ds = p * (dpt[i][j] - delta_r) * scale;
        }
        sP[(ty + 16 * i) * (BT + 1) + tx + 16 * j] = p;
        sdS[(ty + 16 * i) * (BT + 1) + tx + 16 * j] = ds;
      }
    }
    __syncthreads();
    for (int qq = 0; qq < BT; ++qq) {
      float go[RD], qv[RD];
#pragma unroll
      for (int j = 0; j < RD; ++j) {
        const int c = tx + 16 * j;
        go[j] = c < D ? sdO[qq * ld + c] : 0.f;
        qv[j] = c < D ? sQ[qq * ld + c] : 0.f;
      }
#pragma unroll
      for (int i = 0; i < R; ++i) {
        const float p = sP[(ty + 16 * i) * (BT + 1) + qq];
        const float ds = sdS[(ty + 16 * i) * (BT + 1) + qq];
#pragma unroll
        for (int j = 0; j < RD; ++j) {
          dva[i][j] = fmaf(p, go[j], dva[i][j]);
          dka[i][j] = fmaf(ds, qv[j], dka[i][j]);
        }
      }
    }
  }
#pragma unroll
  for (int i = 0; i < R; ++i) {
    const int r = k0 + ty + 16 * i;
    if (r >= S) continue;
#pragma unroll
    for (int j = 0; j < RD; ++j) {
      const int c = tx + 16 * j;
      if (c < D) {
        dk[base + static_cast<int64_t>(r) * D + c] =
            pt::from_float<T>(dka[i][j]);
        dv[base + static_cast<int64_t>(r) * D + c] =
            pt::from_float<T>(dva[i][j]);
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

template <typename T, int BT, int DMAX>
cudaError_t launch_dq(const void* q, const void* k, const void* v,
                      const void* dout, const float* lse, const float* delta,
                      const float* mask, const float* bias, void* dq,
                      float* dbias, int B, int H, int S, int D, int Bb, int Hb,
                      float scale, int causal, cudaStream_t st) {
  const size_t smem = sizeof(float) * (4 * BT * ld_of(D) + BT * (BT + 1));
  auto kern = flash_dq_kernel<T, BT, DMAX>;
  cudaError_t err = allow_smem(kern, smem);
  if (err != cudaSuccess) return err;
  // a broadcast bias dim is walked inside the block (dbias reduced in a
  // fixed order); otherwise every (b, h) is its own block
  const int walk_b = (bias && Bb == 1 && B > 1) ? 1 : 0;
  const int walk_h = (bias && Hb == 1 && H > 1) ? 1 : 0;
  const int groups = (walk_b ? 1 : B) * (walk_h ? 1 : H);
  const dim3 grid((S + BT - 1) / BT, groups);
  kern<<<grid, kThreads, smem, st>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const T*>(dout), lse, delta, mask,
      bias, static_cast<T*>(dq), dbias, H, S, D, Bb, Hb, walk_b, walk_h, B,
      scale, causal);
  return cudaGetLastError();
}

template <typename T, int BT, int DMAX>
cudaError_t launch_dkv(const void* q, const void* k, const void* v,
                       const void* dout, const float* lse,
                       const float* delta, const float* mask,
                       const float* bias, void* dk, void* dv, int B, int H,
                       int S, int D, int Bb, int Hb, float scale, int causal,
                       cudaStream_t st) {
  const size_t smem =
      sizeof(float) * (4 * BT * ld_of(D) + 2 * BT * (BT + 1));
  auto kern = flash_dkv_kernel<T, BT, DMAX>;
  cudaError_t err = allow_smem(kern, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((S + BT - 1) / BT, B * H);
  kern<<<grid, kThreads, smem, st>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const T*>(dout), lse, delta, mask,
      bias, static_cast<T*>(dk), static_cast<T*>(dv), H, S, D, Bb, Hb, scale,
      causal);
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
