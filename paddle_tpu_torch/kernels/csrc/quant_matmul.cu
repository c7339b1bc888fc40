// Quantized weight matmul (K11) for Hopper (sm_90a).
//
// Replaces the Pallas kernel of paddle_tpu/kernels/quant_matmul.py
// (_quant_matmul_pallas :231, body _make_quant_mm_kernel :170; numerics
// oracle _reference_quant_matmul :157): out [M, N] = x [M, K] @
// dequant(W [K, N]) in float32, for three weight formats:
//   mode 0, int8        w = float(q) * scale[n]
//   mode 1, int8_block  w = float(q) * scale[k / block][n]
//   mode 2, fp8 e4m3    w = bf16(float(q) * float(bf16(scale[n]))),
//                       x rounded to bfloat16 too
//
// Bound. At the serving shape (M = 128 rows) a weight byte feeds 2 M =
// 256 flops, so on the FP32 units (67 TFLOP/s) the operations bound it
// far above the bytes. The bf16 tensor cores (989 TFLOP/s) move the
// bound back near the bytes: fp8 takes one bf16 product a weight, the
// int8 modes three (below), 989/3 TFLOP/s, which at M = 128 is about
// twice the time of reading the weight once.
//
// Design: quant_matmul_mma_kernel, bf16 mma.sync.m16n8k16 with float32
// accumulators. A block of 256 threads (8 warps, 4 x 2, each 32 x 64)
// owns a [128, 128] output tile and walks its share of K in steps of 32.
// Each step's weight bytes and x values (16 B and 64 B a thread, vector
// loads) are loaded into registers one step ahead, decoded there and
// stored as bf16 into the other half of a double-buffered shared-memory
// ring, from which ldmatrix feeds the fragments. (Copying the raw bytes
// with cp.async into a deeper ring first measured slower: the decode
// needs them in registers anyway.) Nothing but the int8 / e4m3 bytes and
// float32 x is read from device memory; no dequantized weight or rounded
// x exists there.
//   fp8: the decoded weight bf16(e4m3 * bf16(scale[n])) and bf16(x) are
//     the plain version's operands, so every product is exact in float32.
//   int8 / int8_block: |q| <= 127 is exact in bf16, and float32 x is
//     split into three bf16 terms hi = bf16(x), mid = bf16(x - hi), lo =
//     bf16(x - hi - mid) that sum to x exactly (a normal float32 has 24
//     significant bits, each term takes 8 and the rounding's sign one
//     more); the three products q*hi, q*mid, q*lo are exact in float32.
//     int8 scales the finished sum by scale[n], as the TPU kernel's
//     finish step does; int8_block keeps each block's partial sum in
//     registers and adds partial * scale[kb][n] into the accumulator
//     when the block ends (block a multiple of 16, the mma depth).
// So kernel and plain version differ by the order of the float32 sums
// and, in the int8 modes, by where the scale multiplies (after the sum
// here, on each weight in the plain version): one rounding more a
// product, within the same 2e-6 sqrt(K) max|out| tolerance.
//   Filling 132 SMs: N / 128 tiles are too few at ffn2 (16), so K is
//   split into `splits` ranges (a function of K and N only, chosen by the
//   wrapper), each block writing a float32 partial [splits, M, N] that
//   quant_matmul_reduce_kernel sums in split order (no atomics).
// Row independence: the tile shape, the split and every order of
// summation depend on K, N, mode and block, never on M: a row's result
// is the same bits whatever the other rows of the batch.
//
// quant_matmul_fma_kernel: int8_block whose block is not a multiple of
// 16 (the scale then changes inside an mma step). The earlier design, on
// the FP32 FMA units: [32, 64] tiles, each weight dequantized in registers exactly as
// the plain version, so it differs from it only by the order of the sum.
// The wrapper picks it from the block alone.

#include <stdint.h>

#include <algorithm>

#include "common.cuh"
#include "mma.cuh"

namespace {

using pt::mma::ldmatrix_x4;
using pt::mma::ldmatrix_x4_trans;
using pt::mma::mma_bf16;

// The staging below converts with integer and FADD instructions only:
// the F2F / I2F conversion instructions run at a quarter of the ALU rate
// on sm_90 and would bound the kernel.

__device__ __forceinline__ float e4m3_to_float(uint32_t u) {
  // s(1) e(4) m(3), bias 7; a subnormal (e = 0) is m * 2^-9 = (1 + m/8) *
  // 2^-6 - 2^-6, exact. The NaN codes 0x7f / 0xff are never written by
  // quantize_weight (values saturate)
  const uint32_t e = (u >> 3) & 0xF, m = u & 7;
  float mag = __uint_as_float(((e ? e : 1u) + 120u) << 23 | (m << 20));
  if (!e) mag -= 0.015625f;
  return (u & 0x80) ? -mag : mag;
}

// float(q) of the int8 byte k (0..3) of a word: 2^23 + (q + 128) built
// from bits, minus 2^23 + 128 (exact)
__device__ __forceinline__ float int8_to_float(uint32_t word, int k) {
  const uint32_t sel = 0x7440u | static_cast<uint32_t>(k);
  return __uint_as_float(__byte_perm(word ^ 0x80808080u, 0x4B000000u, sel)) -
         8388736.0f;
}

// bf16 round-to-nearest-even of a finite x, as float bits (low half 0)
__device__ __forceinline__ uint32_t bf16_rn_bits(float x) {
  const uint32_t u = __float_as_uint(x);
  return (u + 0x7FFFu + ((u >> 16) & 1u)) & 0xFFFF0000u;
}

// the bf16 pair (a's high half low, b's high half high)
__device__ __forceinline__ uint32_t pack_hi(uint32_t a, uint32_t b) {
  return __byte_perm(a, b, 0x7632);
}

__device__ __forceinline__ float round_bf16(float v) {
  return __bfloat162float(__float2bfloat16(v));
}

// ---------------------------------------------------------------------------
// the tensor-core kernel
// ---------------------------------------------------------------------------

constexpr int kBM = 128, kBN = 128, kBK = 32, kThreads = 256;
// 8 warps as 4 (rows) x 2 (columns), each [32, 64]: of the fragment
// loads from shared memory, which bound this kernel with the staging, a
// warp tile of [32, 64] needs fewer than [64, 32] when x has 3 terms
constexpr int kWM = 32, kWN = 64, kMT = kWM / 16, kNT = kWN / 8;
constexpr int kXLd = kBK + 8;   // bf16 row stride of an x tile (80 B)
constexpr int kWLd = kBN + 8;   // bf16 row stride of the weight tile (272 B)
constexpr int kXTile = kBM * kXLd;
constexpr int kStage = 3 * kXTile + kBK * kWLd;   // bf16 elements a stage
constexpr size_t kMmaSmem = 2 * kStage * sizeof(__nv_bfloat16);

template <int MODE>
__global__ void __launch_bounds__(kThreads, 1)
    quant_matmul_mma_kernel(const float* __restrict__ x,       // [M, K]
                            const uint8_t* __restrict__ w,     // [K, N]
                            const float* __restrict__ scales,  // [N] / [nb, N]
                            float* __restrict__ out,           // [M, N]
                            float* __restrict__ partial,  // [splits, M, N]
                            int M, int K, int N, int block, int k_split,
                            bool vec_x, bool vec_w) {
  constexpr int P = MODE == 2 ? 1 : 3;   // bf16 terms of x
  extern __shared__ __align__(16) __nv_bfloat16 qmm_smem[];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int wm = warp >> 1, wn = warp & 1;
  const int g = lane >> 2, t4 = lane & 3;
  const int mi = lane >> 3, r8 = lane & 7;
  const int n0 = blockIdx.x * kBN, m0 = blockIdx.y * kBM;
  const int kbeg = blockIdx.z * k_split;
  const int kend = min(K, kbeg + k_split);
  const int splits = gridDim.z;

  // staging: x row xr, columns xc..xc+15; weight row wr, bytes wc..wc+15
  const int xr = tid >> 1, xc = (tid & 1) * 16;
  const int wr = tid >> 3, wc = (tid & 7) * 16;
  float wscale[16];   // fp8: bf16(scale[n]) of the 16 staged columns
  if (MODE == 2) {
#pragma unroll
    for (int j = 0; j < 16; ++j) {
      const int n = n0 + wc + j;
      wscale[j] = n < N ? round_bf16(scales[n]) : 0.f;
    }
  }
  const int m = m0 + xr;
  const float* xrow = x + static_cast<int64_t>(m) * K;

  float xv[16];
  uint4 wraw;
  // the next tile's bytes into registers: 64 B of x, 16 B of the weight
  auto load = [&](int k0) {
#pragma unroll
    for (int j = 0; j < 16; j += 4) {
      const int k = k0 + xc + j;
      if (vec_x && m < M && k + 3 < kend) {
        const float4 v = *reinterpret_cast<const float4*>(xrow + k);
        xv[j] = v.x;
        xv[j + 1] = v.y;
        xv[j + 2] = v.z;
        xv[j + 3] = v.w;
      } else {
#pragma unroll
        for (int e = 0; e < 4; ++e)
          xv[j + e] = (m < M && k + e < kend) ? xrow[k + e] : 0.f;
      }
    }
    const int k = k0 + wr, nb = n0 + wc;
    const uint8_t* wrow = w + static_cast<int64_t>(k) * N;
    if (k < kend && vec_w && nb + 16 <= N) {
      wraw = *reinterpret_cast<const uint4*>(wrow + nb);
    } else {
      uint32_t b[4] = {0, 0, 0, 0};
#pragma unroll
      for (int j = 0; j < 16; ++j)
        if (k < kend && nb + j < N) b[j / 4] |= uint32_t(wrow[nb + j]) << (8 * (j % 4));
      wraw = make_uint4(b[0], b[1], b[2], b[3]);
    }
  };

  // registers -> bf16 operand stage: x split into P terms, the weight
  // decoded
  auto store = [&](int stage) {
    __nv_bfloat16* xs = qmm_smem + stage * kStage;
    __nv_bfloat16* ws = xs + 3 * kXTile;
    uint32_t part[3][8];
#pragma unroll
    for (int j = 0; j < 16; j += 2) {
      float r0 = xv[j], r1 = xv[j + 1];
#pragma unroll
      for (int p = 0; p < P; ++p) {
        const uint32_t h0 = bf16_rn_bits(r0), h1 = bf16_rn_bits(r1);
        part[p][j / 2] = pack_hi(h0, h1);
        r0 -= __uint_as_float(h0);
        r1 -= __uint_as_float(h1);
      }
    }
#pragma unroll
    for (int p = 0; p < P; ++p) {
      uint4* dst = reinterpret_cast<uint4*>(xs + p * kXTile + xr * kXLd + xc);
      dst[0] = make_uint4(part[p][0], part[p][1], part[p][2], part[p][3]);
      dst[1] = make_uint4(part[p][4], part[p][5], part[p][6], part[p][7]);
    }
    const uint32_t words[4] = {wraw.x, wraw.y, wraw.z, wraw.w};
    uint32_t wq[8];
#pragma unroll
    for (int j = 0; j < 16; j += 2) {
      const uint32_t word = words[j / 4];
      uint32_t b0, b1;
      if (MODE == 2) {
        b0 = bf16_rn_bits(e4m3_to_float((word >> (8 * (j % 4))) & 0xFF) *
                          wscale[j]);
        b1 = bf16_rn_bits(e4m3_to_float((word >> (8 * (j % 4 + 1))) & 0xFF) *
                          wscale[j + 1]);
      } else {   // |q| <= 127: float(q)'s bits are its bf16 bits
        b0 = __float_as_uint(int8_to_float(word, j % 4));
        b1 = __float_as_uint(int8_to_float(word, j % 4 + 1));
      }
      wq[j / 2] = pack_hi(b0, b1);
    }
    uint4* dst = reinterpret_cast<uint4*>(ws + wr * kWLd + wc);
    dst[0] = make_uint4(wq[0], wq[1], wq[2], wq[3]);
    dst[1] = make_uint4(wq[4], wq[5], wq[6], wq[7]);
  };

  float acc[kMT][kNT][4];
  float blk[kMT][kNT][4];   // int8_block: the current block's partial sum
#pragma unroll
  for (int i = 0; i < kMT; ++i)
#pragma unroll
    for (int j = 0; j < kNT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        acc[i][j][e] = 0.f;
        if (MODE == 1) blk[i][j][e] = 0.f;
      }

  // the products of operand stage it & 1; A fragments are loaded one step
  // ahead of the mma that reads them
  auto products = [&](int it) {
    const int k0 = kbeg + it * kBK;
    const __nv_bfloat16* xs = qmm_smem + (it & 1) * kStage;
    const __nv_bfloat16* ws = xs + 3 * kXTile;
#pragma unroll
    for (int ks = 0; ks < kBK; ks += 16) {
      uint32_t bf[kNT][2];
#pragma unroll
      for (int p = 0; p < kNT / 2; ++p) {
        uint32_t r[4];
        ldmatrix_x4_trans(r, ws + (ks + (mi & 1) * 8 + r8) * kWLd +
                                 wn * kWN + p * 16 + (mi >> 1) * 8);
        bf[2 * p][0] = r[0];
        bf[2 * p][1] = r[1];
        bf[2 * p + 1][0] = r[2];
        bf[2 * p + 1][1] = r[3];
      }
      // step s: row tile s / P, term P - 1 - s % P (lo, mid, hi)
      auto a_ptr = [&](int step) {
        const int i = step / P, p = P - 1 - step % P;
        return xs + p * kXTile +
               (wm * kWM + i * 16 + (mi & 1) * 8 + r8) * kXLd + ks +
               (mi >> 1) * 8;
      };
      uint32_t a[2][4];
      ldmatrix_x4(a[0], a_ptr(0));
#pragma unroll
      for (int step = 0; step < kMT * P; ++step) {
        if (step + 1 < kMT * P) ldmatrix_x4(a[(step + 1) & 1], a_ptr(step + 1));
        const int i = step / P;
#pragma unroll
        for (int j = 0; j < kNT; ++j) {
          if (MODE == 1)
            mma_bf16(blk[i][j], a[step & 1], bf[j][0], bf[j][1]);
          else
            mma_bf16(acc[i][j], a[step & 1], bf[j][0], bf[j][1]);
        }
      }
      if (MODE == 1) {
        const int kstep = k0 + ks;
        if (kstep < kend &&
            ((kstep + 16) % block == 0 || kstep + 16 >= kend)) {
          const float* srow = scales + static_cast<int64_t>(kstep / block) * N;
#pragma unroll
          for (int j = 0; j < kNT; ++j) {
            const int n = n0 + wn * kWN + j * 8 + 2 * t4;
            const float s0 = n < N ? srow[n] : 0.f;
            const float s1 = n + 1 < N ? srow[n + 1] : 0.f;
#pragma unroll
            for (int i = 0; i < kMT; ++i) {
              acc[i][j][0] = fmaf(blk[i][j][0], s0, acc[i][j][0]);
              acc[i][j][1] = fmaf(blk[i][j][1], s1, acc[i][j][1]);
              acc[i][j][2] = fmaf(blk[i][j][2], s0, acc[i][j][2]);
              acc[i][j][3] = fmaf(blk[i][j][3], s1, acc[i][j][3]);
#pragma unroll
              for (int e = 0; e < 4; ++e) blk[i][j][e] = 0.f;
            }
          }
        }
      }
    }
  };

  const int ntiles = (kend - kbeg + kBK - 1) / kBK;
  if (ntiles > 0) {
    load(kbeg);
    store(0);
  }
  __syncthreads();
  for (int it = 0; it < ntiles; ++it) {
    const bool more = it + 1 < ntiles;
    if (more) load(kbeg + (it + 1) * kBK);   // in flight during the products
    products(it);
    if (more) store((it + 1) & 1);   // that stage's products ended before
                                     // the last barrier
    __syncthreads();
  }

  // epilogue: the finished tile (int8: times scale[n]) or this split's
  // partial sum
  float* dst = splits == 1 ? out
                           : partial + static_cast<int64_t>(blockIdx.z) * M * N;
#pragma unroll
  for (int j = 0; j < kNT; ++j) {
    const int n = n0 + wn * kWN + j * 8 + 2 * t4;
    float s0 = 1.f, s1 = 1.f;
    if (MODE == 0 && splits == 1) {
      s0 = n < N ? scales[n] : 0.f;
      s1 = n + 1 < N ? scales[n + 1] : 0.f;
    }
#pragma unroll
    for (int i = 0; i < kMT; ++i) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int row = m0 + wm * kWM + i * 16 + g + 8 * h;
        if (row >= M) continue;
        float* o = dst + static_cast<int64_t>(row) * N;
        if (n < N) o[n] = acc[i][j][2 * h] * s0;
        if (n + 1 < N) o[n + 1] = acc[i][j][2 * h + 1] * s1;
      }
    }
  }
}

// out = sum over splits in split order (int8: times scale[n])
__global__ void __launch_bounds__(256)
    quant_matmul_reduce_kernel(const float* __restrict__ partial,
                               const float* __restrict__ scales,
                               float* __restrict__ out, int64_t MN, int N,
                               int splits, int mode) {
  for (int64_t i = blockIdx.x * int64_t(blockDim.x) + threadIdx.x; i < MN;
       i += int64_t(gridDim.x) * blockDim.x) {
    float v = partial[i];
    for (int s = 1; s < splits; ++s) v += partial[s * MN + i];
    if (mode == 0) v *= scales[i % N];
    out[i] = v;
  }
}

// ---------------------------------------------------------------------------
// the FMA kernel for int8_block with a block that is not a multiple of 16
// ---------------------------------------------------------------------------

constexpr int kFBM = 32, kFBN = 64, kFBK = 32, kFThreads = 128;

__global__ void __launch_bounds__(kFThreads)
    quant_matmul_fma_kernel(const float* __restrict__ x,       // [M, K]
                            const int8_t* __restrict__ w,      // [K, N]
                            const float* __restrict__ scales,  // [nb, N]
                            float* __restrict__ out,           // [M, N]
                            int M, int K, int N, int block, bool vec_w) {
  __shared__ float xs[kFBM][kFBK + 1];
  // rows padded by 4 floats: the staging stores of a warp spread over
  // the banks, and each row still starts 16-byte aligned
  __shared__ __align__(16) float ws[kFBK][kFBN + 4];

  const int tid = threadIdx.x;
  const int tx = tid % 16, ty = tid / 16;  // 16 column groups x 8 row groups
  const int m0 = blockIdx.y * kFBM, n0 = blockIdx.x * kFBN;
  const int wk = tid / 4, wc = (tid % 4) * 16;

  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;

  for (int k0 = 0; k0 < K; k0 += kFBK) {
#pragma unroll
    for (int i = 0; i < kFBM * kFBK / kFThreads; ++i) {
      const int e = tid + i * kFThreads;
      const int mm = e / kFBK, kk = e % kFBK;
      const int m = m0 + mm, k = k0 + kk;
      xs[mm][kk] = (m < M && k < K) ? x[int64_t(m) * K + k] : 0.f;
    }
    {
      const int k = k0 + wk;
      const int nb = n0 + wc;
      union {
        uint4 v;
        int8_t b[16];
      } raw;
      if (k < K && vec_w && nb + 16 <= N) {
        raw.v = *reinterpret_cast<const uint4*>(w + int64_t(k) * N + nb);
      } else {
#pragma unroll
        for (int j = 0; j < 16; ++j)
          raw.b[j] = (k < K && nb + j < N) ? w[int64_t(k) * N + nb + j] : 0;
      }
      const float* srow = scales + int64_t(k / block) * N;
#pragma unroll
      for (int j = 0; j < 16; ++j) {
        const int n = nb + j;
        ws[wk][wc + j] =
            (k < K && n < N) ? static_cast<float>(raw.b[j]) * srow[n] : 0.f;
      }
    }
    __syncthreads();
#pragma unroll 8
    for (int kk = 0; kk < kFBK; ++kk) {
      const float4 b = *reinterpret_cast<const float4*>(&ws[kk][tx * 4]);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float a = xs[ty * 4 + i][kk];
        acc[i][0] = fmaf(a, b.x, acc[i][0]);
        acc[i][1] = fmaf(a, b.y, acc[i][1]);
        acc[i][2] = fmaf(a, b.z, acc[i][2]);
        acc[i][3] = fmaf(a, b.w, acc[i][3]);
      }
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int m = m0 + ty * 4 + i;
    if (m >= M) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int n = n0 + tx * 4 + j;
      if (n < N) out[int64_t(m) * N + n] = acc[i][j];
    }
  }
}

template <int MODE>
cudaError_t launch_mma(const float* x, const uint8_t* w, const float* sc,
                       float* out, float* partial, int M, int K, int N,
                       int block, int splits, cudaStream_t s) {
  auto kern = quant_matmul_mma_kernel<MODE>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(kMmaSmem));
  if (err != cudaSuccess) return err;
  const int ktiles = (K + kBK - 1) / kBK;
  const int k_split = ((ktiles + splits - 1) / splits) * kBK;
  const bool vec_x =
      K % 4 == 0 && reinterpret_cast<uintptr_t>(x) % 16 == 0;
  const bool vec_w =
      N % 16 == 0 && reinterpret_cast<uintptr_t>(w) % 16 == 0;
  const dim3 grid((N + kBN - 1) / kBN, (M + kBM - 1) / kBM, splits);
  kern<<<grid, kThreads, kMmaSmem, s>>>(x, w, sc, out, partial, M, K, N,
                                        block, k_split, vec_x, vec_w);
  err = cudaGetLastError();
  if (err != cudaSuccess || splits == 1) return err;
  const int64_t MN = static_cast<int64_t>(M) * N;
  const int blocks = static_cast<int>(std::min<int64_t>((MN + 255) / 256, 2048));
  quant_matmul_reduce_kernel<<<blocks, 256, 0, s>>>(partial, sc, out, MN, N,
                                                    splits, MODE);
  return cudaGetLastError();
}

}  // namespace

// x: [M, K] float32; w: [K, N] int8 or e4m3 bytes; scales: float32 [N]
// (modes 0, 2) or [ceil(K / block), N] (mode 1, block a multiple of 16);
// out: [M, N] float32; partial: float32 [splits, M, N] when splits > 1
// (K is cut into `splits` equal ranges of whole 32-row steps), else
// unused. All contiguous.
extern "C" int pt_quant_matmul(const void* x, const void* w,
                               const void* scales, void* out, void* partial,
                               int M, int K, int N, int mode, int block,
                               int splits, void* stream) {
  if (M <= 0 || N <= 0) return 0;
  if (K <= 0 || mode < 0 || mode > 2 || splits < 1 ||
      (mode == 1 && (block <= 0 || block % 16 != 0)) ||
      (splits > 1 && partial == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* xf = static_cast<const float*>(x);
  const uint8_t* wb = static_cast<const uint8_t*>(w);
  const float* sc = static_cast<const float*>(scales);
  float* o = static_cast<float*>(out);
  float* pp = static_cast<float*>(partial);
  cudaError_t err;
  switch (mode) {
    case 0:
      err = launch_mma<0>(xf, wb, sc, o, pp, M, K, N, block, splits, s);
      break;
    case 1:
      err = launch_mma<1>(xf, wb, sc, o, pp, M, K, N, block, splits, s);
      break;
    default:
      err = launch_mma<2>(xf, wb, sc, o, pp, M, K, N, block, splits, s);
  }
  return static_cast<int>(err);
}

// int8_block with any block > 0 on the FMA units: x [M, K] float32, w
// [K, N] int8, scales [ceil(K / block), N], out [M, N].
extern "C" int pt_quant_matmul_fma(const void* x, const void* w,
                                   const void* scales, void* out, int M,
                                   int K, int N, int block, void* stream) {
  if (M <= 0 || N <= 0) return 0;
  if (K <= 0 || block <= 0) return static_cast<int>(cudaErrorInvalidValue);
  const bool vec_w =
      N % 16 == 0 && reinterpret_cast<uintptr_t>(w) % 16 == 0;
  const dim3 grid((N + kFBN - 1) / kFBN, (M + kFBM - 1) / kFBM);
  quant_matmul_fma_kernel<<<grid, kFThreads, 0,
                            static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<const int8_t*>(w),
      static_cast<const float*>(scales), static_cast<float*>(out), M, K, N,
      block, vec_w);
  return static_cast<int>(cudaGetLastError());
}
