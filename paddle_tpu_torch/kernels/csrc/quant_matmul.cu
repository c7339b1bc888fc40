// Quantized weight matmul (K11) for Hopper (sm_90a).
//
// Replaces the Pallas kernel of paddle_tpu/kernels/quant_matmul.py
// (_quant_matmul_pallas :231, body _make_quant_mm_kernel :170; numerics
// oracle _reference_quant_matmul :157): out [M, N] = x [M, K] @
// dequant(W [K, N]) in float32, for three weight formats:
//   mode 0, int8        w = float(q) * scale[n]
//   mode 1, int8_block  w = float(q) * scale[k / block][n]  (any block,
//                       K need not be a multiple of it)
//   mode 2, fp8 e4m3    w = bf16(float(q) * float(bf16(scale[n]))),
//                       x rounded to bfloat16 too; the products of two
//                       bfloat16 values are exact in float32
//
// Design. A tiled GEMM on the float32 FMA units: a block owns a
// [BM = 32, BN = 64] output tile and walks K in steps of BK = 32. Each
// step stages the x tile (float32) and the weight tile into shared
// memory: the weight is read from device memory at 1 byte an element
// (16 bytes a thread where the row is aligned), dequantized in
// registers exactly as the plain version does it (same products, same
// rounding) and stored as float32. The float32 weight never exists in
// device memory. A thread accumulates a 4 x 4 sub-tile in registers.
// So kernel and plain version differ only by the order of the float32
// sum over K. The tile shape is fixed: a row's result never depends on
// M or on the other rows of the batch.
//
// Bound. At the serving shape (M = 128) the FMA units: 2 * M flops a
// weight byte is far above the card's 20 flops a byte of float32 peak
// over memory rate. This first kernel keeps to the FMA units for all
// three modes; fp8 (bfloat16 operands, exact products) could move to
// the tensor cores with mma.sync/wgmma, and int8 could keep x in
// registers across more columns. Both are later work.

#include <stdint.h>

#include "common.cuh"

namespace {

constexpr int kBM = 32, kBN = 64, kBK = 32, kThreads = 128;

__device__ __forceinline__ float e4m3_to_float(uint32_t u) {
  // s(1) e(4) m(3), bias 7, subnormals at e = 0; the NaN codes 0x7f /
  // 0xff are never written by quantize_weight (values saturate at 448)
  const int e = (u >> 3) & 0xF, m = u & 7;
  const float mag = e ? ldexpf(1.f + 0.125f * m, e - 7)
                      : ldexpf(0.125f * m, -6);
  return (u & 0x80) ? -mag : mag;
}

__device__ __forceinline__ float round_bf16(float v) {
  return __bfloat162float(__float2bfloat16(v));
}

template <int MODE>
__device__ __forceinline__ float dequant(uint32_t byte, const float* scales,
                                         int k, int n, int N, int block) {
  if (MODE == 2) {
    return round_bf16(e4m3_to_float(byte) * round_bf16(scales[n]));
  }
  const float q = static_cast<float>(static_cast<int8_t>(byte));
  if (MODE == 1) return q * scales[int64_t(k / block) * N + n];
  return q * scales[n];
}

template <int MODE>
__global__ void __launch_bounds__(kThreads)
    quant_matmul_kernel(const float* __restrict__ x,       // [M, K]
                        const uint8_t* __restrict__ w,     // [K, N]
                        const float* __restrict__ scales,  // [N] / [nb, N]
                        float* __restrict__ out,           // [M, N]
                        int M, int K, int N, int block, bool vec_w) {
  __shared__ float xs[kBM][kBK + 1];
  // rows padded by 4 floats: the staging stores of a warp spread over
  // the banks, and each row still starts 16-byte aligned
  __shared__ __align__(16) float ws[kBK][kBN + 4];

  const int tid = threadIdx.x;
  const int tx = tid % 16, ty = tid / 16;  // 16 column groups x 8 row groups
  const int m0 = blockIdx.y * kBM, n0 = blockIdx.x * kBN;
  // weight staging: row wk of the tile, 16 columns from wc
  const int wk = tid / 4, wc = (tid % 4) * 16;

  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;

  for (int k0 = 0; k0 < K; k0 += kBK) {
    // x tile: [kBM, kBK], consecutive threads on consecutive k
#pragma unroll
    for (int i = 0; i < kBM * kBK / kThreads; ++i) {
      const int e = tid + i * kThreads;
      const int mm = e / kBK, kk = e % kBK;
      const int m = m0 + mm, k = k0 + kk;
      float v = (m < M && k < K) ? x[int64_t(m) * K + k] : 0.f;
      if (MODE == 2) v = round_bf16(v);
      xs[mm][kk] = v;
    }
    // weight tile: 16 bytes a thread, dequantized in registers
    {
      const int k = k0 + wk;
      const int nb = n0 + wc;
      union {
        uint4 v;
        uint8_t b[16];
      } raw;
      if (k < K && vec_w && nb + 16 <= N) {
        raw.v = *reinterpret_cast<const uint4*>(w + int64_t(k) * N + nb);
      } else {
#pragma unroll
        for (int j = 0; j < 16; ++j)
          raw.b[j] = (k < K && nb + j < N) ? w[int64_t(k) * N + nb + j] : 0;
      }
#pragma unroll
      for (int j = 0; j < 16; ++j) {
        const int n = nb + j;
        ws[wk][wc + j] = (k < K && n < N)
                             ? dequant<MODE>(raw.b[j], scales, k, n, N, block)
                             : 0.f;
      }
    }
    __syncthreads();
#pragma unroll 8
    for (int kk = 0; kk < kBK; ++kk) {
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

}  // namespace

// x: [M, K] float32; w: [K, N] int8 or e4m3 bytes; scales: float32 [N]
// (modes 0, 2) or [ceil(K / block), N] (mode 1); out: [M, N] float32.
// All contiguous.
extern "C" int pt_quant_matmul(const void* x, const void* w,
                               const void* scales, void* out, int M, int K,
                               int N, int mode, int block, void* stream) {
  if (M <= 0 || N <= 0) return 0;
  if (K <= 0 || mode < 0 || mode > 2 || (mode == 1 && block <= 0))
    return static_cast<int>(cudaErrorInvalidValue);
  const bool vec_w =
      N % 16 == 0 && reinterpret_cast<uintptr_t>(w) % 16 == 0;
  const dim3 grid((N + kBN - 1) / kBN, (M + kBM - 1) / kBM);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* xf = static_cast<const float*>(x);
  const uint8_t* wb = static_cast<const uint8_t*>(w);
  const float* sc = static_cast<const float*>(scales);
  float* o = static_cast<float*>(out);
  switch (mode) {
    case 0:
      quant_matmul_kernel<0><<<grid, kThreads, 0, s>>>(xf, wb, sc, o, M, K,
                                                       N, block, vec_w);
      break;
    case 1:
      quant_matmul_kernel<1><<<grid, kThreads, 0, s>>>(xf, wb, sc, o, M, K,
                                                       N, block, vec_w);
      break;
    default:
      quant_matmul_kernel<2><<<grid, kThreads, 0, s>>>(xf, wb, sc, o, M, K,
                                                       N, block, vec_w);
  }
  return static_cast<int>(cudaGetLastError());
}
