// Shared helpers for the port's hand-written Hopper kernels.
//
// Every kernel of the library takes float32 or bfloat16 storage and
// accumulates in float32. The host entries (extern "C", bound with
// ctypes from Python) take a dtype code with the values below and
// return cudaGetLastError() after the launch, so a refused launch
// (too many threads, too much shared memory) surfaces in the wrapper.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace pt {

enum DType : int { kFloat32 = 0, kBFloat16 = 1 };

__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
__device__ __forceinline__ float to_float(int8_t v) {
  return static_cast<float>(v);
}

template <typename T>
__device__ __forceinline__ T from_float(float v);
template <>
__device__ __forceinline__ float from_float<float>(float v) {
  return v;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);
}

// Sum over the 32 lanes of a warp; every lane gets the total.
__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// Sum over the block; every thread gets the total. blockDim.x is a
// multiple of 32, at most 1024; shm holds 32 floats.
__device__ __forceinline__ float block_sum(float v, float* shm) {
  v = warp_sum(v);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int nwarps = blockDim.x >> 5;
  __syncthreads();  // shm may still be read by an earlier call
  if (lane == 0) shm[warp] = v;
  __syncthreads();
  float t = lane < nwarps ? shm[lane] : 0.f;
  return warp_sum(t);
}

// Dot products of a staged K row x with a float32 query row y, for the
// attention kernels' score-a-thread paths. vec: D is a multiple of 16
// bytes of x's type and both rows are 16-byte aligned; the sums run in
// four chains of fixed column classes, so the bits repeat.
__device__ __forceinline__ float dot_row(const float* x, const float* y,
                                         int D, int vec) {
  if (vec) {   // four chains of the column classes d % 4
    float s0 = 0.f, s1 = 0.f, s2 = 0.f, s3 = 0.f;
    for (int d = 0; d < D; d += 4) {
      const float4 a = *reinterpret_cast<const float4*>(x + d);
      const float4 b = *reinterpret_cast<const float4*>(y + d);
      s0 = fmaf(a.x, b.x, s0);
      s1 = fmaf(a.y, b.y, s1);
      s2 = fmaf(a.z, b.z, s2);
      s3 = fmaf(a.w, b.w, s3);
    }
    return (s0 + s1) + (s2 + s3);
  }
  float s = 0.f;
  for (int d = 0; d < D; ++d) s = fmaf(x[d], y[d], s);
  return s;
}
__device__ __forceinline__ float dot_row(const __nv_bfloat16* x,
                                         const float* y, int D, int vec) {
  if (vec) {   // four chains of the word classes (d / 2) % 4
    float s0 = 0.f, s1 = 0.f, s2 = 0.f, s3 = 0.f;
    for (int d = 0; d < D; d += 8) {
      const uint4 a = *reinterpret_cast<const uint4*>(x + d);
      const float4 b0 = *reinterpret_cast<const float4*>(y + d);
      const float4 b1 = *reinterpret_cast<const float4*>(y + d + 4);
      // bf16 bits to float32: the low half of a word shifted up, or its
      // high half (integer instructions only)
      s0 = fmaf(__uint_as_float(a.x << 16), b0.x, s0);
      s0 = fmaf(__uint_as_float(a.x & 0xffff0000u), b0.y, s0);
      s1 = fmaf(__uint_as_float(a.y << 16), b0.z, s1);
      s1 = fmaf(__uint_as_float(a.y & 0xffff0000u), b0.w, s1);
      s2 = fmaf(__uint_as_float(a.z << 16), b1.x, s2);
      s2 = fmaf(__uint_as_float(a.z & 0xffff0000u), b1.y, s2);
      s3 = fmaf(__uint_as_float(a.w << 16), b1.z, s3);
      s3 = fmaf(__uint_as_float(a.w & 0xffff0000u), b1.w, s3);
    }
    return (s0 + s1) + (s2 + s3);
  }
  float s = 0.f;
  for (int d = 0; d < D; ++d) s = fmaf(to_float(x[d]), y[d], s);
  return s;
}

// int8 byte i (0..3, lowest first) of a word, as float32
__device__ __forceinline__ float int8_at(uint32_t w, int i) {
  return static_cast<float>(static_cast<int>(w << (24 - 8 * i)) >> 24);
}

// An int8 row x whose elements dequantize to float(x[d]) * scale (the
// plain version's dequantization, bit for bit) dotted with y.
__device__ __forceinline__ float dot_row(const int8_t* x, float scale,
                                         const float* y, int D, int vec) {
  if (vec) {   // four chains of the word classes (d / 4) % 4
    float s[4] = {0.f, 0.f, 0.f, 0.f};
    for (int d = 0; d < D; d += 16) {
      const uint4 a = *reinterpret_cast<const uint4*>(x + d);
      const uint32_t w[4] = {a.x, a.y, a.z, a.w};
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const float4 b = *reinterpret_cast<const float4*>(y + d + 4 * k);
        s[k] = fmaf(int8_at(w[k], 0) * scale, b.x, s[k]);
        s[k] = fmaf(int8_at(w[k], 1) * scale, b.y, s[k]);
        s[k] = fmaf(int8_at(w[k], 2) * scale, b.z, s[k]);
        s[k] = fmaf(int8_at(w[k], 3) * scale, b.w, s[k]);
      }
    }
    return (s[0] + s[1]) + (s[2] + s[3]);
  }
  float t = 0.f;
  for (int d = 0; d < D; ++d) t = fmaf(to_float(x[d]) * scale, y[d], t);
  return t;
}

}  // namespace pt
