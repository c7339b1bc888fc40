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

}  // namespace pt
