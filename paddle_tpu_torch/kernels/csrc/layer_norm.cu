// Layer-norm forward over [R, C] rows, for Hopper (sm_90a).
//
// Replaces the Pallas kernel of paddle_tpu/kernels/layer_norm.py
// (_fwd_impl, pallas_call at :124): y = (x - mean) * rstd * gamma + beta
// per row, population variance, rstd = rsqrt(var + eps), accumulation in
// float32, y in x's dtype. Only y is produced: the serving path reads
// neither the mean nor the rstd (the TPU kernel's lane-replicated
// [R, 128] stats are a Mosaic layout rule and are not carried over).
//
// Bound: memory. The least traffic is one read of x and one write of y
// (2 * R * C * itemsize bytes) plus gamma and beta. The design reads each
// row three times (mean pass, variance pass, output pass); the two
// re-reads of a row of at most a few tens of KB hit L1/L2, not HBM.
// One block per row, the block loops over the row, so there is no cap
// on C (the TPU's MAX_C = 4096 VMEM bound does not apply). At the
// serving slice's [128, 2048] the work is ~2 MB and the launch, not the
// bytes, sets the time.

#include "common.cuh"

namespace {

// Sum over the block; every thread gets the total. blockDim.x is a
// multiple of 32, at most 1024.
__device__ float block_sum(float v, float* shm) {
  v = pt::warp_sum(v);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int nwarps = blockDim.x >> 5;
  __syncthreads();  // shm may still be read by an earlier call
  if (lane == 0) shm[warp] = v;
  __syncthreads();
  float t = lane < nwarps ? shm[lane] : 0.f;
  return pt::warp_sum(t);
}

template <typename T>
__global__ void layer_norm_fwd_kernel(const T* __restrict__ x,
                                      const T* __restrict__ gamma,
                                      const T* __restrict__ beta,
                                      T* __restrict__ y, int C, float eps) {
  __shared__ float shm[32];
  const int64_t row = blockIdx.x;
  const T* xr = x + row * C;
  T* yr = y + row * C;
  const float inv_c = 1.f / static_cast<float>(C);

  float s = 0.f;
  for (int c = threadIdx.x; c < C; c += blockDim.x) s += pt::to_float(xr[c]);
  const float mean = block_sum(s, shm) * inv_c;

  float v = 0.f;
  for (int c = threadIdx.x; c < C; c += blockDim.x) {
    const float d = pt::to_float(xr[c]) - mean;
    v += d * d;
  }
  const float var = block_sum(v, shm) * inv_c;
  const float rstd = rsqrtf(var + eps);

  for (int c = threadIdx.x; c < C; c += blockDim.x) {
    const float xh = (pt::to_float(xr[c]) - mean) * rstd;
    yr[c] = pt::from_float<T>(xh * pt::to_float(gamma[c]) +
                              pt::to_float(beta[c]));
  }
}

}  // namespace

// x, y: [R, C] contiguous; gamma, beta: [C]; all of one dtype.
extern "C" int pt_layer_norm_fwd(const void* x, const void* gamma,
                                 const void* beta, void* y, int R, int C,
                                 float eps, int dtype, void* stream) {
  if (R <= 0 || C <= 0) return 0;
  // about 8 elements a thread, 32..1024 threads, whole warps
  int threads = ((C + 7) / 8 + 31) / 32 * 32;
  threads = threads < 32 ? 32 : (threads > 1024 ? 1024 : threads);
  const dim3 grid(R);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case pt::kFloat32:
      layer_norm_fwd_kernel<float><<<grid, threads, 0, s>>>(
          static_cast<const float*>(x), static_cast<const float*>(gamma),
          static_cast<const float*>(beta), static_cast<float*>(y), C, eps);
      break;
    case pt::kBFloat16:
      layer_norm_fwd_kernel<__nv_bfloat16><<<grid, threads, 0, s>>>(
          static_cast<const __nv_bfloat16*>(x),
          static_cast<const __nv_bfloat16*>(gamma),
          static_cast<const __nv_bfloat16*>(beta),
          static_cast<__nv_bfloat16*>(y), C, eps);
      break;
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
