// Layer norm over [R, C] rows, forward (K1) and backward (K3), for
// Hopper (sm_90a).
//
// K1 replaces the Pallas kernel of paddle_tpu/kernels/layer_norm.py
// (_fwd_impl, pallas_call at :124): y = (x - mean) * rstd * gamma + beta
// per row, population variance, rstd = rsqrt(var + eps), accumulation in
// float32, y in x's dtype. The per-row mean and rstd (float32 [R]) are
// written when the caller passes buffers for them: the backward needs
// them, the serving path does not (the TPU kernel's lane-replicated
// [R, 128] stats are a Mosaic layout rule and are not carried over).
//
// K3 replaces _vjp_bwd (:155, pallas_call at :164):
//   dx = rstd * (dy*g - mean(dy*g) - xhat * mean(dy*g*xhat))
//   dgamma = sum_rows(dy * xhat), dbeta = sum_rows(dy)
//
// Bound: memory. K1 must move x in and y out (2 * R * C * itemsize) plus
// gamma and beta; K3 x and dy in and dx out (3 * R * C * itemsize) plus
// gamma, the stats and dgamma/dbeta. K1 reads each row three times
// (mean, variance, output passes) and K3 twice; the re-reads of a row of
// a few tens of KB hit L1/L2, not HBM. One block per row, the block
// loops over the row, so there is no cap on C in K1 (the TPU's
// MAX_C = 4096 VMEM bound does not apply).
//
// dgamma/dbeta are sums across rows, a reduction across blocks. Blocks
// run in no order, and float atomics would make the sum change from run
// to run, so K3 is two deterministic passes: kLnBwdBlocks blocks each
// take a contiguous run of rows, write dx for them and keep their share
// of the column sums in shared memory (each thread owns its columns, no
// sync needed); each block writes its partial row to a [G, C] scratch;
// a second kernel sums the G partials of each column in a fixed order.

#include "common.cuh"

namespace {

constexpr int kLnBwdBlocks = 512;   // G: partial rows of the column sums

int ln_bwd_blocks(int R) { return R < kLnBwdBlocks ? R : kLnBwdBlocks; }

int row_threads(int C) {
  // about 8 elements a thread, 32..1024 threads, whole warps
  int threads = ((C + 7) / 8 + 31) / 32 * 32;
  return threads < 32 ? 32 : (threads > 1024 ? 1024 : threads);
}

template <typename T>
__global__ void layer_norm_fwd_kernel(const T* __restrict__ x,
                                      const T* __restrict__ gamma,
                                      const T* __restrict__ beta,
                                      T* __restrict__ y,
                                      float* __restrict__ mean_out,
                                      float* __restrict__ rstd_out, int C,
                                      float eps) {
  __shared__ float shm[32];
  const int64_t row = blockIdx.x;
  const T* xr = x + row * C;
  T* yr = y + row * C;
  const float inv_c = 1.f / static_cast<float>(C);

  float s = 0.f;
  for (int c = threadIdx.x; c < C; c += blockDim.x) s += pt::to_float(xr[c]);
  const float mean = pt::block_sum(s, shm) * inv_c;

  float v = 0.f;
  for (int c = threadIdx.x; c < C; c += blockDim.x) {
    const float d = pt::to_float(xr[c]) - mean;
    v += d * d;
  }
  const float var = pt::block_sum(v, shm) * inv_c;
  const float rstd = rsqrtf(var + eps);

  for (int c = threadIdx.x; c < C; c += blockDim.x) {
    const float xh = (pt::to_float(xr[c]) - mean) * rstd;
    yr[c] = pt::from_float<T>(xh * pt::to_float(gamma[c]) +
                              pt::to_float(beta[c]));
  }
  if (threadIdx.x == 0 && mean_out != nullptr) {
    mean_out[row] = mean;
    rstd_out[row] = rstd;
  }
}

// Block b takes rows [b * rows_per_block, ...). Shared memory: dgamma
// and dbeta partials, 2 * C floats.
template <typename T>
__global__ void layer_norm_bwd_kernel(const T* __restrict__ x,
                                      const T* __restrict__ gamma,
                                      const T* __restrict__ dy,
                                      const float* __restrict__ mean,
                                      const float* __restrict__ rstd,
                                      T* __restrict__ dx,
                                      float* __restrict__ dg_part,
                                      float* __restrict__ db_part, int R,
                                      int C, int rows_per_block) {
  extern __shared__ float acc[];   // [2, C]: dgamma, dbeta
  __shared__ float shm[32];
  float* dg = acc;
  float* db = acc + C;
  for (int c = threadIdx.x; c < C; c += blockDim.x) {
    dg[c] = 0.f;
    db[c] = 0.f;
  }
  const float inv_c = 1.f / static_cast<float>(C);
  const int64_t r0 = static_cast<int64_t>(blockIdx.x) * rows_per_block;
  const int64_t r1 = min(r0 + rows_per_block, static_cast<int64_t>(R));
  for (int64_t row = r0; row < r1; ++row) {
    const T* xr = x + row * C;
    const T* dyr = dy + row * C;
    T* dxr = dx + row * C;
    const float mu = mean[row], rs = rstd[row];
    float s1 = 0.f, s2 = 0.f;
    for (int c = threadIdx.x; c < C; c += blockDim.x) {
      const float xh = (pt::to_float(xr[c]) - mu) * rs;
      const float dyg = pt::to_float(dyr[c]) * pt::to_float(gamma[c]);
      s1 += dyg;
      s2 += dyg * xh;
    }
    const float m1 = pt::block_sum(s1, shm) * inv_c;
    const float m2 = pt::block_sum(s2, shm) * inv_c;
    for (int c = threadIdx.x; c < C; c += blockDim.x) {
      const float xh = (pt::to_float(xr[c]) - mu) * rs;
      const float d = pt::to_float(dyr[c]);
      const float dyg = d * pt::to_float(gamma[c]);
      dxr[c] = pt::from_float<T>(rs * (dyg - m1 - xh * m2));
      dg[c] += d * xh;
      db[c] += d;
    }
  }
  float* dgo = dg_part + static_cast<int64_t>(blockIdx.x) * C;
  float* dbo = db_part + static_cast<int64_t>(blockIdx.x) * C;
  for (int c = threadIdx.x; c < C; c += blockDim.x) {
    dgo[c] = dg[c];
    dbo[c] = db[c];
  }
}

// One thread per column: sums the G partial rows in order.
template <typename T>
__global__ void column_sum_kernel(const float* __restrict__ dg_part,
                                  const float* __restrict__ db_part,
                                  T* __restrict__ dgamma,
                                  T* __restrict__ dbeta, int G, int C) {
  const int c = blockIdx.x * blockDim.x + threadIdx.x;
  if (c >= C) return;
  float sg = 0.f, sb = 0.f;
  for (int g = 0; g < G; ++g) {
    sg += dg_part[static_cast<int64_t>(g) * C + c];
    sb += db_part[static_cast<int64_t>(g) * C + c];
  }
  dgamma[c] = pt::from_float<T>(sg);
  dbeta[c] = pt::from_float<T>(sb);
}

template <typename T>
int launch_bwd(const void* x, const void* gamma, const void* dy,
               const float* mean, const float* rstd, void* dx,
               float* scratch, void* dgamma, void* dbeta, int R, int C,
               cudaStream_t s) {
  const int G = ln_bwd_blocks(R);
  const int rows_per_block = (R + G - 1) / G;
  const size_t smem = 2 * static_cast<size_t>(C) * sizeof(float);
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        layer_norm_bwd_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  float* dg_part = scratch;
  float* db_part = scratch + static_cast<int64_t>(G) * C;
  layer_norm_bwd_kernel<T><<<G, row_threads(C), smem, s>>>(
      static_cast<const T*>(x), static_cast<const T*>(gamma),
      static_cast<const T*>(dy), mean, rstd, static_cast<T*>(dx), dg_part,
      db_part, R, C, rows_per_block);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  column_sum_kernel<T><<<(C + 255) / 256, 256, 0, s>>>(
      dg_part, db_part, static_cast<T*>(dgamma), static_cast<T*>(dbeta), G,
      C);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// x, y: [R, C] contiguous; gamma, beta: [C]; all of one dtype. mean and
// rstd: float32 [R], or both null (not written).
extern "C" int pt_layer_norm_fwd(const void* x, const void* gamma,
                                 const void* beta, void* y, void* mean,
                                 void* rstd, int R, int C, float eps,
                                 int dtype, void* stream) {
  if (R <= 0 || C <= 0) return 0;
  const dim3 grid(R);
  const int threads = row_threads(C);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* m = static_cast<float*>(mean);
  float* r = static_cast<float*>(rstd);
  switch (dtype) {
    case pt::kFloat32:
      layer_norm_fwd_kernel<float><<<grid, threads, 0, s>>>(
          static_cast<const float*>(x), static_cast<const float*>(gamma),
          static_cast<const float*>(beta), static_cast<float*>(y), m, r, C,
          eps);
      break;
    case pt::kBFloat16:
      layer_norm_fwd_kernel<__nv_bfloat16><<<grid, threads, 0, s>>>(
          static_cast<const __nv_bfloat16*>(x),
          static_cast<const __nv_bfloat16*>(gamma),
          static_cast<const __nv_bfloat16*>(beta),
          static_cast<__nv_bfloat16*>(y), m, r, C, eps);
      break;
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

// Rows of scratch the backward needs (float32 [2 * G, C]).
extern "C" int pt_layer_norm_bwd_scratch_rows(int R) {
  return 2 * ln_bwd_blocks(R);
}

// x, dy, dx: [R, C]; gamma, dgamma, dbeta: [C]; all of one dtype. mean,
// rstd: float32 [R] from the forward. scratch: float32
// [pt_layer_norm_bwd_scratch_rows(R), C].
extern "C" int pt_layer_norm_bwd(const void* x, const void* gamma,
                                 const void* dy, const void* mean,
                                 const void* rstd, void* dx, void* scratch,
                                 void* dgamma, void* dbeta, int R, int C,
                                 int dtype, void* stream) {
  if (R <= 0 || C <= 0) return 0;
  if (2 * static_cast<size_t>(C) * sizeof(float) > 227 * 1024)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* m = static_cast<const float*>(mean);
  const float* r = static_cast<const float*>(rstd);
  float* sc = static_cast<float*>(scratch);
  switch (dtype) {
    case pt::kFloat32:
      return launch_bwd<float>(x, gamma, dy, m, r, dx, sc, dgamma, dbeta, R,
                               C, s);
    case pt::kBFloat16:
      return launch_bwd<__nv_bfloat16>(x, gamma, dy, m, r, dx, sc, dgamma,
                                       dbeta, R, C, s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
