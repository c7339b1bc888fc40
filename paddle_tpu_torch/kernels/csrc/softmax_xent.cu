// Softmax cross-entropy over [R, C] logits with hard int64 labels,
// forward (K4) and backward (K5), for Hopper (sm_90a).
//
// K4 replaces the Pallas kernel of paddle_tpu/kernels/softmax_xent.py
// (_fwd_impl, pallas_call at :100): per row
//   m = max(s); lse = m + log(sum exp(s - m)); loss = lse - s[label]
// and K5 replaces _vjp_bwd (:127, pallas_call at :135):
//   dlogits = (exp(s - lse) - onehot(label)) * dloss.
// A row whose label equals ignore_index gets loss 0 and dlogits 0 (the
// op of paddle_tpu/ops/nn.py:248,271 masks those rows around the TPU
// kernel; here the kernel does it, with no extra pass over the labels).
// A label outside [0, C) picks nothing, as the TPU kernel's iota compare
// does. loss and lse are float32; labels are read as int64, with no cast.
//
// Bound: memory. K4 must read the logits once (R * C * itemsize) and
// write 8 bytes a row; K5 read them and write dlogits of the same size.
// K4 keeps the max and the sum of exponentials online in registers (one
// pass over the row: a running max m and a sum s rescaled by
// exp(m_old - m_new) when the max grows), so each row is read from HBM
// once; one block per row, 16-byte loads when the row is aligned. K5 is
// one elementwise pass: a block per (row, chunk of the row), the row's
// label, lse and dloss read once per block. Index math is int64
// (R * C is 65.5 M at the training slice's [2048, 32000]).

#include <math.h>

#include "common.cuh"

namespace {

constexpr int kFwdThreads = 512;
constexpr int kBwdThreads = 256;

template <typename T>
struct VecOf {
  static constexpr int N = 16 / sizeof(T);   // elements per 16-byte load
  struct alignas(16) type {
    T v[N];
  };
};

// fold x into the online (max, sum of exp(. - max)) pair
__device__ __forceinline__ void online_add(float& m, float& s, float x) {
  if (x > m) {
    s = s * expf(m - x) + 1.f;
    m = x;
  } else if (x != -INFINITY) {
    s += expf(x - m);
  }
}

// combine two online pairs
__device__ __forceinline__ void online_merge(float& m, float& s, float m2,
                                             float s2) {
  if (m2 == -INFINITY) return;
  if (m == -INFINITY) {
    m = m2;
    s = s2;
    return;
  }
  const float mx = fmaxf(m, m2);
  s = s * expf(m - mx) + s2 * expf(m2 - mx);
  m = mx;
}

template <typename T>
__global__ void softmax_xent_fwd_kernel(const T* __restrict__ logits,
                                        const int64_t* __restrict__ labels,
                                        float* __restrict__ loss,
                                        float* __restrict__ lse_out, int C,
                                        int64_t ignore_index) {
  constexpr int N = VecOf<T>::N;
  using V = typename VecOf<T>::type;
  __shared__ float sm[32], ss[32];
  const int64_t row = blockIdx.x;
  const T* s = logits + row * C;
  float m = -INFINITY, acc = 0.f;
  const bool vec =
      (C % N == 0) && (reinterpret_cast<uintptr_t>(s) % 16 == 0);
  if (vec) {
    const V* sv = reinterpret_cast<const V*>(s);
    for (int i = threadIdx.x; i < C / N; i += blockDim.x) {
      const V a = sv[i];
#pragma unroll
      for (int k = 0; k < N; ++k) online_add(m, acc, pt::to_float(a.v[k]));
    }
  } else {
    for (int c = threadIdx.x; c < C; c += blockDim.x)
      online_add(m, acc, pt::to_float(s[c]));
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    const float m2 = __shfl_xor_sync(0xffffffffu, m, o);
    const float s2 = __shfl_xor_sync(0xffffffffu, acc, o);
    online_merge(m, acc, m2, s2);
  }
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  if (lane == 0) {
    sm[warp] = m;
    ss[warp] = acc;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    float M = sm[0], S = ss[0];
    for (int w = 1; w < (int)(blockDim.x >> 5); ++w)
      online_merge(M, S, sm[w], ss[w]);
    const float lse = M + logf(S);
    const int64_t lbl = labels[row];
    float out = 0.f;
    if (lbl != ignore_index) {
      const float picked =
          (lbl >= 0 && lbl < C) ? pt::to_float(s[lbl]) : 0.f;
      out = lse - picked;
    }
    loss[row] = out;
    lse_out[row] = lse;
  }
}

template <typename T>
__global__ void softmax_xent_bwd_kernel(const T* __restrict__ logits,
                                        const int64_t* __restrict__ labels,
                                        const float* __restrict__ lse,
                                        const float* __restrict__ dloss,
                                        T* __restrict__ dlogits, int C,
                                        int64_t ignore_index) {
  constexpr int N = VecOf<T>::N;
  using V = typename VecOf<T>::type;
  const int64_t row = blockIdx.x;
  const int64_t base = row * C;
  const int64_t lbl = labels[row];
  const bool ignored = lbl == ignore_index;
  const float l = lse[row];
  const float d = ignored ? 0.f : dloss[row];
  const int c0 = (blockIdx.y * blockDim.x + threadIdx.x) * N;
  if (c0 >= C) return;
  const T* s = logits + base;
  T* ds = dlogits + base;
  const bool vec = (C % N == 0) &&
                   (reinterpret_cast<uintptr_t>(s) % 16 == 0) &&
                   (reinterpret_cast<uintptr_t>(ds) % 16 == 0);
  if (vec) {
    const V a = reinterpret_cast<const V*>(s + c0)[0];
    V o;
#pragma unroll
    for (int k = 0; k < N; ++k) {
      const float p = expf(pt::to_float(a.v[k]) - l);
      const float hot = (c0 + k == lbl) ? 1.f : 0.f;
      o.v[k] = pt::from_float<T>((p - hot) * d);
    }
    reinterpret_cast<V*>(ds + c0)[0] = o;
  } else {
    const int c1 = c0 + N < C ? c0 + N : C;
    for (int c = c0; c < c1; ++c) {
      const float p = expf(pt::to_float(s[c]) - l);
      const float hot = (c == lbl) ? 1.f : 0.f;
      ds[c] = pt::from_float<T>((p - hot) * d);
    }
  }
}

}  // namespace

// logits: [R, C] contiguous, float32 or bfloat16; labels: int64 [R];
// loss, lse: float32 [R].
extern "C" int pt_softmax_xent_fwd(const void* logits, const void* labels,
                                   void* loss, void* lse, int R, int C,
                                   long long ignore_index, int dtype,
                                   void* stream) {
  if (R <= 0 || C <= 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int64_t* lb = static_cast<const int64_t*>(labels);
  float* lo = static_cast<float*>(loss);
  float* ls = static_cast<float*>(lse);
  switch (dtype) {
    case pt::kFloat32:
      softmax_xent_fwd_kernel<float><<<R, kFwdThreads, 0, s>>>(
          static_cast<const float*>(logits), lb, lo, ls, C, ignore_index);
      break;
    case pt::kBFloat16:
      softmax_xent_fwd_kernel<__nv_bfloat16><<<R, kFwdThreads, 0, s>>>(
          static_cast<const __nv_bfloat16*>(logits), lb, lo, ls, C,
          ignore_index);
      break;
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

// dlogits: [R, C] of the logits' dtype; lse, dloss: float32 [R].
extern "C" int pt_softmax_xent_bwd(const void* logits, const void* labels,
                                   const void* lse, const void* dloss,
                                   void* dlogits, int R, int C,
                                   long long ignore_index, int dtype,
                                   void* stream) {
  if (R <= 0 || C <= 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int64_t* lb = static_cast<const int64_t*>(labels);
  const float* ls = static_cast<const float*>(lse);
  const float* dl = static_cast<const float*>(dloss);
  switch (dtype) {
    case pt::kFloat32: {
      const int per_block = kBwdThreads * VecOf<float>::N;
      const dim3 grid(R, (C + per_block - 1) / per_block);
      softmax_xent_bwd_kernel<float><<<grid, kBwdThreads, 0, s>>>(
          static_cast<const float*>(logits), lb, ls, dl,
          static_cast<float*>(dlogits), C, ignore_index);
      break;
    }
    case pt::kBFloat16: {
      const int per_block = kBwdThreads * VecOf<__nv_bfloat16>::N;
      const dim3 grid(R, (C + per_block - 1) / per_block);
      softmax_xent_bwd_kernel<__nv_bfloat16><<<grid, kBwdThreads, 0, s>>>(
          static_cast<const __nv_bfloat16*>(logits), lb, ls, dl,
          static_cast<__nv_bfloat16*>(dlogits), C, ignore_index);
      break;
    }
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
