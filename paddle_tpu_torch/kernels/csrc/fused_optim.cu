// One-pass optimizer updates, in place, for Hopper (sm_90a): Adam /
// AdamW (K10) and momentum (K10m).
//
// Replaces the pallas_call of paddle_tpu/kernels/fused_optim.py
// (_run_fused, pallas_call at :153) with its Adam body _adam_kernel (:93):
//   g  = g * clip_scale            (rounded to the param dtype if not f32)
//   m' = b1 * m + (1 - b1) * g;  v' = b2 * v + (1 - b2) * g * g
//   p' = p - lr_t * m' / (sqrt(v') + eps)  [ - lr * coeff * p  (AdamW) ]
// with lr_t = lr * sqrt(1 - b2^t) / (1 - b1^t), in that order of
// operations. p, m and v are written in place, as the TPU kernel's
// input_output_aliases update the donated buffers.
//
// lr, beta1^t, beta2^t and the clip scale are float32 scalars on the
// device: every thread reads them (an L1 hit after the first) and forms
// lr_t itself, so the wrapper never reads a value back to the host (a
// sync per parameter would stall the card 294 times a step at
// gpt3_1p3b). 1 - b1 and 1 - b2 come from the host rounded once from
// double, as the reference's Python floats are.
//
// Bound: memory. The update must read p, g, m, v and write p, m, v:
// 7 * n * itemsize bytes. One flat grid-stride pass with 16-byte loads
// and stores when every pointer is 16-byte aligned (the panel padding of
// the TPU kernel is a Mosaic layout rule and has no counterpart here),
// a scalar tail otherwise.
//
// K10m, the momentum body of the same pallas_call (_momentum_kernel,
// :117):
//   g    = g * clip_scale          (rounded to the param dtype if not f32)
//   vel' = mu * vel + g
//   p'   = p - lr * vel'           (nesterov: p - lr * (g + mu * vel'))
// in float32, rounded once to the param dtype at the end, as the TPU
// kernel does. lr and the clip scale are read on the device; mu comes
// from the host. The same grid-stride driver, 16-byte vectors and _rn
// intrinsics (no fma contraction of mu * vel + g), so the kernel equals
// the plain version bit for bit. Bound: memory, p, g, vel read and p, vel
// written, 5 * n * itemsize bytes.

#include "common.cuh"

namespace {

constexpr int kThreads = 256;

template <typename T>
struct Vec16 {
  static constexpr int N = 16 / sizeof(T);
  struct alignas(16) type {
    T v[N];
  };
};

struct AdamScalars {
  float lr, lr_t, clip, beta1, beta2, one_minus_b1, one_minus_b2, eps, coeff;
};

__device__ __forceinline__ AdamScalars load_scalars(
    const float* lr, const float* b1p, const float* b2p, const float* clip,
    float beta1, float beta2, float omb1, float omb2, float eps,
    float coeff) {
  AdamScalars a;
  a.lr = lr[0];
  a.lr_t = __fdiv_rn(__fmul_rn(a.lr, __fsqrt_rn(__fsub_rn(1.f, b2p[0]))),
                     __fsub_rn(1.f, b1p[0]));
  a.clip = clip != nullptr ? clip[0] : 1.f;
  a.beta1 = beta1;
  a.beta2 = beta2;
  a.one_minus_b1 = omb1;
  a.one_minus_b2 = omb2;
  a.eps = eps;
  a.coeff = coeff;
  return a;
}

// Every step rounds as the reference's chain of float32 ops does: the
// _rn intrinsics keep nvcc from contracting a * b + c into one fma, so
// in float32 the kernel equals the plain version bit for bit.
template <typename T>
__device__ __forceinline__ void adam_one(const AdamScalars& a, T& p, T g,
                                         T& m, T& v) {
  const float pf = pt::to_float(p);
  float gf = __fmul_rn(pt::to_float(g), a.clip);
  // the reference rounds the clipped grad to the param dtype before the
  // moment update (fused_optim.py:100-104)
  gf = pt::to_float(pt::from_float<T>(gf));
  const float mf = __fadd_rn(__fmul_rn(a.beta1, pt::to_float(m)),
                             __fmul_rn(a.one_minus_b1, gf));
  const float vf = __fadd_rn(__fmul_rn(a.beta2, pt::to_float(v)),
                             __fmul_rn(a.one_minus_b2, __fmul_rn(gf, gf)));
  const float upd = __fdiv_rn(__fmul_rn(a.lr_t, mf),
                              __fadd_rn(__fsqrt_rn(vf), a.eps));
  float pn = __fsub_rn(pf, upd);
  if (a.coeff != 0.f) pn = __fsub_rn(pn, __fmul_rn(__fmul_rn(a.lr, a.coeff), pf));
  p = pt::from_float<T>(pn);
  m = pt::from_float<T>(mf);
  v = pt::from_float<T>(vf);
}

template <typename T>
__global__ void adam_kernel(T* __restrict__ p, const T* __restrict__ g,
                            T* __restrict__ m, T* __restrict__ v,
                            const float* __restrict__ lr,
                            const float* __restrict__ b1p,
                            const float* __restrict__ b2p,
                            const float* __restrict__ clip, int64_t n,
                            float beta1, float beta2, float omb1, float omb2,
                            float eps, float coeff, bool vec) {
  const AdamScalars a = load_scalars(lr, b1p, b2p, clip, beta1, beta2, omb1,
                                     omb2, eps, coeff);
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  int64_t done = 0;
  if (vec) {
    constexpr int N = Vec16<T>::N;
    using V = typename Vec16<T>::type;
    const int64_t nv = n / N;
    V* pv = reinterpret_cast<V*>(p);
    const V* gv = reinterpret_cast<const V*>(g);
    V* mv = reinterpret_cast<V*>(m);
    V* vv = reinterpret_cast<V*>(v);
    for (int64_t j = i; j < nv; j += stride) {
      V P = pv[j], M = mv[j], W = vv[j];
      const V G = gv[j];
#pragma unroll
      for (int k = 0; k < N; ++k) adam_one(a, P.v[k], G.v[k], M.v[k], W.v[k]);
      pv[j] = P;
      mv[j] = M;
      vv[j] = W;
    }
    done = nv * N;
  }
  for (int64_t j = done + i; j < n; j += stride) {
    T P = p[j], M = m[j], W = v[j];
    adam_one(a, P, g[j], M, W);
    p[j] = P;
    m[j] = M;
    v[j] = W;
  }
}

// K10m's update of one element: the rounding order of the plain version.
template <typename T>
__device__ __forceinline__ void momentum_one(float lr, float clip, float mu,
                                             bool nesterov, T& p, T g, T& v) {
  const float pf = pt::to_float(p);
  float gf = __fmul_rn(pt::to_float(g), clip);
  gf = pt::to_float(pt::from_float<T>(gf));
  const float vf = __fadd_rn(__fmul_rn(mu, pt::to_float(v)), gf);
  const float upd = nesterov
                        ? __fmul_rn(lr, __fadd_rn(gf, __fmul_rn(mu, vf)))
                        : __fmul_rn(lr, vf);
  p = pt::from_float<T>(__fsub_rn(pf, upd));
  v = pt::from_float<T>(vf);
}

template <typename T>
__global__ void momentum_kernel(T* __restrict__ p, const T* __restrict__ g,
                                T* __restrict__ v,
                                const float* __restrict__ lr_p,
                                const float* __restrict__ clip_p, int64_t n,
                                float mu, bool nesterov, bool vec) {
  const float lr = lr_p[0];
  const float clip = clip_p != nullptr ? clip_p[0] : 1.f;
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  int64_t done = 0;
  if (vec) {
    constexpr int N = Vec16<T>::N;
    using V = typename Vec16<T>::type;
    const int64_t nv = n / N;
    V* pv = reinterpret_cast<V*>(p);
    const V* gv = reinterpret_cast<const V*>(g);
    V* vv = reinterpret_cast<V*>(v);
    for (int64_t j = i; j < nv; j += stride) {
      V P = pv[j], W = vv[j];
      const V G = gv[j];
#pragma unroll
      for (int k = 0; k < N; ++k)
        momentum_one(lr, clip, mu, nesterov, P.v[k], G.v[k], W.v[k]);
      pv[j] = P;
      vv[j] = W;
    }
    done = nv * N;
  }
  for (int64_t j = done + i; j < n; j += stride) {
    T P = p[j], W = v[j];
    momentum_one(lr, clip, mu, nesterov, P, g[j], W);
    p[j] = P;
    v[j] = W;
  }
}

bool aligned16(const void* q) {
  return reinterpret_cast<uintptr_t>(q) % 16 == 0;
}

// Blocks of the grid-stride pass: one 16-byte vector a thread, at most
// 32 blocks an SM.
unsigned grid_blocks(long long n, int dtype) {
  const int per_thread = dtype == pt::kFloat32 ? 4 : 8;
  int64_t blocks = (n / per_thread + kThreads - 1) / kThreads;
  blocks = blocks < 1 ? 1 : (blocks > 132 * 32 ? 132 * 32 : blocks);
  return static_cast<unsigned>(blocks);
}

}  // namespace

// p, g, m, v: n contiguous elements of one dtype; p, m, v updated in
// place. lr, b1p, b2p: float32 [1] on the device; clip: float32 [1] or
// null (scale 1).
extern "C" int pt_fused_adam(void* p, const void* g, void* m, void* v,
                             const void* lr, const void* b1p,
                             const void* b2p, const void* clip, long long n,
                             float beta1, float beta2, float one_minus_b1,
                             float one_minus_b2, float eps, float coeff,
                             int dtype, void* stream) {
  if (n <= 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool vec = aligned16(p) && aligned16(g) && aligned16(m) &&
                   aligned16(v);
  const unsigned blocks = grid_blocks(n, dtype);
  const float* lrp = static_cast<const float*>(lr);
  const float* b1 = static_cast<const float*>(b1p);
  const float* b2 = static_cast<const float*>(b2p);
  const float* cl = static_cast<const float*>(clip);
  switch (dtype) {
    case pt::kFloat32:
      adam_kernel<float><<<blocks, kThreads, 0, s>>>(
          static_cast<float*>(p), static_cast<const float*>(g),
          static_cast<float*>(m), static_cast<float*>(v), lrp, b1, b2, cl, n,
          beta1, beta2, one_minus_b1, one_minus_b2, eps, coeff, vec);
      break;
    case pt::kBFloat16:
      adam_kernel<__nv_bfloat16>
          <<<blocks, kThreads, 0, s>>>(
              static_cast<__nv_bfloat16*>(p),
              static_cast<const __nv_bfloat16*>(g),
              static_cast<__nv_bfloat16*>(m), static_cast<__nv_bfloat16*>(v),
              lrp, b1, b2, cl, n, beta1, beta2, one_minus_b1, one_minus_b2,
              eps, coeff, vec);
      break;
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

// K10m. p, g, v: n contiguous elements of one dtype; p and v updated in
// place. lr: float32 [1] on the device; clip: float32 [1] or null
// (scale 1); nesterov: 0 or 1.
extern "C" int pt_fused_momentum(void* p, const void* g, void* v,
                                 const void* lr, const void* clip,
                                 long long n, float mu, int nesterov,
                                 int dtype, void* stream) {
  if (n <= 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool vec = aligned16(p) && aligned16(g) && aligned16(v);
  const unsigned blocks = grid_blocks(n, dtype);
  const float* lrp = static_cast<const float*>(lr);
  const float* cl = static_cast<const float*>(clip);
  switch (dtype) {
    case pt::kFloat32:
      momentum_kernel<float><<<blocks, kThreads, 0, s>>>(
          static_cast<float*>(p), static_cast<const float*>(g),
          static_cast<float*>(v), lrp, cl, n, mu, nesterov != 0, vec);
      break;
    case pt::kBFloat16:
      momentum_kernel<__nv_bfloat16><<<blocks, kThreads, 0, s>>>(
          static_cast<__nv_bfloat16*>(p),
          static_cast<const __nv_bfloat16*>(g),
          static_cast<__nv_bfloat16*>(v), lrp, cl, n, mu, nesterov != 0,
          vec);
      break;
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
