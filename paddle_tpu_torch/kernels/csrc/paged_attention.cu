// Paged decode attention for Hopper (sm_90a) (K13).
//
// Replaces paddle_tpu/kernels/paged_attention.py paged_attention (:104),
// which wraps JAX's library Pallas kernel
// jax.experimental.pallas.ops.tpu.paged_attention (:127); numerics
// oracle _reference_paged_attention (:56-85). One query row per
// sequence: q [B, H, D] attends the first lengths[b] keys of sequence b,
// read from [KVH, P, ps, D] pages through the block table
// page_indices[b, :]. GQA: query head h reads kv head h / (H / KVH). The
// reference scales q in float32 first, masks keys at or past the length
// with -1e30 and defines a length-0 row as zeros; so does this kernel,
// with the online softmax in place of the dense one.
//
// Design. One block per (sequence b, head h), kWarps warps. The TPU
// kernel tiles the walk by pages_per_compute_block on its sequential
// grid; here the block's warps split the keys: warp w takes keys
// w, w + kWarps, ... below min(lengths[b], maxp * ps). A key's page comes
// from the block table (the block reads it itself, the TPU's scalar
// prefetch), its row of K and of V straight from device memory, one key
// ahead of the key being reduced, a lane holding D / 32 elements of q,
// of the rows and of the accumulator in float32 registers. Each warp keeps its own (m, l, acc); at the end the warps
// merge them through shared memory in warp order, so the sum order is
// fixed and two calls give the same bits.
//
// Bound: memory. The least traffic is the K and V rows the lengths
// attend, sum_b min(lengths_b, maxp * ps) * D * 2 * KVH elements, plus q
// and out. This kernel reads every K/V row once per query head (GQA
// groups re-read through L2) and reduces one score a key with a warp
// shuffle, so it is latency bound at decode's few thousand keys. At the
// two_lane engine's 8 lanes x 16 heads its grid is 128 blocks, under the
// card's 132 SMs: splitting the key walk across blocks (flash-decoding)
// is the first thing to change.

#include "common.cuh"

namespace {

constexpr float kNegInf = -1e30f;  // the JAX package's NEG_INF
constexpr int kWarps = 8;

// T: q, page and out dtype. DPL: head-dim elements a lane holds
// (D <= 32 * DPL).
template <typename T, int DPL>
__global__ void __launch_bounds__(kWarps * 32)
    paged_attention_kernel(const T* __restrict__ q,        // [B, H, D]
                           const T* __restrict__ k_pages,  // [KVH, P, ps, D]
                           const T* __restrict__ v_pages,  // [KVH, P, ps, D]
                           const int* __restrict__ lengths,  // [B]
                           const int* __restrict__ tables,   // [B, maxp]
                           T* __restrict__ out,              // [B, H, D]
                           int H, int D, int KVH, int P, int ps, int maxp,
                           float sm_scale) {
  __shared__ float part_m[kWarps], part_l[kWarps];
  __shared__ float part_acc[kWarps][DPL * 32];

  const int b = blockIdx.x, h = blockIdx.y;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int kvh = h / (H / KVH);
  int len = lengths[b];
  len = len < maxp * ps ? len : maxp * ps;

  float qr[DPL], acc[DPL];
#pragma unroll
  for (int i = 0; i < DPL; ++i) {
    const int d = lane + 32 * i;
    acc[i] = 0.f;
    // the reference scales q in float32 before the product
    qr[i] = d < D ? pt::to_float(q[(int64_t(b) * H + h) * D + d]) * sm_scale
                  : 0.f;
  }
  // The K and V rows of a warp's next key are loaded while it reduces
  // the current one (a two-stage register pipeline), so the dependent
  // chain load -> shuffle-reduce -> exp does not wait on device memory
  // every key.
  float kn[DPL], vn[DPL];
  auto load_rows = [&](int t) {
    int page = tables[int64_t(b) * maxp + t / ps];
    if (page < 0 || page >= P) page = 0;  // never read outside the pool
    const int64_t row = ((int64_t(kvh) * P + page) * ps + t % ps) * D;
#pragma unroll
    for (int i = 0; i < DPL; ++i) {
      const int d = lane + 32 * i;
      kn[i] = d < D ? pt::to_float(k_pages[row + d]) : 0.f;
      vn[i] = d < D ? pt::to_float(v_pages[row + d]) : 0.f;
    }
  };
  if (warp < len) load_rows(warp);
  float m = kNegInf, l = 0.f;
  for (int t = warp; t < len; t += kWarps) {
    float kc[DPL], vc[DPL];
#pragma unroll
    for (int i = 0; i < DPL; ++i) {
      kc[i] = kn[i];
      vc[i] = vn[i];
    }
    if (t + kWarps < len) load_rows(t + kWarps);
    float s = 0.f;
#pragma unroll
    for (int i = 0; i < DPL; ++i) s += qr[i] * kc[i];
    s = pt::warp_sum(s);
    const float m_next = fmaxf(m, s);
    const float alpha = expf(m - m_next);
    const float pexp = expf(s - m_next);
    l = l * alpha + pexp;
#pragma unroll
    for (int i = 0; i < DPL; ++i) acc[i] = acc[i] * alpha + pexp * vc[i];
    m = m_next;
  }

  if (lane == 0) {
    part_m[warp] = m;
    part_l[warp] = l;
  }
#pragma unroll
  for (int i = 0; i < DPL; ++i) part_acc[warp][lane + 32 * i] = acc[i];
  __syncthreads();
  if (warp != 0) return;
  float mm = kNegInf;
  for (int w = 0; w < kWarps; ++w) mm = fmaxf(mm, part_m[w]);
  float ll = 0.f, o[DPL];
#pragma unroll
  for (int i = 0; i < DPL; ++i) o[i] = 0.f;
  for (int w = 0; w < kWarps; ++w) {
    if (part_l[w] == 0.f) continue;  // a warp that saw no key
    const float a = expf(part_m[w] - mm);
    ll += part_l[w] * a;
#pragma unroll
    for (int i = 0; i < DPL; ++i) o[i] += part_acc[w][lane + 32 * i] * a;
  }
  const bool ok = len > 0 && ll > 0.f;
  const float inv = ok ? 1.f / ll : 0.f;
#pragma unroll
  for (int i = 0; i < DPL; ++i) {
    const int d = lane + 32 * i;
    if (d < D)
      out[(int64_t(b) * H + h) * D + d] =
          pt::from_float<T>(ok ? o[i] * inv : 0.f);
  }
}

template <typename T>
int launch(int dpl, const void* q, const void* kp, const void* vp,
           const int* lengths, const int* tables, void* out, int B, int H,
           int D, int KVH, int P, int ps, int maxp, float sm_scale,
           cudaStream_t s) {
  const dim3 grid(B, H);
#define PT_PA_DIM(N)                                                       \
  case N:                                                                  \
    paged_attention_kernel<T, N><<<grid, kWarps * 32, 0, s>>>(             \
        static_cast<const T*>(q), static_cast<const T*>(kp),               \
        static_cast<const T*>(vp), lengths, tables, static_cast<T*>(out),  \
        H, D, KVH, P, ps, maxp, sm_scale);                                 \
    return 0;
  switch (dpl) {
    PT_PA_DIM(1)
    PT_PA_DIM(2)
    PT_PA_DIM(4)
    PT_PA_DIM(8)
  }
#undef PT_PA_DIM
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

// q, out: [B, H, D]; k_pages, v_pages: [KVH, P, ps, D]; all of one dtype
// (float32 or bfloat16), contiguous. lengths: [B] int32, the keys each
// row attends (the row just written included); page_indices: [B, maxp]
// int32. Limits (checked again by the Python wrapper): D <= 256,
// H % KVH == 0.
extern "C" int pt_paged_attention(const void* q, const void* k_pages,
                                  const void* v_pages, const void* lengths,
                                  const void* page_indices, void* out, int B,
                                  int H, int D, int KVH, int P, int ps,
                                  int maxp, float sm_scale, int dtype,
                                  void* stream) {
  if (B <= 0 || H <= 0) return 0;
  if (D <= 0 || D > 256 || KVH <= 0 || H % KVH != 0 || ps <= 0 || maxp <= 0 ||
      P <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  int dpl = (D + 31) / 32;
  dpl = dpl <= 1 ? 1 : (dpl <= 2 ? 2 : (dpl <= 4 ? 4 : 8));
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int* len = static_cast<const int*>(lengths);
  const int* tab = static_cast<const int*>(page_indices);
  int rc;
  switch (dtype) {
    case pt::kFloat32:
      rc = launch<float>(dpl, q, k_pages, v_pages, len, tab, out, B, H, D,
                         KVH, P, ps, maxp, sm_scale, s);
      break;
    case pt::kBFloat16:
      rc = launch<__nv_bfloat16>(dpl, q, k_pages, v_pages, len, tab, out, B,
                                 H, D, KVH, P, ps, maxp, sm_scale, s);
      break;
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
  if (rc != 0) return rc;
  return static_cast<int>(cudaGetLastError());
}
