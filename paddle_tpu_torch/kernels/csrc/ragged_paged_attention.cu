// Ragged paged attention for Hopper (sm_90a).
//
// Replaces the Pallas kernel of paddle_tpu/kernels/ragged_paged_attention.py
// (_ragged_pallas, pallas_call at :232; numerics oracle _reference_ragged
// at :89). Row b of the batch holds up to C new query tokens of one
// sequence; query j sits at absolute position start[b] + j and attends
// keys 0 .. start[b] + j of that sequence, read from [KVH, P, ps, D]
// pages through the block table page_indices[b, :]. GQA: query head h
// reads kv head h / (H / KVH). Rows j >= num_valid[b] (and whole idle
// lanes, num_valid = 0) are written as exactly 0, never NaN.
//
// Design. One block per (row b, head h). The TPU kernel walks the pages
// as a sequential grid axis and carries (m, l, acc) in VMEM scratch from
// step to step; blocks on a GPU run in no order, so here a loop inside
// the block walks the pages while p * ps < start + num_valid, and the
// block reads page_indices[b, p] itself (the TPU's scalar prefetch).
// Each page's [ps, D] K and V tiles are staged in shared memory as
// float32 by the whole block. Each warp owns query rows j = warp,
// warp + nwarps, ...; a lane holds D / 32 elements of q and of the
// accumulator in registers and keeps the online softmax (m, l, acc) in
// float32. The position mask kpos <= start + j is applied key by key, so
// stale rows past a sequence's length in its last page (and anything on
// the junk page 0) are never read into the sum.
//
// Bound: memory. The least traffic is the K/V pages the rows actually
// need, sum_b ceil((start_b + num_valid_b) / ps) * ps * D * 2 * KVH
// elements, plus q and out. The kernel reads each needed page once per
// query head (so GQA groups re-read through L2), and one scalar score a
// key a row (a warp reduction per key) keeps it far from both the
// memory and the compute roofline. At the serving slice's B = 8 lanes
// and H = 16 heads the grid is 128 blocks, under the card's 132 SMs:
// splitting the page walk across blocks is the first thing to change.
//
// K2q, the int8 variant (the same Pallas kernel with quantized=True,
// scales applied at :150-155 there). The pages hold int8 K/V and each
// (kv head, page, slot) row has one float32 scale ([KVH, P, ps] planes,
// written by quantized_kv_cache_write). Staging a page multiplies each
// int8 element by its row's scale as it converts it to float32 (the
// plain version's float(q) * scale, bit for bit); the online softmax,
// the position mask and the zero rows are K2's. An int8 page moves
// D + 4 bytes a slot per K or V instead of 4 * D, so the bound's page
// traffic is about a quarter of K2's.

#include <type_traits>

#include "common.cuh"

namespace {

constexpr float kNegInf = -1e30f;  // the JAX package's NEG_INF
constexpr int kMaxWarps = 16;

// T: q / out dtype; KT: page dtype (T, or int8_t with scale planes).
// DPL: head-dim elements a lane holds (D <= 32 * DPL).
// RPW: query rows a warp owns (C <= RPW * nwarps).
template <typename T, typename KT, int DPL, int RPW>
__global__ void __launch_bounds__(kMaxWarps * 32)
    ragged_paged_attention_kernel(
        const T* __restrict__ q,             // [B, C, H, D]
        const KT* __restrict__ k_pages,      // [KVH, P, ps, D]
        const KT* __restrict__ v_pages,      // [KVH, P, ps, D]
        const float* __restrict__ k_scales,  // [KVH, P, ps] (int8 KT only)
        const float* __restrict__ v_scales,  // [KVH, P, ps] (int8 KT only)
        const int* __restrict__ start_pos,   // [B]
        const int* __restrict__ num_valid,   // [B]
        const int* __restrict__ tables,      // [B, maxp]
        T* __restrict__ out,                 // [B, C, H, D]
        int C, int H, int D, int KVH, int P, int ps, int maxp,
        float sm_scale) {
  constexpr bool kQuant = std::is_same<KT, int8_t>::value;
  extern __shared__ float smem[];
  float* k_tile = smem;            // [ps, D]
  float* v_tile = smem + ps * D;   // [ps, D]

  const int b = blockIdx.x, h = blockIdx.y;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int nwarps = blockDim.x >> 5;
  const int kvh = h / (H / KVH);
  const int start = start_pos[b];
  const int nv = num_valid[b];

  float qr[RPW][DPL], acc[RPW][DPL], m[RPW], l[RPW];
#pragma unroll
  for (int r = 0; r < RPW; ++r) {
    const int j = warp + r * nwarps;
    m[r] = kNegInf;
    l[r] = 0.f;
#pragma unroll
    for (int i = 0; i < DPL; ++i) {
      const int d = lane + 32 * i;
      acc[r][i] = 0.f;
      qr[r][i] = (j < nv && d < D)
                     ? pt::to_float(q[((int64_t(b) * C + j) * H + h) * D + d]) *
                           sm_scale
                     : 0.f;
    }
  }

  const int total = nv > 0 ? start + nv : 0;  // keys this row needs
  int npages = (total + ps - 1) / ps;
  npages = npages < maxp ? npages : maxp;
  const int tile = ps * D;
  for (int p = 0; p < npages; ++p) {
    int page = tables[int64_t(b) * maxp + p];
    if (page < 0 || page >= P) page = 0;  // never read outside the pool
    const int64_t base = (int64_t(kvh) * P + page) * tile;
    __syncthreads();  // the previous page's tiles are consumed
    for (int e = threadIdx.x; e < tile; e += blockDim.x) {
      float kv = pt::to_float(k_pages[base + e]);
      float vv = pt::to_float(v_pages[base + e]);
      if (kQuant) {
        const int64_t row = (int64_t(kvh) * P + page) * ps + e / D;
        kv *= k_scales[row];
        vv *= v_scales[row];
      }
      k_tile[e] = kv;
      v_tile[e] = vv;
    }
    __syncthreads();
#pragma unroll
    for (int r = 0; r < RPW; ++r) {
      const int j = warp + r * nwarps;
      if (j >= nv) continue;  // warp-uniform
      // keys t of this page with p * ps + t <= start + j
      int kend = start + j - p * ps + 1;
      kend = kend < ps ? kend : ps;
      for (int t = 0; t < kend; ++t) {
        float s = 0.f;
#pragma unroll
        for (int i = 0; i < DPL; ++i) {
          const int d = lane + 32 * i;
          if (d < D) s += qr[r][i] * k_tile[t * D + d];
        }
        s = pt::warp_sum(s);
        const float m_next = fmaxf(m[r], s);
        const float alpha = expf(m[r] - m_next);
        const float pexp = expf(s - m_next);
        l[r] = l[r] * alpha + pexp;
#pragma unroll
        for (int i = 0; i < DPL; ++i) {
          const int d = lane + 32 * i;
          const float vv = d < D ? v_tile[t * D + d] : 0.f;
          acc[r][i] = acc[r][i] * alpha + pexp * vv;
        }
        m[r] = m_next;
      }
    }
  }

#pragma unroll
  for (int r = 0; r < RPW; ++r) {
    const int j = warp + r * nwarps;
    if (j >= C) continue;
    const bool ok = j < nv && l[r] > 0.f;
    const float inv = ok ? 1.f / l[r] : 0.f;
#pragma unroll
    for (int i = 0; i < DPL; ++i) {
      const int d = lane + 32 * i;
      if (d < D)
        out[((int64_t(b) * C + j) * H + h) * D + d] =
            pt::from_float<T>(ok ? acc[r][i] * inv : 0.f);
    }
  }
}

// The arguments every launch carries, past the template choices.
struct Args {
  const void *q, *kp, *vp;
  const float *ks, *vs;
  const int *start, *nvalid, *tables;
  void* out;
  int B, C, H, D, KVH, P, ps, maxp;
  float sm_scale;
  int nwarps;
  cudaStream_t s;
};

template <typename T, typename KT, int DPL, int RPW>
void launch(const Args& a) {
  const dim3 grid(a.B, a.H);
  const size_t shm = size_t(2) * a.ps * a.D * sizeof(float);
  ragged_paged_attention_kernel<T, KT, DPL, RPW>
      <<<grid, a.nwarps * 32, shm, a.s>>>(
          static_cast<const T*>(a.q), static_cast<const KT*>(a.kp),
          static_cast<const KT*>(a.vp), a.ks, a.vs, a.start, a.nvalid,
          a.tables, static_cast<T*>(a.out), a.C, a.H, a.D, a.KVH, a.P, a.ps,
          a.maxp, a.sm_scale);
}

template <typename T, typename KT, int DPL>
int dispatch_rows(int rpw, const Args& a) {
#define PT_RPA_ROWS(R)          \
  case R:                       \
    launch<T, KT, DPL, R>(a);   \
    return 0;
  switch (rpw) {
    PT_RPA_ROWS(1)
    PT_RPA_ROWS(2)
    PT_RPA_ROWS(3)
    PT_RPA_ROWS(4)
  }
#undef PT_RPA_ROWS
  return static_cast<int>(cudaErrorInvalidValue);
}

template <typename T, typename KT>
int dispatch_dim(int dpl, int rpw, const Args& a) {
#define PT_RPA_DIM(N) \
  case N:             \
    return dispatch_rows<T, KT, N>(rpw, a);
  switch (dpl) {
    PT_RPA_DIM(1)
    PT_RPA_DIM(2)
    PT_RPA_DIM(4)
    PT_RPA_DIM(8)
  }
#undef PT_RPA_DIM
  return static_cast<int>(cudaErrorInvalidValue);
}

// Validates the shapes and picks the template arguments: the page
// dtype is q's own, or int8 for K2q (kQuant).
template <bool kQuant>
int run(const void* q, const void* k_pages, const void* v_pages,
        const void* k_scales, const void* v_scales, const void* start_pos,
        const void* num_valid, const void* page_indices, void* out, int B,
        int C, int H, int D, int KVH, int P, int ps, int maxp,
        float sm_scale, int dtype, void* stream) {
  if (B <= 0 || C <= 0) return 0;
  if (D <= 0 || D > 256 || C > 64 || KVH <= 0 || H % KVH != 0 || ps <= 0 ||
      maxp <= 0 || 2 * ps * D * int(sizeof(float)) > 48 * 1024)
    return static_cast<int>(cudaErrorInvalidValue);
  Args a;
  a.q = q;
  a.kp = k_pages;
  a.vp = v_pages;
  a.ks = static_cast<const float*>(k_scales);
  a.vs = static_cast<const float*>(v_scales);
  a.start = static_cast<const int*>(start_pos);
  a.nvalid = static_cast<const int*>(num_valid);
  a.tables = static_cast<const int*>(page_indices);
  a.out = out;
  a.B = B;
  a.C = C;
  a.H = H;
  a.D = D;
  a.KVH = KVH;
  a.P = P;
  a.ps = ps;
  a.maxp = maxp;
  a.sm_scale = sm_scale;
  a.nwarps = C < kMaxWarps ? C : kMaxWarps;
  a.s = static_cast<cudaStream_t>(stream);
  const int rpw = (C + a.nwarps - 1) / a.nwarps;
  int dpl = (D + 31) / 32;
  dpl = dpl <= 1 ? 1 : (dpl <= 2 ? 2 : (dpl <= 4 ? 4 : 8));
  int rc;
  switch (dtype) {
    case pt::kFloat32:
      rc = dispatch_dim<float, typename std::conditional<kQuant, int8_t,
                                                         float>::type>(
          dpl, rpw, a);
      break;
    case pt::kBFloat16:
      rc = dispatch_dim<__nv_bfloat16,
                        typename std::conditional<kQuant, int8_t,
                                                  __nv_bfloat16>::type>(
          dpl, rpw, a);
      break;
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
  if (rc != 0) return rc;
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// q, out: [B, C, H, D]; k_pages, v_pages: [KVH, P, ps, D]; all of one
// dtype, contiguous. start_pos, num_valid: [B] int32; page_indices:
// [B, maxp] int32. Limits (checked again by the Python wrapper):
// D <= 256, C <= 64, H % KVH == 0, 2 * ps * D * 4 bytes <= 48 KB.
extern "C" int pt_ragged_paged_attention(
    const void* q, const void* k_pages, const void* v_pages,
    const void* start_pos, const void* num_valid, const void* page_indices,
    void* out, int B, int C, int H, int D, int KVH, int P, int ps, int maxp,
    float sm_scale, int dtype, void* stream) {
  return run<false>(q, k_pages, v_pages, nullptr, nullptr, start_pos,
                    num_valid, page_indices, out, B, C, H, D, KVH, P, ps,
                    maxp, sm_scale, dtype, stream);
}

// K2q: as above with int8 k_pages / v_pages and their float32 scale
// planes k_scales, v_scales [KVH, P, ps]; q and out float32 or
// bfloat16 (dtype).
extern "C" int pt_ragged_paged_attention_q(
    const void* q, const void* k_pages, const void* v_pages,
    const void* k_scales, const void* v_scales, const void* start_pos,
    const void* num_valid, const void* page_indices, void* out, int B, int C,
    int H, int D, int KVH, int P, int ps, int maxp, float sm_scale,
    int dtype, void* stream) {
  return run<true>(q, k_pages, v_pages, k_scales, v_scales, start_pos,
                   num_valid, page_indices, out, B, C, H, D, KVH, P, ps,
                   maxp, sm_scale, dtype, stream);
}
