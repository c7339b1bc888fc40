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

#include "common.cuh"

namespace {

constexpr float kNegInf = -1e30f;  // the JAX package's NEG_INF
constexpr int kMaxWarps = 16;

// DPL: head-dim elements a lane holds (D <= 32 * DPL).
// RPW: query rows a warp owns (C <= RPW * nwarps).
template <typename T, int DPL, int RPW>
__global__ void __launch_bounds__(kMaxWarps * 32)
    ragged_paged_attention_kernel(
        const T* __restrict__ q,             // [B, C, H, D]
        const T* __restrict__ k_pages,       // [KVH, P, ps, D]
        const T* __restrict__ v_pages,       // [KVH, P, ps, D]
        const int* __restrict__ start_pos,   // [B]
        const int* __restrict__ num_valid,   // [B]
        const int* __restrict__ tables,      // [B, maxp]
        T* __restrict__ out,                 // [B, C, H, D]
        int C, int H, int D, int KVH, int P, int ps, int maxp,
        float sm_scale) {
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
      k_tile[e] = pt::to_float(k_pages[base + e]);
      v_tile[e] = pt::to_float(v_pages[base + e]);
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

template <typename T, int DPL, int RPW>
void launch(const void* q, const void* kp, const void* vp, const int* start,
            const int* nvalid, const int* tables, void* out, int B, int C,
            int H, int D, int KVH, int P, int ps, int maxp, float sm_scale,
            int nwarps, cudaStream_t s) {
  const dim3 grid(B, H);
  const size_t shm = size_t(2) * ps * D * sizeof(float);
  ragged_paged_attention_kernel<T, DPL, RPW><<<grid, nwarps * 32, shm, s>>>(
      static_cast<const T*>(q), static_cast<const T*>(kp),
      static_cast<const T*>(vp), start, nvalid, tables, static_cast<T*>(out),
      C, H, D, KVH, P, ps, maxp, sm_scale);
}

template <typename T, int DPL>
int dispatch_rows(int rpw, const void* q, const void* kp, const void* vp,
                  const int* start, const int* nvalid, const int* tables,
                  void* out, int B, int C, int H, int D, int KVH, int P,
                  int ps, int maxp, float sm_scale, int nwarps,
                  cudaStream_t s) {
#define PT_RPA_ROWS(R)                                                     \
  case R:                                                                  \
    launch<T, DPL, R>(q, kp, vp, start, nvalid, tables, out, B, C, H, D,  \
                      KVH, P, ps, maxp, sm_scale, nwarps, s);              \
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

template <typename T>
int dispatch_dim(int dpl, int rpw, const void* q, const void* kp,
                 const void* vp, const int* start, const int* nvalid,
                 const int* tables, void* out, int B, int C, int H, int D,
                 int KVH, int P, int ps, int maxp, float sm_scale, int nwarps,
                 cudaStream_t s) {
#define PT_RPA_DIM(N)                                                       \
  case N:                                                                   \
    return dispatch_rows<T, N>(rpw, q, kp, vp, start, nvalid, tables, out, \
                               B, C, H, D, KVH, P, ps, maxp, sm_scale,     \
                               nwarps, s);
  switch (dpl) {
    PT_RPA_DIM(1)
    PT_RPA_DIM(2)
    PT_RPA_DIM(4)
    PT_RPA_DIM(8)
  }
#undef PT_RPA_DIM
  return static_cast<int>(cudaErrorInvalidValue);
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
  if (B <= 0 || C <= 0) return 0;
  if (D <= 0 || D > 256 || C > 64 || KVH <= 0 || H % KVH != 0 || ps <= 0 ||
      maxp <= 0 || 2 * ps * D * int(sizeof(float)) > 48 * 1024)
    return static_cast<int>(cudaErrorInvalidValue);
  const int nwarps = C < kMaxWarps ? C : kMaxWarps;
  const int rpw = (C + nwarps - 1) / nwarps;
  int dpl = (D + 31) / 32;
  dpl = dpl <= 1 ? 1 : (dpl <= 2 ? 2 : (dpl <= 4 ? 4 : 8));
  const int* st = static_cast<const int*>(start_pos);
  const int* nv = static_cast<const int*>(num_valid);
  const int* tb = static_cast<const int*>(page_indices);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  int rc;
  switch (dtype) {
    case pt::kFloat32:
      rc = dispatch_dim<float>(dpl, rpw, q, k_pages, v_pages, st, nv, tb,
                               out, B, C, H, D, KVH, P, ps, maxp, sm_scale,
                               nwarps, s);
      break;
    case pt::kBFloat16:
      rc = dispatch_dim<__nv_bfloat16>(dpl, rpw, q, k_pages, v_pages, st, nv,
                                       tb, out, B, C, H, D, KVH, P, ps, maxp,
                                       sm_scale, nwarps, s);
      break;
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
  if (rc != 0) return rc;
  return static_cast<int>(cudaGetLastError());
}
