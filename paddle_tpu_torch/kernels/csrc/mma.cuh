// Tensor-core fragment and staging helpers for the port's Hopper kernels
// (mma.sync, ldmatrix, cp.async), and warp-level tile products built on
// them (used by quant_matmul.cu, flash_attention.cu and paged_attention.cu).
//
// Fragment layouts of mma.sync (PTX ISA, "Matrix fragments for mma.m16n8k16"
// and "mma.m16n8k8"), for lane l of a warp, g = l / 4, t = l % 4:
//   C/D (16 x 8 f32):   c0, c1 = (row g,     cols 2t, 2t+1)
//                       c2, c3 = (row g + 8, cols 2t, 2t+1)
//   bf16 m16n8k16  A:   a0 = (g, k 2t..2t+1)     a1 = (g+8, k 2t..2t+1)
//                       a2 = (g, k 2t+8..2t+9)   a3 = (g+8, k 2t+8..2t+9)
//                  B:   b0 = (k 2t..2t+1, n g)   b1 = (k 2t+8..2t+9, n g)
//   tf32 m16n8k8   A:   a0 = (g, t) a1 = (g+8, t) a2 = (g, t+4) a3 = (g+8, t+4)
//                  B:   b0 = (k t, n g)          b1 = (k t+4, n g)
// A bf16 pair holds the lower k (or column) in its low 16 bits.
#pragma once

#include <cuda_bf16.h>
#include <stdint.h>

namespace pt {
namespace mma {

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// Four 8 x 8 b16 matrices from shared memory; lanes 8i..8i+7 give the
// 16-byte row addresses of matrix i, and r[i] is this lane's pair of it.
__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p)));
}

// The same, each matrix transposed: lane l gets (rows 2(l%4), 2(l%4)+1;
// column l/4) of the stored matrix.
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4],
                                                  const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p)));
}

// d += a b: 16 x 16 bf16 by 16 x 8 bf16, float32 accumulators.
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// d += a b: 16 x 8 tf32 by 8 x 8 tf32, float32 accumulators.
__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// x rounded to tf32 (10 mantissa bits, nearest, ties away from zero, as
// cvt.rna.tf32.f32) for a finite x, by integer instructions: the
// conversion instructions run at a quarter of the ALU rate on sm_90, and
// the split below takes two of them for every operand element.
__device__ __forceinline__ uint32_t to_tf32(float x) {
  return (__float_as_uint(x) + 0x1000u) & 0xFFFFE000u;
}

// x = hi + lo to about 22 bits, both tf32 ("3xTF32": hi*hi + hi*lo +
// lo*hi keeps float32 accuracy on the TF32 tensor cores).
__device__ __forceinline__ void split_tf32(float x, uint32_t& hi,
                                           uint32_t& lo) {
  hi = to_tf32(x);
  lo = to_tf32(x - __uint_as_float(hi));
}

// Two floats as a bf16 pair (round to nearest even), `first` low.
__device__ __forceinline__ uint32_t pack_bf16(float first, float second) {
  __nv_bfloat162 v = __floats2bfloat162_rn(first, second);
  return *reinterpret_cast<uint32_t*>(&v);
}

// 16 bytes global -> shared, asynchronous; zeros when !pred (no bytes
// are read then, but the address must still be a mapped one).
__device__ __forceinline__ void cp_async16(void* smem, const void* gmem,
                                           bool pred) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_u32(smem)),
               "l"(gmem), "r"(pred ? 16 : 0));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// ---------------------------------------------------------------------------
// Warp-level tile products on shared-memory tiles, for attention-shaped
// work (the flash kernels). A tile of T (bfloat16 or float) is [rows][LD]
// with LD = DP + Pad<T>::value: the pad shifts consecutive rows by 4 banks, so
// the fragment loads below are free of bank conflicts. A warp owns 16 rows
// of the left operand; its accumulators are mma C fragments, acc[n] the
// 16 x 8 tile of columns 8n..8n+7.
//   bfloat16: mma.m16n8k16 with fragments from ldmatrix; a left operand
//     held in registers (P, dS) is rounded to bf16, as FlashAttention-2
//     does.
//   float: 3xTF32 on mma.m16n8k8: each operand x = hi + lo (tf32 both),
//     and lo*hi + hi*lo + hi*hi keeps float32 accuracy (a single TF32
//     product keeps about 11 bits).
// ---------------------------------------------------------------------------

template <typename T>
struct Pad;
template <>
struct Pad<__nv_bfloat16> {
  static constexpr int value = 8;
};
template <>
struct Pad<float> {
  static constexpr int value = 4;
};

// Copy rows [r0, r0 + ROWS) of a [S, D] slab into a [ROWS][LD] tile,
// zeros past S and in columns D..DP-1. vec: D * sizeof(T) is a multiple
// of 16 and g 16-byte aligned, so the copy goes by cp.async (the caller
// commits and waits); otherwise by plain loads and stores.
template <typename T, int ROWS, int DP, int LD, int NTH>
__device__ __forceinline__ void load_tile(T* sh, const T* g, int r0, int S,
                                          int D, bool vec) {
  constexpr int CH = 16 / sizeof(T), NCH = DP / CH;
  if (vec) {
    for (int i = threadIdx.x; i < ROWS * NCH; i += NTH) {
      const int r = i / NCH, c = (i - r * NCH) * CH;
      const int gr = r0 + r;
      const bool ok = gr < S && c < D;
      cp_async16(sh + r * LD + c, ok ? g + static_cast<int64_t>(gr) * D + c : g,
                 ok);
    }
  } else {
    for (int i = threadIdx.x; i < ROWS * DP; i += NTH) {
      const int r = i / DP, c = i - r * DP;
      const int gr = r0 + r;
      sh[r * LD + c] = (gr < S && c < D) ? g[static_cast<int64_t>(gr) * D + c]
                                         : static_cast<T>(0.f);
    }
  }
}

// The products below load fragments ahead of the mma that reads them
// (the next k step's in the bf16 abt, two steps ahead in pb): the loads
// are asm volatile, issued in program order, and an mma right behind its
// load would wait out the shared-memory latency each time.

// acc[n] += A[16 rows from sA][0, DP) . B[rows 8n..8n+7 of sB][0, DP)^T
template <int NT, int DP, int LD>
__device__ __forceinline__ void warp_mma_abt(float (&acc)[NT][4],
                                             const __nv_bfloat16* sA,
                                             const __nv_bfloat16* sB) {
  const int lane = threadIdx.x & 31, mi = lane >> 3, r8 = lane & 7;
  const __nv_bfloat16* pa = sA + ((mi & 1) * 8 + r8) * LD + (mi >> 1) * 8;
  const __nv_bfloat16* pb = sB + ((mi >> 1) * 8 + r8) * LD + (mi & 1) * 8;
  uint32_t a[2][4], b[2][NT / 2][4];
  auto load = [&](int s, int buf) {
    ldmatrix_x4(a[buf], pa + s * 16);
#pragma unroll
    for (int n = 0; n < NT; n += 2)
      ldmatrix_x4(b[buf][n / 2], pb + n * 8 * LD + s * 16);
  };
  load(0, 0);
#pragma unroll
  for (int s = 0; s < DP / 16; ++s) {
    if (s + 1 < DP / 16) load(s + 1, (s + 1) & 1);
#pragma unroll
    for (int n = 0; n < NT; n += 2) {
      mma_bf16(acc[n], a[s & 1], b[s & 1][n / 2][0], b[s & 1][n / 2][1]);
      mma_bf16(acc[n + 1], a[s & 1], b[s & 1][n / 2][2],
               b[s & 1][n / 2][3]);
    }
  }
}

template <int NT, int DP, int LD>
__device__ __forceinline__ void warp_mma_abt(float (&acc)[NT][4],
                                             const float* sA,
                                             const float* sB) {
  // ldmatrix moves 32-bit elements too: an 8 x 8 b16 matrix is 8 rows of
  // 4 floats, and lane l receives (row l / 4, float l % 4), which is the
  // tf32 fragment layout. (Loading the next k step ahead, as the bf16
  // version does, measured slower here: the split operands already fill
  // the registers.)
  const int lane = threadIdx.x & 31, mi = lane >> 3, r8 = lane & 7;
  const float* pa = sA + ((mi & 1) * 8 + r8) * LD + (mi >> 1) * 4;
  const float* pb = sB + ((mi >> 1) * 8 + r8) * LD + (mi & 1) * 4;
#pragma unroll 2
  for (int d = 0; d < DP; d += 8) {
    uint32_t ar[4], ah[4], al[4];
    ldmatrix_x4(ar, pa + d);
#pragma unroll
    for (int e = 0; e < 4; ++e)
      split_tf32(__uint_as_float(ar[e]), ah[e], al[e]);
#pragma unroll
    for (int n = 0; n < NT; n += 2) {
      uint32_t br[4];
      ldmatrix_x4(br, pb + n * 8 * LD + d);
#pragma unroll
      for (int h = 0; h < 2; ++h) {   // b0, b1 of column tile n + h
        uint32_t bh0, bl0, bh1, bl1;
        split_tf32(__uint_as_float(br[2 * h]), bh0, bl0);
        split_tf32(__uint_as_float(br[2 * h + 1]), bh1, bl1);
        mma_tf32(acc[n + h], al, bh0, bh1);
        mma_tf32(acc[n + h], ah, bl0, bl1);
        mma_tf32(acc[n + h], ah, bh0, bh1);
      }
    }
  }
}

// acc[j] += P (16 x 8NT, as C fragments p[NT]) . B[rows 0..8NT) of sB,
// columns 8j..8j+7 of sB (sB points at the first output column)
template <int NT, int OT, int LD>
__device__ __forceinline__ void warp_mma_pb(float (&acc)[OT][4],
                                            const float (&p)[NT][4],
                                            const __nv_bfloat16* sB) {
  const int lane = threadIdx.x & 31, mi = lane >> 3, r8 = lane & 7;
  const __nv_bfloat16* pb = sB + ((mi & 1) * 8 + r8) * LD + (mi >> 1) * 8;
  // step s: k chunk c = s / (OT / 2) (column tiles 2c, 2c + 1 of p),
  // output column tiles 2j, 2j + 1 with j = s % (OT / 2)
  constexpr int JP = OT / 2, STEPS = (NT / 2) * JP;
  uint32_t b[3][4];
  auto load = [&](int s) {
    ldmatrix_x4_trans(b[s % 3], pb + (s / JP) * 16 * LD + (s % JP) * 16);
  };
  load(0);
  if (STEPS > 1) load(1);
  uint32_t a[4];
#pragma unroll
  for (int s = 0; s < STEPS; ++s) {
    if (s + 2 < STEPS) load(s + 2);
    const int c = 2 * (s / JP), j = 2 * (s % JP);
    if (j == 0) {
      // the C fragments of column tiles c, c + 1 are the A fragment of
      // k 8c..8c+15
      a[0] = pack_bf16(p[c][0], p[c][1]);
      a[1] = pack_bf16(p[c][2], p[c][3]);
      a[2] = pack_bf16(p[c + 1][0], p[c + 1][1]);
      a[3] = pack_bf16(p[c + 1][2], p[c + 1][3]);
    }
    mma_bf16(acc[j], a, b[s % 3][0], b[s % 3][1]);
    mma_bf16(acc[j + 1], a, b[s % 3][2], b[s % 3][3]);
  }
}

template <int NT, int OT, int LD>
__device__ __forceinline__ void warp_mma_pb(float (&acc)[OT][4],
                                            const float (&p)[NT][4],
                                            const float* sB) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  // k of a step in the order (2t, 2t+1) -> (t, t + 4): the C fragment is
  // then the A fragment, and B is read in the same order
  const float* pb = sB + 2 * t * LD + g;
  constexpr int STEPS = NT * OT;   // step s: k tile s / OT, column tile s % OT
  float b[3][2];
  auto load = [&](int s) {
    const float* q = pb + (s / OT) * 8 * LD + (s % OT) * 8;
    b[s % 3][0] = q[0];
    b[s % 3][1] = q[LD];
  };
  load(0);
  load(1);
  uint32_t ah[4], al[4];
#pragma unroll
  for (int s = 0; s < STEPS; ++s) {
    if (s + 2 < STEPS) load(s + 2);
    const int c = s / OT, j = s % OT;
    if (j == 0) {
      split_tf32(p[c][0], ah[0], al[0]);
      split_tf32(p[c][2], ah[1], al[1]);
      split_tf32(p[c][1], ah[2], al[2]);
      split_tf32(p[c][3], ah[3], al[3]);
    }
    uint32_t bh0, bl0, bh1, bl1;
    split_tf32(b[s % 3][0], bh0, bl0);
    split_tf32(b[s % 3][1], bh1, bl1);
    mma_tf32(acc[j], al, bh0, bh1);
    mma_tf32(acc[j], ah, bl0, bl1);
    mma_tf32(acc[j], ah, bh0, bh1);
  }
}

// ---------------------------------------------------------------------------
// The same products with the left operand held in registers for a whole
// key walk (the flash forward's Q) and, in float32, both operands split
// into tf32 hi and lo once, ahead of the products: B as two planes of
// tf32 bits (uint32 [rows][LD], hi and lo) written when a tile is staged.
// ---------------------------------------------------------------------------

// The tf32 hi and lo A fragments of rows [r0, r0 + 16) x [0, DP) of a
// float32 [S, D] slab (zeros past S and D), each element split once.
template <int DP>
__device__ __forceinline__ void load_a_tf32x3(uint32_t (&ah)[DP / 8][4],
                                              uint32_t (&al)[DP / 8][4],
                                              const float* g, int r0, int S,
                                              int D) {
  const int lane = threadIdx.x & 31, gr = lane >> 2, t = lane & 3;
#pragma unroll
  for (int s = 0; s < DP / 8; ++s)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int r = r0 + gr + 8 * (e & 1), c = s * 8 + t + 4 * (e >> 1);
      const float x =
          (r < S && c < D) ? g[static_cast<int64_t>(r) * D + c] : 0.f;
      split_tf32(x, ah[s][e], al[s][e]);
    }
}

// n floats at p (a multiple of 4, 16-byte aligned) split in place: p
// keeps the tf32 hi bits, lo gets the lo bits. The block's threads share
// the work; the caller synchronises.
template <int NTH>
__device__ __forceinline__ void split_planes(float* p, uint32_t* lo, int n) {
  for (int i = threadIdx.x * 4; i < n; i += NTH * 4) {
    const float4 x = *reinterpret_cast<const float4*>(p + i);
    uint4 h, l;
    split_tf32(x.x, h.x, l.x);
    split_tf32(x.y, h.y, l.y);
    split_tf32(x.z, h.z, l.z);
    split_tf32(x.w, h.w, l.w);
    *reinterpret_cast<uint4*>(p + i) = h;
    *reinterpret_cast<uint4*>(lo + i) = l;
  }
}

// acc[n] += A (registers, 16 x DP) . B[rows 8n..8n+7 of sB][0, DP)^T,
// bf16; B's fragments are loaded one k step ahead
template <int NT, int DP, int LD>
__device__ __forceinline__ void warp_mma_rbt(float (&acc)[NT][4],
                                             const uint32_t (&a)[DP / 16][4],
                                             const __nv_bfloat16* sB) {
  const int lane = threadIdx.x & 31, mi = lane >> 3, r8 = lane & 7;
  const __nv_bfloat16* pb = sB + ((mi >> 1) * 8 + r8) * LD + (mi & 1) * 8;
  uint32_t b[2][NT / 2][4];
  auto load = [&](int s, int buf) {
#pragma unroll
    for (int n = 0; n < NT; n += 2)
      ldmatrix_x4(b[buf][n / 2], pb + n * 8 * LD + s * 16);
  };
  load(0, 0);
#pragma unroll
  for (int s = 0; s < DP / 16; ++s) {
    if (s + 1 < DP / 16) load(s + 1, (s + 1) & 1);
#pragma unroll
    for (int n = 0; n < NT; n += 2) {
      mma_bf16(acc[n], a[s], b[s & 1][n / 2][0], b[s & 1][n / 2][1]);
      mma_bf16(acc[n + 1], a[s], b[s & 1][n / 2][2], b[s & 1][n / 2][3]);
    }
  }
}

// acc[n] += A . B^T in 3xTF32: A's hi and lo fragments of k step s come
// from afrag(s, ah, al) (registers, or split planes in shared memory),
// B's from the planes sBh / sBl ([rows][LD] tf32 bits)
template <int NT, int DP, int LD, typename AFrag>
__device__ __forceinline__ void warp_mma_rbt_tf32x3(float (&acc)[NT][4],
                                                    AFrag afrag,
                                                    const uint32_t* sBh,
                                                    const uint32_t* sBl) {
  const int lane = threadIdx.x & 31, mi = lane >> 3, r8 = lane & 7;
  const int off = ((mi >> 1) * 8 + r8) * LD + (mi & 1) * 4;
  const uint32_t* pbh = sBh + off;
  const uint32_t* pbl = sBl + off;
#pragma unroll
  for (int s = 0; s < DP / 8; ++s) {
    uint32_t ah[4], al[4];
    afrag(s, ah, al);
#pragma unroll
    for (int n = 0; n < NT; n += 2) {
      uint32_t bh[4], bl[4];
      ldmatrix_x4(bh, pbh + n * 8 * LD + s * 8);
      ldmatrix_x4(bl, pbl + n * 8 * LD + s * 8);
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        mma_tf32(acc[n + h], al, bh[2 * h], bh[2 * h + 1]);
        mma_tf32(acc[n + h], ah, bl[2 * h], bl[2 * h + 1]);
        mma_tf32(acc[n + h], ah, bh[2 * h], bh[2 * h + 1]);
      }
    }
  }
}

// acc[j] += P (16 x 8NT, C fragments) . B[rows 0..8NT), columns 8j..8j+7,
// in 3xTF32 with B pre-split into the planes sBh / sBl: P is split here
// (once a k tile), B is not; k is permuted (2t, 2t+1) -> (t, t + 4) as
// in warp_mma_pb
template <int NT, int OT, int LD>
__device__ __forceinline__ void warp_mma_pb_tf32x3(float (&acc)[OT][4],
                                                   const float (&p)[NT][4],
                                                   const uint32_t* sBh,
                                                   const uint32_t* sBl) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const int off = 2 * t * LD + g;
  constexpr int STEPS = NT * OT;   // step s: k tile s / OT, column tile s % OT
  uint32_t b[3][4];
  auto load = [&](int s) {
    const int o = off + (s / OT) * 8 * LD + (s % OT) * 8;
    b[s % 3][0] = sBh[o];
    b[s % 3][1] = sBh[o + LD];
    b[s % 3][2] = sBl[o];
    b[s % 3][3] = sBl[o + LD];
  };
  load(0);
  if (STEPS > 1) load(1);
  uint32_t ah[4], al[4];
#pragma unroll
  for (int s = 0; s < STEPS; ++s) {
    if (s + 2 < STEPS) load(s + 2);
    const int c = s / OT, j = s % OT;
    if (j == 0) {
      split_tf32(p[c][0], ah[0], al[0]);
      split_tf32(p[c][2], ah[1], al[1]);
      split_tf32(p[c][1], ah[2], al[2]);
      split_tf32(p[c][3], ah[3], al[3]);
    }
    mma_tf32(acc[j], al, b[s % 3][0], b[s % 3][1]);
    mma_tf32(acc[j], ah, b[s % 3][2], b[s % 3][3]);
    mma_tf32(acc[j], ah, b[s % 3][0], b[s % 3][1]);
  }
}

}  // namespace mma
}  // namespace pt
