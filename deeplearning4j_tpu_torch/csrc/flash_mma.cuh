// Tensor-core building blocks shared by the flash-attention kernels
// (flash_attn_fwd.cu, flash_attn_dq.cu, flash_attn_dkv.cu), for Hopper
// (sm_90a):
// mma.sync m16n8k8 tf32 with f32 accumulation, the 3xTF32 split, cp.async
// tile loads with zero fill, the shared-memory row stride, and the block
// vote that skips KV tiles with no valid key.
//
// Fragment layout of mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32,
// lane = 4 g + t (g = lane / 4 in 0..7, t = lane % 4):
//   A (16 x 8, row-major): a0 (g, t), a1 (g + 8, t), a2 (g, t + 4),
//                          a3 (g + 8, t + 4)
//   B (8 x 8, k x n):      b0 (k = t, n = g), b1 (k = t + 4, n = g)
//   C (16 x 8, f32):       c0 (g, 2t), c1 (g, 2t + 1), c2 (g + 8, 2t),
//                          c3 (g + 8, 2t + 1)
// So an accumulator tile feeds the next product as its A operand from
// registers (a0 = c0, a1 = c2, a2 = c1, a3 = c3) if the 8 columns are taken
// in the order 0, 2, 4, 6, 1, 3, 5, 7: k-slot t holds column 2t and slot
// t + 4 column 2t + 1. The B operand of that product is loaded in the same
// order (rows 2t and 2t + 1 of the 8), which `mma_pair_b` below encodes.
//
// Precision. f32 operands are split x = big + small: big is x with the
// low 13 bits cleared (a tf32 value, x rounded toward zero), small = x - big
// (exact in f32), of which the tensor core reads the top 19 bits. A product
// is a_small b_big + a_big b_small + a_big b_big, each term on the tensor
// cores with f32 accumulation (3xTF32): x is kept to about 2^-20 of |x|,
// near f32 accuracy, at a third of the TF32 rate. Rounding big and small
// to nearest (cvt.rna.tf32.f32, 2^-22) cost the kernels a third of their
// time for errors of the same size (PERF.md). A bf16 value has an
// 8-bit mantissa and is exact in tf32 (10 bits), so bf16 operands need one
// product; a computed f32 operand (p, ds) of a bf16 call is rounded to
// tf32 once, to nearest.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>
#include <type_traits>

namespace flash_mma {

constexpr float NEG_INF = -1e30f;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16(x);
}
template <typename T>
__device__ __forceinline__ T zero();
template <>
__device__ __forceinline__ float zero<float>() { return 0.f; }
template <>
__device__ __forceinline__ __nv_bfloat16 zero<__nv_bfloat16>() {
  return __float2bfloat16(0.f);
}

// Shared-memory row stride in elements: 16 bytes past DMAX, so a row
// starts 16-byte aligned (cp.async) and its stride in 32-bit words is 4
// mod 8 (DMAX = 32, 64, 128, 256). A warp's fragment reads, (row g, col t) and
// the permuted (row 2t or 2t + 1, col g), then fall in different banks
// (bf16 lanes that share a word read it together).
template <typename T, int DMAX>
__host__ __device__ constexpr int row_stride() {
  return DMAX + 16 / (int)sizeof(T);
}

__device__ __forceinline__ uint32_t rna_tf32(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(r) : "f"(x));
  return r;
}

// One operand value as tensor-core inputs. SPLIT (f32 inputs): big and
// small halves. Otherwise a value that is exact in tf32 (it came from a
// bf16 tensor) passes as it is.
template <bool SPLIT>
__device__ __forceinline__ void frag(float x, uint32_t& big,
                                     uint32_t& small) {
  if (SPLIT) {
    big = __float_as_uint(x) & 0xffffe000u;
    small = __float_as_uint(x - __uint_as_float(big));
  } else {
    big = __float_as_uint(x);
    small = 0u;
  }
}

// A computed f32 operand (p or ds): split for f32 calls, rounded to tf32
// once for bf16 calls.
template <bool SPLIT>
__device__ __forceinline__ void frag_computed(float x, uint32_t& big,
                                              uint32_t& small) {
  if (SPLIT) {
    frag<true>(x, big, small);
  } else {
    big = rna_tf32(x);
    small = 0u;
  }
}

// d += A B, one m16n8k8 tf32 product with f32 accumulation.
__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// A fragment of rows r0, r0 + 8 and columns c0 + t, c0 + t + 4 of a
// row-major shared-memory tile with row stride S.
template <bool SPLIT, typename T>
__device__ __forceinline__ void load_a(const T* s, int S, int r0, int c0,
                                       int t, uint32_t (&big)[4],
                                       uint32_t (&small)[4]) {
  frag<SPLIT>(to_f32(s[r0 * S + c0 + t]), big[0], small[0]);
  frag<SPLIT>(to_f32(s[(r0 + 8) * S + c0 + t]), big[1], small[1]);
  frag<SPLIT>(to_f32(s[r0 * S + c0 + t + 4]), big[2], small[2]);
  frag<SPLIT>(to_f32(s[(r0 + 8) * S + c0 + t + 4]), big[3], small[3]);
}

// B fragment of C = A X^T, X a row-major tile (rows are the n index):
// b0 = X[n0 + g][c0 + t], b1 = X[n0 + g][c0 + t + 4].
template <bool SPLIT, typename T>
__device__ __forceinline__ void load_bt(const T* s, int S, int n0, int c0,
                                        int g, int t, uint32_t (&b)[2],
                                        uint32_t (&bs)[2]) {
  frag<SPLIT>(to_f32(s[(n0 + g) * S + c0 + t]), b[0], bs[0]);
  frag<SPLIT>(to_f32(s[(n0 + g) * S + c0 + t + 4]), b[1], bs[1]);
}

// B fragment of C = P X with P's 8 k columns in the permuted order (slot t
// = row 2t of X, slot t + 4 = row 2t + 1): b0 = X[k0 + 2t][n0 + g],
// b1 = X[k0 + 2t + 1][n0 + g].
template <bool SPLIT, typename T>
__device__ __forceinline__ void mma_pair_b(const T* s, int S, int k0, int n0,
                                           int g, int t, uint32_t (&b)[2],
                                           uint32_t (&bs)[2]) {
  frag<SPLIT>(to_f32(s[(k0 + 2 * t) * S + n0 + g]), b[0], bs[0]);
  frag<SPLIT>(to_f32(s[(k0 + 2 * t + 1) * S + n0 + g]), b[1], bs[1]);
}

// An accumulator tile (c0..c3) as the A operand of the next product, in
// the permuted column order.
template <bool SPLIT>
__device__ __forceinline__ void acc_as_a(const float (&c)[4],
                                         uint32_t (&big)[4],
                                         uint32_t (&small)[4]) {
  frag_computed<SPLIT>(c[0], big[0], small[0]);
  frag_computed<SPLIT>(c[2], big[1], small[1]);
  frag_computed<SPLIT>(c[1], big[2], small[2]);
  frag_computed<SPLIT>(c[3], big[3], small[3]);
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           int src_bytes) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
               "l"(src), "r"(src_bytes));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// The first KV tile of BK keys at or after j with a valid key (every tile,
// without a mask). A block-wide vote: every thread of the block (at least
// BK of them) calls it with the same j.
template <int BK>
__device__ __forceinline__ int next_tile(int j, int end,
                                         const float* __restrict__ mrow,
                                         int Tn, int tid) {
  if (mrow == nullptr) return j;
  for (; j < end; ++j) {
    const int key = j * BK + tid;
    if (__syncthreads_or(tid < BK && key < Tn && mrow[key] > 0.f)) break;
  }
  return j;
}

// Rows t0 .. t0 + ROWS - 1 of a [Tn, D] tensor, columns c0 .. c0 + DMAX - 1
// (c0 = 0, or a multiple of DMAX in the wide template), into a [ROWS][S]
// shared tile, zero past Tn and past D. vec: D * sizeof(T) is a multiple
// of 16 and the tensor 16-byte aligned, so the copy is asynchronous
// (cp.async, zero fill); otherwise element by element.
template <typename T, int DMAX, int ROWS, int NT>
__device__ __forceinline__ void load_rows(T* dst, const T* src, int t0,
                                          int Tn, int D, bool vec, int tid,
                                          int c0 = 0) {
  constexpr int S = row_stride<T, DMAX>();
  src += c0;
  const int DC = D - c0;  // columns left from c0 on
  if (vec) {
    constexpr int V = 16 / (int)sizeof(T);
    constexpr int CPR = DMAX / V;
    for (int i = tid; i < ROWS * CPR; i += NT) {
      const int r = i / CPR, d = (i % CPR) * V, t = t0 + r;
      const bool in = t < Tn && d < DC;
      cp_async16(dst + r * S + d, in ? src + (size_t)t * D + d : src,
                 in ? 16 : 0);
    }
  } else {
    for (int i = tid; i < ROWS * DMAX; i += NT) {
      const int r = i / DMAX, d = i % DMAX, t = t0 + r;
      dst[r * S + d] =
          (t < Tn && d < DC) ? src[(size_t)t * D + d] : zero<T>();
    }
  }
}

// Column chunks of DMAX that a head of D columns spans (the wide template
// sums s = q k^T over all of them, one at a time, in this order)
template <int DMAX>
__host__ __device__ constexpr int n_chunks(int D) {
  return (D + DMAX - 1) / DMAX;
}
// Columns the wide template sums (f32 inputs) in one mma accumulator before
// joining the product to s by an f32 add: the tensor cores' accumulation over
// a wide head drifted (4e-5 in O at D = 1024 against the 2e-5 gate)
constexpr int WIDE_SPAN = 64;

}  // namespace flash_mma
