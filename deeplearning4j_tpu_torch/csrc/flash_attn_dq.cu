// Flash-attention backward, dq (FlashAttention-2), for Hopper (sm_90a),
// tensor cores (mma.sync tf32, 3xTF32 for f32 inputs), f32 accumulation.
//
// Replaces the TPU kernel deeplearning4j_tpu/ops/pallas_attention.py:152
// `_dq_kernel` (the dq `pallas_call` of `_run_bwd`, :248). Contract kept
// from it:
//   p  = exp(s - lse) with s = (q k^T) / sqrt(D), recomputed per KV tile
//        from the forward's natural-log lse (f32);
//   ds = p * (dp - Dvec), dp = dO v^T, Dvec = rowsum(dO * O) (computed
//        outside, from the forward's O, in f32);
//   dq = sum over keys of ds k / sqrt(D);
//   causal KV tiles past the diagonal are skipped, not masked;
//   a query row whose lse is NEG_INF (no valid key) gets p = 0 by a select
//   taken before any product (exp(s - lse) is inf there, and inf * 0 would
//   be NaN), so its dq is exactly 0.
// Not carried over: the TPU kernel pads T and D to 128 and pre-scales q by
// sqrt(Dp)/sqrt(D); here the scale is 1/sqrt(D) on s and on dq, D is a
// template bound (32/64/128/256, or the wide template past 256) with the
// tail zero-filled in shared memory, and the ragged T edge is masked
// inside the kernel.
//
// What bounds it on an H100: at the GPT training shape (B=32, H=8, T=256,
// D=64, causal, f32) the kernel does 6 D FLOP per causal (query, key) pair
// (s, dp and dq), 3.23 GFLOP, against 84.4 MB of q/k/v/dO/dq/lse/Dvec
// traffic. With the products on tensor cores in 3xTF32 (three TF32
// products per f32 product: 495 / 3 = 165 TFLOP/s) the operations take
// 0.0196 ms and the bytes 0.0252 ms at 3.35 TB/s: the bound is bytes,
// 0.0252 ms (it was 0.0483 ms by operations at the f32 CUDA-core peak).
// The design (the products' fragment layouts are in flash_mma.cuh):
//   * a 128-thread block owns 64 query rows, 16 per warp, and walks the
//     KV tiles of 32 keys up to the diagonal; s = q k^T and dp = dO v^T
//     are m16n8k8 tf32 mma.sync products from shared memory, and
//     ds = p (dp - Dvec) feeds dq += ds k from registers (the
//     accumulator-as-A-operand layout with the permuted key order),
//     accumulated in registers across the tiles;
//   * f32 operands are split into two tf32 halves as their fragments are
//     loaded (3xTF32, big by truncation: the split is two instructions,
//     where rounding both halves to nearest took a third of the kernel's
//     time); bf16 operands are exact in tf32, one product each, and p, ds
//     are rounded to tf32 once;
//   * one k step's products go to the tile's 8 accumulators in turn, so
//     consecutive mma.sync never wait on each other;
//   * K and V tiles are double-buffered with cp.async (zero fill past T
//     and D), the next tile's copies in flight while this one computes;
//     70 KB of shared memory and at most 170 registers (D = 64, f32) let
//     three blocks share an SM;
//   * at D = 256 two warps share 16 rows, each holding half of dq's
//     columns (64 registers, as at D = 128), and a block owns 32 rows
//     (128 threads, 195 KB of shared memory); both warps compute the
//     rows' whole s and dp: 10 D FLOP a pair, not 6;
//   * with a key mask, a KV tile whose keys are all invalid is skipped (a
//     block vote), and a warp skips a tile wholly past its rows' causal
//     diagonal; causal blocks are scheduled longest-first;
//   * the wide template (D > 256): a third grid axis cuts dq's columns
//     into chunks of 256; for each KV tile a block sums s and dp over all
//     of D, chunk by chunk of q, dO, k and v through shared memory (the
//     same order in every block), then dq += ds k for its chunk of k. s
//     and dp are recomputed once per chunk, nothing is double-buffered.
// One block per (batch x head, query tile, column chunk) writes its own
// dq: no atomics, so two launches on the same inputs are bitwise equal.
// Measured on an NVIDIA H100 80GB HBM3 at its 700 W power limit
// (chip_smoke.py, tools/flash_ab.py; PERF.md): 0.089 ms at the
// shape above, 3.5x the bound, where the CUDA-core version it replaced
// took 0.193 ms in the same process; with K6 0.212 ms against 0.31-0.35
// ms for SDPA's whole backward.

#include "flash_mma.cuh"

#include <cmath>

namespace {

using namespace flash_mma;

constexpr int BK = 32;        // keys per KV tile
constexpr int BQ_MIN = 32;    // the fewest query rows a block owns

// Warps that share 16 query rows, each accumulating DMAX / DSPLIT of dq's
// columns: two at DMAX = 256, so that dq takes 64 registers a thread
template <int DMAX>
__host__ __device__ constexpr int dsplit() {
  return DMAX > 128 ? 2 : 1;
}
// Warps of 16 query rows a block: 4 (64 rows); 2 at DMAX = 256, so that
// the tiles fit in shared memory and a short batch still spreads over
// the SMs
template <int DMAX>
__host__ __device__ constexpr int row_warps() {
  return DMAX > 128 ? 2 : 4;
}
template <int DMAX>
__host__ __device__ constexpr int q_rows() {
  return 16 * row_warps<DMAX>();
}
template <int DMAX>
__host__ __device__ constexpr int threads() {
  return 32 * row_warps<DMAX>() * dsplit<DMAX>();
}

// Q and dO, two stages of K and V, two stages of key validity: 70 KB at
// D = 64 in f32, so three blocks share an SM; 195 KB at D = 256
template <typename T, int DMAX>
constexpr size_t smem_bytes() {
  return sizeof(T) * (size_t)((2 * q_rows<DMAX>() + 4 * BK) *
                              row_stride<T, DMAX>()) +
         sizeof(float) * 2 * BK;
}

// q, k, v, dO, dq: [BH, T, D] contiguous; kv_mask: [BH / H, T] (> 0 = valid
// key) or null; lse, dvec: [BH, T] f32. WIDE (DMAX = 256, D > 256): the
// block owns dq's columns blockIdx.z * DMAX onwards, one chunk of DMAX, and
// sums s and dp over all of D chunk by chunk.
template <typename T, int DMAX, bool WIDE>
__global__ void __launch_bounds__(threads<DMAX>(), DMAX > 64 ? 1 : 3)
flash_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
                const T* __restrict__ v, const float* __restrict__ kv_mask,
                const T* __restrict__ dO, const float* __restrict__ lse,
                const float* __restrict__ dvec, T* __restrict__ dq, int H,
                int Tn, int D, int causal, float scale, int vec) {
  constexpr bool SPLIT = std::is_same<T, float>::value;
  constexpr int S = row_stride<T, DMAX>();
  constexpr int NT = threads<DMAX>();
  constexpr int BQ = q_rows<DMAX>();
  constexpr int RW = row_warps<DMAX>();
  constexpr int NKC = BK / 8;     // 8-key n-tiles per tile
  constexpr int NDW = DMAX / 8 / dsplit<DMAX>();  // this warp's dq n-tiles
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* sQ = reinterpret_cast<T*>(smem_raw);  // [BQ][S]
  T* sdO = sQ + BQ * S;                    // [BQ][S]
  T* sK = sdO + BQ * S;                    // [2][BK][S]
  T* sV = sK + 2 * BK * S;                 // [2][BK][S]
  float* sValid = reinterpret_cast<float*>(sV + 2 * BK * S);  // [2][BK]

  const int bh = blockIdx.x;
  const int n_q = (Tn + BQ - 1) / BQ;
  const int q0 = (n_q - 1 - (int)blockIdx.y) * BQ;
  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31, g = lane >> 2, t = lane & 3;
  const int rw = warp % RW;               // this warp's 16 rows
  const int d0 = (warp / RW) * 8 * NDW;  // and its first dq column
  const int dc = WIDE ? (int)blockIdx.z * DMAX : 0;  // of the block's chunk
  const size_t base = (size_t)bh * Tn * D;
  const size_t rbase = (size_t)bh * Tn;
  const float* mrow = kv_mask ? kv_mask + (size_t)(bh / H) * Tn : nullptr;

  if constexpr (!WIDE) {
    load_rows<T, DMAX, BQ, NT>(sQ, q + base, q0, Tn, D, vec, tid);
    load_rows<T, DMAX, BQ, NT>(sdO, dO + base, q0, Tn, D, vec, tid);
  }

  // this thread's two rows: r0 (accumulator slots 0, 1) and r0 + 8 (2, 3)
  const int r0 = rw * 16 + g;
  float row_lse[2], row_dvec[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int tq = q0 + r0 + 8 * h;
    row_lse[h] = tq < Tn ? lse[rbase + tq] : NEG_INF;
    row_dvec[h] = tq < Tn ? dvec[rbase + tq] : 0.f;
  }

  float acc[NDW][4];
#pragma unroll
  for (int j = 0; j < NDW; ++j)
#pragma unroll
    for (int i = 0; i < 4; ++i) acc[j][i] = 0.f;

  auto prefetch = [&](int kt, int stage) {
    const int k0 = kt * BK;
    load_rows<T, DMAX, BK, NT>(sK + stage * BK * S, k + base, k0, Tn, D, vec,
                               tid);
    load_rows<T, DMAX, BK, NT>(sV + stage * BK * S, v + base, k0, Tn, D, vec,
                               tid);
    if (tid < BK) {
      const int key = k0 + tid;
      sValid[stage * BK + tid] =
          (key < Tn && (mrow == nullptr || mrow[key] > 0.f)) ? 1.f : 0.f;
    }
  };

  // s += q k^T and dp += dO v^T over the DMAX columns of the tiles in
  // shared memory; the split products of one k step go to the 2 NKC
  // accumulators in turn
  auto add_s_dp = [&](const T* Ks, const T* Vs, float (&s)[NKC][4],
                      float (&dp)[NKC][4]) {
#pragma unroll
    for (int kk = 0; kk < DMAX; kk += 8) {
      uint32_t qb[4], qs[4], ob[4], os[4];
      load_a<SPLIT>(sQ, S, r0, kk, t, qb, qs);
      load_a<SPLIT>(sdO, S, r0, kk, t, ob, os);
      uint32_t kb[NKC][2], ks[NKC][2], vb[NKC][2], vs[NKC][2];
#pragma unroll
      for (int j = 0; j < NKC; ++j) {
        load_bt<SPLIT>(Ks, S, 8 * j, kk, g, t, kb[j], ks[j]);
        load_bt<SPLIT>(Vs, S, 8 * j, kk, g, t, vb[j], vs[j]);
      }
      if (SPLIT) {
#pragma unroll
        for (int j = 0; j < NKC; ++j) {
          mma_tf32(s[j], qs, kb[j]);
          mma_tf32(dp[j], os, vb[j]);
        }
#pragma unroll
        for (int j = 0; j < NKC; ++j) {
          mma_tf32(s[j], qb, ks[j]);
          mma_tf32(dp[j], ob, vs[j]);
        }
      }
#pragma unroll
      for (int j = 0; j < NKC; ++j) {
        mma_tf32(s[j], qb, kb[j]);
        mma_tf32(dp[j], ob, vb[j]);
      }
    }
  };
  // The wide template's product, one at a time (fewer registers):
  // acc += A B^T over columns [kk0, kk1), A this warp's 16 query rows of
  // q or dO, B the tile's keys of k or v
  auto add_abt = [&](const T* As, const T* Bs, float (&acc)[NKC][4],
                     int kk0, int kk1) {
#pragma unroll
    for (int kk = kk0; kk < kk1; kk += 8) {
      uint32_t ab[4], as[4];
      load_a<SPLIT>(As, S, r0, kk, t, ab, as);
      uint32_t bb[NKC][2], bs[NKC][2];
#pragma unroll
      for (int j = 0; j < NKC; ++j)
        load_bt<SPLIT>(Bs, S, 8 * j, kk, g, t, bb[j], bs[j]);
      if (SPLIT) {
#pragma unroll
        for (int j = 0; j < NKC; ++j) mma_tf32(acc[j], as, bb[j]);
#pragma unroll
        for (int j = 0; j < NKC; ++j) mma_tf32(acc[j], ab, bs[j]);
      }
#pragma unroll
      for (int j = 0; j < NKC; ++j) mma_tf32(acc[j], ab, bb[j]);
    }
  };

  // ds = p (dp - Dvec) from s and dp, gated by a select before any
  // product, then dq += ds k over the tile's keys (Ks, valid: the tile in
  // shared memory, dq's columns of k), ds from registers, four dq column
  // tiles in turn
  auto add_ds_k = [&](float (&s)[NKC][4], const float (&dp)[NKC][4],
                      const T* Ks, const float* valid, int k0) {
#pragma unroll
    for (int j = 0; j < NKC; ++j)
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int h = i >> 1;
        const int key = 8 * j + 2 * t + (i & 1);
        const bool ok = row_lse[h] > NEG_INF / 2 && valid[key] != 0.f &&
                        (!causal || k0 + key <= q0 + r0 + 8 * h);
        const float p = ok ? expf(s[j][i] * scale - row_lse[h]) : 0.f;
        s[j][i] = p * (dp[j][i] - row_dvec[h]);
      }
#pragma unroll
    for (int j = 0; j < NKC; ++j) {
      uint32_t ab[4], as[4];
      acc_as_a<SPLIT>(s[j], ab, as);
#pragma unroll
      for (int n0 = 0; n0 < NDW; n0 += 4) {
        uint32_t bb[4][2], bs[4][2];
#pragma unroll
        for (int i = 0; i < 4; ++i)
          mma_pair_b<SPLIT>(Ks, S, 8 * j, d0 + 8 * (n0 + i), g, t, bb[i],
                            bs[i]);
        if (SPLIT) {
#pragma unroll
          for (int i = 0; i < 4; ++i) mma_tf32(acc[n0 + i], as, bb[i]);
#pragma unroll
          for (int i = 0; i < 4; ++i) mma_tf32(acc[n0 + i], ab, bs[i]);
        }
#pragma unroll
        for (int i = 0; i < 4; ++i) mma_tf32(acc[n0 + i], ab, bb[i]);
      }
    }
  };

  const int n_kv = (Tn + BK - 1) / BK;
  const int kv_end = causal ? min(n_kv, (q0 + BQ - 1) / BK + 1) : n_kv;
  int kt = next_tile<BK>(0, kv_end, mrow, Tn, tid);
  if constexpr (!WIDE) {
    if (kt < kv_end) prefetch(kt, 0);
  }
  cp_async_commit();
  int stage = 0;
  while (kt < kv_end) {
    const int kn = next_tile<BK>(kt + 1, kv_end, mrow, Tn, tid);
    const int k0 = kt * BK;
    // a tile wholly past this warp's last row's diagonal adds nothing
    const bool active = !causal || k0 <= q0 + rw * 16 + 15;
    if constexpr (WIDE) {
      // s and dp over all of D: chunk c of q, dO and the tile's k, v
      // through shared memory, c = 0, 1, ... in every block; for f32,
      // every WIDE_SPAN columns' products in fresh accumulators, joined by
      // f32 adds (as K4's); bf16 sums in s and dp themselves (as K6's)
      float s[NKC][4] = {}, dp[NKC][4] = {};
      const int nch = n_chunks<DMAX>(D);
      for (int c = 0; c < nch; ++c) {
        const int c0 = c * DMAX;
        load_rows<T, DMAX, BQ, NT>(sQ, q + base, q0, Tn, D, vec, tid, c0);
        load_rows<T, DMAX, BQ, NT>(sdO, dO + base, q0, Tn, D, vec, tid, c0);
        load_rows<T, DMAX, BK, NT>(sK, k + base, k0, Tn, D, vec, tid, c0);
        load_rows<T, DMAX, BK, NT>(sV, v + base, k0, Tn, D, vec, tid, c0);
        cp_async_commit();
        cp_async_wait<0>();
        __syncthreads();
        if (active && !SPLIT) {
          add_abt(sQ, sK, s, 0, DMAX);
          add_abt(sdO, sV, dp, 0, DMAX);
        } else if (active) {
#pragma unroll
          for (int kk = 0; kk < DMAX; kk += WIDE_SPAN) {
            float pc[NKC][4] = {};
            add_abt(sQ, sK, pc, kk, kk + WIDE_SPAN);
#pragma unroll
            for (int j = 0; j < NKC; ++j)
#pragma unroll
              for (int i = 0; i < 4; ++i) {
                s[j][i] += pc[j][i];
                pc[j][i] = 0.f;
              }
            add_abt(sdO, sV, pc, kk, kk + WIDE_SPAN);
#pragma unroll
            for (int j = 0; j < NKC; ++j)
#pragma unroll
              for (int i = 0; i < 4; ++i) dp[j][i] += pc[j][i];
          }
        }
        __syncthreads();  // every warp is done with this chunk
      }
      // this block's chunk of k, and the tile's key validity
      load_rows<T, DMAX, BK, NT>(sK, k + base, k0, Tn, D, vec, tid, dc);
      if (tid < BK) {
        const int key = k0 + tid;
        sValid[tid] =
            (key < Tn && (mrow == nullptr || mrow[key] > 0.f)) ? 1.f : 0.f;
      }
      cp_async_commit();
      cp_async_wait<0>();
      __syncthreads();
      if (active) add_ds_k(s, dp, sK, sValid, k0);
    } else {
      if (kn < kv_end) prefetch(kn, stage ^ 1);
      cp_async_commit();
      cp_async_wait<1>();  // this tile (and Q, dO) have landed
      __syncthreads();
      if (active) {
        // s = q k^T and dp = dO v^T for the tile's keys
        float s[NKC][4], dp[NKC][4];
#pragma unroll
        for (int j = 0; j < NKC; ++j)
#pragma unroll
          for (int i = 0; i < 4; ++i) s[j][i] = dp[j][i] = 0.f;
        add_s_dp(sK + stage * BK * S, sV + stage * BK * S, s, dp);
        add_ds_k(s, dp, sK + stage * BK * S, sValid + stage * BK, k0);
      }
      stage ^= 1;
    }
    __syncthreads();  // every warp is done with this stage
    kt = kn;
  }
  cp_async_wait<0>();

#pragma unroll
  for (int n = 0; n < NDW; ++n)
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int tq = q0 + r0 + 8 * (i >> 1);
      const int d = dc + d0 + 8 * n + 2 * t + (i & 1);
      if (tq < Tn && d < D)
        store(&dq[base + (size_t)tq * D + d], acc[n][i] * scale);
    }
}

template <typename T, int DMAX, bool WIDE = false>
cudaError_t launch(const void* q, const void* k, const void* v,
                   const void* kv_mask, const void* dO, const void* lse,
                   const void* dvec, void* dq, int BH, int H, int Tn, int D,
                   int causal, int vec, cudaStream_t stream) {
  constexpr size_t smem = smem_bytes<T, DMAX>();
  auto kern = flash_dq_kernel<T, DMAX, WIDE>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid(BH, (Tn + q_rows<DMAX>() - 1) / q_rows<DMAX>(),
                  WIDE ? n_chunks<DMAX>(D) : 1);
  kern<<<grid, threads<DMAX>(), smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const float*>(kv_mask),
      static_cast<const T*>(dO), static_cast<const float*>(lse),
      static_cast<const float*>(dvec), static_cast<T*>(dq), H, Tn, D, causal,
      1.0f / sqrtf((float)D), vec);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_d(const void* q, const void* k, const void* v,
                     const void* kv_mask, const void* dO, const void* lse,
                     const void* dvec, void* dq, int BH, int H, int Tn, int D,
                     int causal, cudaStream_t stream) {
  // cp.async moves 16-byte pieces: rows of a whole number of them, and
  // 16-byte aligned tensors
  const int vec = (D * (int)sizeof(T)) % 16 == 0 &&
                  ((uintptr_t)q | (uintptr_t)k | (uintptr_t)v |
                   (uintptr_t)dO) % 16 == 0;
  if (D <= 32)
    return launch<T, 32>(q, k, v, kv_mask, dO, lse, dvec, dq, BH, H, Tn, D,
                         causal, vec, stream);
  if (D <= 64)
    return launch<T, 64>(q, k, v, kv_mask, dO, lse, dvec, dq, BH, H, Tn, D,
                         causal, vec, stream);
  if (D <= 128)
    return launch<T, 128>(q, k, v, kv_mask, dO, lse, dvec, dq, BH, H, Tn, D,
                          causal, vec, stream);
  if (D <= 256)
    return launch<T, 256>(q, k, v, kv_mask, dO, lse, dvec, dq, BH, H, Tn, D,
                          causal, vec, stream);
  return launch<T, 256, true>(q, k, v, kv_mask, dO, lse, dvec, dq, BH, H, Tn,
                              D, causal, vec, stream);
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (q, k, v, dO and dq share it; lse and
// dvec are f32). Returns the CUDA error of the launch (0 = launched).
extern "C" int dl4j_flash_attn_dq(const void* q, const void* k, const void* v,
                                  const void* kv_mask, const void* dO,
                                  const void* lse, const void* dvec, void* dq,
                                  int BH, int H, int Tn, int D, int causal,
                                  int dtype, void* stream) {
  if (BH < 1 || H < 1 || BH % H || Tn < 1 ||
      (Tn + BQ_MIN - 1) / BQ_MIN > 65535 || D < 1 ||
      n_chunks<256>(D) > 65535 || (dtype != 0 && dtype != 1))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return (int)launch_d<float>(q, k, v, kv_mask, dO, lse, dvec, dq, BH, H,
                                Tn, D, causal, s);
  return (int)launch_d<__nv_bfloat16>(q, k, v, kv_mask, dO, lse, dvec, dq, BH,
                                      H, Tn, D, causal, s);
}
