// Flash-attention backward, dk and dv (FlashAttention-2), for Hopper
// (sm_90a), tensor cores (mma.sync tf32, 3xTF32 for f32 inputs), f32
// accumulation.
//
// Replaces the TPU kernel deeplearning4j_tpu/ops/pallas_attention.py:192
// `_dkv_kernel` (the dk/dv `pallas_call` of `_run_bwd`, :258). Contract
// kept from it: per KV tile, looping the query tiles from the diagonal
// (causal) or from 0,
//   p  = exp(s - lse), s = (q k^T) / sqrt(D), from the forward's lse;
//   dv = sum over queries of p^T dO;
//   ds = p * (dp - Dvec), dp = dO v^T, Dvec = rowsum(dO * O) (f32, outside);
//   dk = sum over queries of ds^T q / sqrt(D);
//   a query row whose lse is NEG_INF (no valid key) gets p = 0 by a select
//   taken before any product, so it adds exactly nothing to dk and dv.
// Not carried over: the TPU kernel's T and D padding to 128 and its
// sqrt(Dp)/sqrt(D) pre-scale of q; here the scale is 1/sqrt(D) on s and on
// dk, D is a template bound (32/64/128/256, or the wide template past 256)
// with the tail zero-filled in shared memory, and the ragged T edge is
// masked inside the kernel.
//
// What bounds it on an H100: at the GPT training shape (B=32, H=8, T=256,
// D=64, causal, f32) it does 8 D FLOP per causal (query, key) pair (s, dp,
// dv and dk), 4.31 GFLOP, against 101.2 MB of traffic. On tensor cores in
// 3xTF32 (165 TFLOP/s) the operations take 0.0261 ms and the bytes
// 0.0302 ms: the bound is bytes, 0.0302 ms (0.0644 ms by operations at
// the f32 CUDA-core peak). The design (fragment layouts in flash_mma.cuh):
//   * a block owns 64 keys, 16 per warp group; their k and v tiles stay
//     in shared memory for the whole block, and a warp's dk and dv
//     [16, D] f32 accumulators live in mma fragments; s^T = k q^T and
//     dp^T = v dO^T come out with the keys as rows, so p^T and ds^T are
//     already the A operands of dv += p^T dO and dk += ds^T q, fed from
//     registers in the permuted query order. At D = 128 two warps share a
//     16-key group (256 threads), each holding half of dk's and dv's
//     columns, 64 registers, where one warp would spill. At D = 256 four
//     warps share a group and a block owns 32 keys (256 threads, 195 KB
//     of shared memory); each warp computes its group's whole s^T and
//     dp^T: 20 D FLOP a pair, not 8;
//   * f32 operands are split into two tf32 halves as their fragments are
//     loaded (3xTF32, big by truncation); bf16 operands are exact in tf32,
//     and p, ds are rounded to tf32 once; one k step's products go to
//     independent accumulators in turn;
//   * the query tiles of 32 rows (q, dO, lse, Dvec) stream through shared
//     memory, double-buffered with cp.async; 70 KB of shared memory and at
//     most 170 registers (D = 64, f32) let three blocks share an SM; a
//     warp skips a tile wholly before its keys' causal diagonal;
//   * with a key mask, a block whose 64 keys are all invalid writes zeros
//     and returns (a block vote); causal blocks are scheduled longest-first
//     (KV tile 0 first: it sees every query tile);
//   * the wide template (D > 256): a third grid axis cuts dk's and dv's
//     columns into chunks of 256; for each query tile a block sums s^T and
//     dp^T over all of D, chunk by chunk of its keys' k, v and the tile's
//     q, dO through shared memory (the same order in every block), then
//     dv += p^T dO and dk += ds^T q for its chunk of q and dO. s and dp are
//     recomputed once per chunk, nothing is double-buffered.
// One block per (batch x head, KV tile, column chunk) writes its own dk/dv
// rows: no atomics, so two launches on the same inputs are bitwise equal.
// Measured on an NVIDIA H100 80GB HBM3 at its 700 W power limit
// (chip_smoke.py, tools/flash_ab.py; PERF.md): 0.123 ms at the
// shape above, 4.1x the bound, where the CUDA-core version it replaced
// took 0.246 ms in the same process; with K5 0.212 ms against 0.31-0.35
// ms for SDPA's whole backward.

#include "flash_mma.cuh"

#include <cmath>

namespace {

using namespace flash_mma;

constexpr int BQ = 32;        // query rows per streamed tile
constexpr int BK_MIN = 32;    // the fewest keys a block owns (DMAX = 256)

// Keys per block: 64, four 16-key groups; 32 at DMAX = 256.
template <int DMAX>
__host__ __device__ constexpr int kv_block() {
  return DMAX > 128 ? 32 : 64;
}
// Warps that share a 16-key group, each accumulating D / DSPLIT columns
// of its dk and dv: two at DMAX = 128 and four at 256, so that dk and dv
// take 64 registers a thread, not 128 or 256.
template <int DMAX>
__host__ __device__ constexpr int dsplit() {
  return DMAX > 128 ? 4 : DMAX > 64 ? 2 : 1;
}
template <int DMAX>
__host__ __device__ constexpr int threads() {
  return 2 * kv_block<DMAX>() * dsplit<DMAX>();  // 32 per 16-key group
}

// K and V, two stages of q and dO, two of lse and Dvec: 70 KB at D = 64
// in f32, so three blocks share an SM; 195 KB at D = 256
template <typename T, int DMAX>
constexpr size_t smem_bytes() {
  return sizeof(T) * (size_t)((2 * kv_block<DMAX>() + 4 * BQ) *
                              row_stride<T, DMAX>()) +
         sizeof(float) * 4 * BQ;
}

// q, k, v, dO, dk, dv: [BH, T, D] contiguous; kv_mask: [BH / H, T] (> 0 =
// valid key) or null; lse, dvec: [BH, T] f32. WIDE (DMAX = 256, D > 256):
// the block owns dk's and dv's columns blockIdx.z * DMAX onwards, one chunk
// of DMAX, and sums s^T and dp^T over all of D chunk by chunk.
template <typename T, int DMAX, bool WIDE>
__global__ void __launch_bounds__(threads<DMAX>(), DMAX > 64 ? 1 : 3)
flash_dkv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, const float* __restrict__ kv_mask,
                 const T* __restrict__ dO, const float* __restrict__ lse,
                 const float* __restrict__ dvec, T* __restrict__ dk,
                 T* __restrict__ dv, int H, int Tn, int D, int causal,
                 float scale, int vec) {
  constexpr bool SPLIT = std::is_same<T, float>::value;
  constexpr int S = row_stride<T, DMAX>();
  constexpr int NT = threads<DMAX>();
  constexpr int BK = kv_block<DMAX>();
  constexpr int NKW = BK / 16;              // 16-key groups
  constexpr int NQC = BQ / 8;               // 8-query n-tiles per tile
  constexpr int NDW = DMAX / 8 / dsplit<DMAX>();  // this warp's column tiles
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* sK = reinterpret_cast<T*>(smem_raw);  // [BK][S]
  T* sV = sK + BK * S;                     // [BK][S]
  T* sQ = sV + BK * S;                     // [2][BQ][S]
  T* sdO = sQ + 2 * BQ * S;                // [2][BQ][S]
  float* sLse = reinterpret_cast<float*>(sdO + 2 * BQ * S);  // [2][BQ]
  float* sDvec = sLse + 2 * BQ;                              // [2][BQ]

  const int bh = blockIdx.x;
  const int k0 = (int)blockIdx.y * BK;
  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31, g = lane >> 2, t = lane & 3;
  const int kw = warp % NKW;              // this warp's 16-key group
  const int d0 = (warp / NKW) * 8 * NDW;  // and its first dk / dv column
  const int dc = WIDE ? (int)blockIdx.z * DMAX : 0;  // of the block's chunk
  const size_t base = (size_t)bh * Tn * D;
  const size_t rbase = (size_t)bh * Tn;
  const float* mrow = kv_mask ? kv_mask + (size_t)(bh / H) * Tn : nullptr;

  if (mrow != nullptr &&
      !__syncthreads_or(tid < BK && k0 + tid < Tn && mrow[k0 + tid] > 0.f)) {
    // no valid key in this block: its dk and dv rows are exactly 0
    for (int i = tid; i < BK * DMAX; i += NT) {
      const int tk = k0 + i / DMAX, d = dc + i % DMAX;
      if (tk < Tn && d < D) {
        store(&dk[base + (size_t)tk * D + d], 0.f);
        store(&dv[base + (size_t)tk * D + d], 0.f);
      }
    }
    return;
  }

  if (!WIDE) {
    load_rows<T, DMAX, BK, NT>(sK, k + base, k0, Tn, D, vec, tid);
    load_rows<T, DMAX, BK, NT>(sV, v + base, k0, Tn, D, vec, tid);
  }

  // this thread's two keys: r0 (accumulator slots 0, 1) and r0 + 8 (2, 3)
  const int r0 = kw * 16 + g;
  bool key_ok[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int tk = k0 + r0 + 8 * h;
    key_ok[h] = tk < Tn && (mrow == nullptr || mrow[tk] > 0.f);
  }

  float adk[NDW][4], adv[NDW][4];
#pragma unroll
  for (int j = 0; j < NDW; ++j)
#pragma unroll
    for (int i = 0; i < 4; ++i) adk[j][i] = adv[j][i] = 0.f;

  // query tile qt's q and dO (columns dc onwards) and its lse and Dvec
  // into stage `stage`
  auto prefetch = [&](int qt, int stage) {
    const int q0 = qt * BQ;
    load_rows<T, DMAX, BQ, NT>(sQ + stage * BQ * S, q + base, q0, Tn, D, vec,
                               tid, dc);
    load_rows<T, DMAX, BQ, NT>(sdO + stage * BQ * S, dO + base, q0, Tn, D,
                               vec, tid, dc);
    if (tid < BQ) {
      const int tq = q0 + tid;
      sLse[stage * BQ + tid] = tq < Tn ? lse[rbase + tq] : NEG_INF;
      sDvec[stage * BQ + tid] = tq < Tn ? dvec[rbase + tq] : 0.f;
    }
  };

  const int n_q = (Tn + BQ - 1) / BQ;
  // s^T += k q^T and dp^T += v dO^T over the DMAX columns of the tiles in
  // shared memory
  auto add_s_dp = [&](const T* Qs, const T* dOs, float (&s)[NQC][4],
                      float (&dp)[NQC][4]) {
#pragma unroll
    for (int kk = 0; kk < DMAX; kk += 8) {
      uint32_t kb[4], ks[4], vb[4], vs[4];
      load_a<SPLIT>(sK, S, r0, kk, t, kb, ks);
      load_a<SPLIT>(sV, S, r0, kk, t, vb, vs);
      uint32_t qb[NQC][2], qs[NQC][2], ob[NQC][2], os[NQC][2];
#pragma unroll
      for (int j = 0; j < NQC; ++j) {
        load_bt<SPLIT>(Qs, S, 8 * j, kk, g, t, qb[j], qs[j]);
        load_bt<SPLIT>(dOs, S, 8 * j, kk, g, t, ob[j], os[j]);
      }
      if (SPLIT) {
#pragma unroll
        for (int j = 0; j < NQC; ++j) {
          mma_tf32(s[j], ks, qb[j]);
          mma_tf32(dp[j], vs, ob[j]);
        }
#pragma unroll
        for (int j = 0; j < NQC; ++j) {
          mma_tf32(s[j], kb, qs[j]);
          mma_tf32(dp[j], vb, os[j]);
        }
      }
#pragma unroll
      for (int j = 0; j < NQC; ++j) {
        mma_tf32(s[j], kb, qb[j]);
        mma_tf32(dp[j], vb, ob[j]);
      }
    }
  };
  // The wide template's product, one at a time (fewer registers):
  // acc += A B^T over columns [kk0, kk1), A this warp's 16 keys of k or v,
  // B the tile's queries of q or dO
  auto add_abt = [&](const T* As, const T* Bs, float (&acc)[NQC][4],
                     int kk0, int kk1) {
#pragma unroll
    for (int kk = kk0; kk < kk1; kk += 8) {
      uint32_t ab[4], as[4];
      load_a<SPLIT>(As, S, r0, kk, t, ab, as);
      uint32_t bb[NQC][2], bs[NQC][2];
#pragma unroll
      for (int j = 0; j < NQC; ++j)
        load_bt<SPLIT>(Bs, S, 8 * j, kk, g, t, bb[j], bs[j]);
      if (SPLIT) {
#pragma unroll
        for (int j = 0; j < NQC; ++j) mma_tf32(acc[j], as, bb[j]);
#pragma unroll
        for (int j = 0; j < NQC; ++j) mma_tf32(acc[j], ab, bs[j]);
      }
#pragma unroll
      for (int j = 0; j < NQC; ++j) mma_tf32(acc[j], ab, bb[j]);
    }
  };

  // causal: query tiles wholly above this KV tile's diagonal never attend
  // to it (positions, not tile indices, decide)
  int qt = causal ? k0 / BQ : 0;
  if (!WIDE) prefetch(qt, 0);
  cp_async_commit();
  int stage = 0;
  for (; qt < n_q; ++qt) {
    const int q0 = qt * BQ;
    // a tile wholly before this warp's first key's diagonal adds nothing
    const bool active = !causal || q0 + BQ - 1 >= k0 + kw * 16;
    float s[NQC][4], dp[NQC][4];
#pragma unroll
    for (int j = 0; j < NQC; ++j)
#pragma unroll
      for (int i = 0; i < 4; ++i) s[j][i] = dp[j][i] = 0.f;
    if (WIDE) {
      // s^T and dp^T over all of D: chunk c of the block's k, v and the
      // tile's q, dO through shared memory, c = 0, 1, ... in every block;
      // for f32, every WIDE_SPAN columns' products in fresh accumulators,
      // joined by f32 adds (as K4's); bf16 sums in s and dp themselves
      // (as K4's; the fresh accumulator's registers spilled there)
      const int nch = n_chunks<DMAX>(D);
      for (int c = 0; c < nch; ++c) {
        const int c0 = c * DMAX;
        load_rows<T, DMAX, BK, NT>(sK, k + base, k0, Tn, D, vec, tid, c0);
        load_rows<T, DMAX, BK, NT>(sV, v + base, k0, Tn, D, vec, tid, c0);
        load_rows<T, DMAX, BQ, NT>(sQ, q + base, q0, Tn, D, vec, tid, c0);
        load_rows<T, DMAX, BQ, NT>(sdO, dO + base, q0, Tn, D, vec, tid, c0);
        cp_async_commit();
        cp_async_wait<0>();
        __syncthreads();
        if (active && !SPLIT) {
          add_abt(sK, sQ, s, 0, DMAX);
          add_abt(sV, sdO, dp, 0, DMAX);
        } else if (active) {
#pragma unroll
          for (int kk = 0; kk < DMAX; kk += WIDE_SPAN) {
            float pc[NQC][4] = {};
            add_abt(sK, sQ, pc, kk, kk + WIDE_SPAN);
#pragma unroll
            for (int j = 0; j < NQC; ++j)
#pragma unroll
              for (int i = 0; i < 4; ++i) {
                s[j][i] += pc[j][i];
                pc[j][i] = 0.f;
              }
            add_abt(sV, sdO, pc, kk, kk + WIDE_SPAN);
#pragma unroll
            for (int j = 0; j < NQC; ++j)
#pragma unroll
              for (int i = 0; i < 4; ++i) dp[j][i] += pc[j][i];
          }
        }
        __syncthreads();  // every warp is done with this chunk
      }
      prefetch(qt, 0);  // this block's chunk of q and dO, lse and Dvec
      cp_async_commit();
      cp_async_wait<0>();
      __syncthreads();
    } else {
      if (qt + 1 < n_q) prefetch(qt + 1, stage ^ 1);
      cp_async_commit();
      cp_async_wait<1>();  // this query tile (and K, V) have landed
      __syncthreads();
      if (active) add_s_dp(sQ + stage * BQ * S, sdO + stage * BQ * S, s, dp);
    }

    const T* Qs = sQ + stage * BQ * S;
    const T* dOs = sdO + stage * BQ * S;
    const float* Ls = sLse + stage * BQ;
    const float* Ds = sDvec + stage * BQ;
    if (active) {
      // p^T into s, ds^T into dp, gated by a select before any product
#pragma unroll
      for (int j = 0; j < NQC; ++j)
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int h = i >> 1;
          const int qc = 8 * j + 2 * t + (i & 1);
          const float l = Ls[qc];
          const bool ok = key_ok[h] && l > NEG_INF / 2 &&
                          (!causal || k0 + r0 + 8 * h <= q0 + qc);
          const float p = ok ? expf(s[j][i] * scale - l) : 0.f;
          s[j][i] = p;
          dp[j][i] = p * (dp[j][i] - Ds[qc]);
        }
      // dv += p^T dO and dk += ds^T q over the tile's queries, four
      // column tiles of each in turn
#pragma unroll
      for (int j = 0; j < NQC; ++j) {
        uint32_t pb[4], ps[4], db[4], ds[4];
        acc_as_a<SPLIT>(s[j], pb, ps);
        acc_as_a<SPLIT>(dp[j], db, ds);
#pragma unroll
        for (int n0 = 0; n0 < NDW; n0 += 4) {
          uint32_t ob[4][2], os[4][2], qb[4][2], qs[4][2];
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            const int col = d0 + 8 * (n0 + i);
            mma_pair_b<SPLIT>(dOs, S, 8 * j, col, g, t, ob[i], os[i]);
            mma_pair_b<SPLIT>(Qs, S, 8 * j, col, g, t, qb[i], qs[i]);
          }
          if (SPLIT) {
#pragma unroll
            for (int i = 0; i < 4; ++i) {
              mma_tf32(adv[n0 + i], ps, ob[i]);
              mma_tf32(adk[n0 + i], ds, qb[i]);
            }
#pragma unroll
            for (int i = 0; i < 4; ++i) {
              mma_tf32(adv[n0 + i], pb, os[i]);
              mma_tf32(adk[n0 + i], db, qs[i]);
            }
          }
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            mma_tf32(adv[n0 + i], pb, ob[i]);
            mma_tf32(adk[n0 + i], db, qb[i]);
          }
        }
      }
    }
    __syncthreads();  // every warp is done with this stage
    if (!WIDE) stage ^= 1;
  }
  cp_async_wait<0>();

#pragma unroll
  for (int n = 0; n < NDW; ++n)
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int tk = k0 + r0 + 8 * (i >> 1);
      const int d = dc + d0 + 8 * n + 2 * t + (i & 1);
      if (tk < Tn && d < D) {
        store(&dk[base + (size_t)tk * D + d], adk[n][i] * scale);
        store(&dv[base + (size_t)tk * D + d], adv[n][i]);
      }
    }
}

template <typename T, int DMAX, bool WIDE = false>
cudaError_t launch(const void* q, const void* k, const void* v,
                   const void* kv_mask, const void* dO, const void* lse,
                   const void* dvec, void* dk, void* dv, int BH, int H,
                   int Tn, int D, int causal, int vec, cudaStream_t stream) {
  constexpr size_t smem = smem_bytes<T, DMAX>();
  auto kern = flash_dkv_kernel<T, DMAX, WIDE>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid(BH, (Tn + kv_block<DMAX>() - 1) / kv_block<DMAX>(),
                  WIDE ? n_chunks<DMAX>(D) : 1);
  kern<<<grid, threads<DMAX>(), smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const float*>(kv_mask),
      static_cast<const T*>(dO), static_cast<const float*>(lse),
      static_cast<const float*>(dvec), static_cast<T*>(dk),
      static_cast<T*>(dv), H, Tn, D, causal, 1.0f / sqrtf((float)D), vec);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_d(const void* q, const void* k, const void* v,
                     const void* kv_mask, const void* dO, const void* lse,
                     const void* dvec, void* dk, void* dv, int BH, int H,
                     int Tn, int D, int causal, cudaStream_t stream) {
  // cp.async moves 16-byte pieces: rows of a whole number of them, and
  // 16-byte aligned tensors
  const int vec = (D * (int)sizeof(T)) % 16 == 0 &&
                  ((uintptr_t)q | (uintptr_t)k | (uintptr_t)v |
                   (uintptr_t)dO) % 16 == 0;
  if (D <= 32)
    return launch<T, 32>(q, k, v, kv_mask, dO, lse, dvec, dk, dv, BH, H, Tn,
                         D, causal, vec, stream);
  if (D <= 64)
    return launch<T, 64>(q, k, v, kv_mask, dO, lse, dvec, dk, dv, BH, H, Tn,
                         D, causal, vec, stream);
  if (D <= 128)
    return launch<T, 128>(q, k, v, kv_mask, dO, lse, dvec, dk, dv, BH, H, Tn,
                          D, causal, vec, stream);
  if (D <= 256)
    return launch<T, 256>(q, k, v, kv_mask, dO, lse, dvec, dk, dv, BH, H, Tn,
                          D, causal, vec, stream);
  return launch<T, 256, true>(q, k, v, kv_mask, dO, lse, dvec, dk, dv, BH, H,
                              Tn, D, causal, vec, stream);
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (q, k, v, dO, dk and dv share it; lse
// and dvec are f32). Returns the CUDA error of the launch (0 = launched).
extern "C" int dl4j_flash_attn_dkv(const void* q, const void* k,
                                   const void* v, const void* kv_mask,
                                   const void* dO, const void* lse,
                                   const void* dvec, void* dk, void* dv,
                                   int BH, int H, int Tn, int D, int causal,
                                   int dtype, void* stream) {
  if (BH < 1 || H < 1 || BH % H || Tn < 1 ||
      (Tn + BK_MIN - 1) / BK_MIN > 65535 || D < 1 ||
      n_chunks<256>(D) > 65535 || (dtype != 0 && dtype != 1))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return (int)launch_d<float>(q, k, v, kv_mask, dO, lse, dvec, dk, dv, BH, H,
                                Tn, D, causal, s);
  return (int)launch_d<__nv_bfloat16>(q, k, v, kv_mask, dO, lse, dvec, dk, dv,
                                      BH, H, Tn, D, causal, s);
}
