// Flash-attention backward, dk and dv (FlashAttention-2), for Hopper
// (sm_90a), CUDA cores, f32 accumulation.
//
// Replaces the TPU kernel deeplearning4j_tpu/ops/pallas_attention.py
// `_dkv_kernel` (the dk/dv `pallas_call` of `_run_bwd`). Contract kept
// from it: per KV tile, looping the query tiles from the diagonal (causal)
// or from 0,
//   p  = exp(s - lse), s = (q k^T) / sqrt(D), from the forward's lse;
//   dv = sum over queries of p^T dO;
//   ds = p * (dp - Dvec), dp = dO v^T, Dvec = rowsum(dO * O) (f32, outside);
//   dk = sum over queries of ds^T q / sqrt(D);
//   a query row whose lse is NEG_INF (no valid key) gets p = 0 by a select
//   taken before any product, so it adds exactly nothing to dk and dv.
// Not carried over: the TPU kernel's T and D padding to 128 and its
// sqrt(Dp)/sqrt(D) pre-scale of q; here the scale is 1/sqrt(D), D is a
// template bound (32/64/128) with the tail zero-filled in shared memory,
// and the ragged T edge is masked inside the kernel.
//
// What bounds it on an H100: at the GPT training shape (B=32, H=8, T=256,
// D=64, causal, f32) it does 8 D FLOP per causal (query, key) pair (s, dp,
// dv and dk), ~4.3 GFLOP, against ~101 MB of traffic: ~43 FLOP per byte,
// above the f32 CUDA-core ridge (20). So the bound is operations, and this
// first version does them on CUDA cores with FMAs:
//   * a 256-thread block owns 64 keys; their k and v tiles stay in shared
//     memory for the whole block, and the two [64, D] f32 accumulators
//     (dk, dv) live in registers: thread (ty, tx) owns keys ty + 16 i
//     (i < 4) and columns tx + 16 j (j < D/16) of both, 2 x 4 x 8 = 64
//     registers at D = 128, where shared memory would need another 64 KB;
//   * each query tile (q pre-scaled, dO, lse, Dvec) streams through shared
//     memory; s^T and dp^T come out of one pass over d (s in the forward's
//     summation order), and p^T and ds^T go through shared memory once for
//     the two accumulating products;
//   * shared memory: k, v, q, dO tiles at an odd row stride plus p^T, ds^T:
//     ~162 KB at D = 128, ~98 KB at D = 64, so the launch raises the
//     block's dynamic shared-memory limit first and reports a refusal;
//   * causal blocks are issued longest-first (KV tile 0 first: it sees
//     every query tile).
// One block per (batch x head, KV tile) writes its own dk/dv rows: no
// atomics, so two launches on the same inputs are bitwise equal.
// Tensor cores (mma.sync / wgmma) and TMA double-buffering are left to a
// later version.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cmath>

namespace {

constexpr int BQ = 64;        // query rows per streamed tile
constexpr int BK = 64;        // keys per block
constexpr int NT = 256;       // threads per block: a 16 x 16 grid
constexpr float NEG_INF = -1e30f;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16(x);
}

template <int DMAX>
constexpr size_t smem_bytes() {
  return sizeof(float) * (size_t)(2 * BK * (DMAX + 1) + 2 * BQ * (DMAX + 1) +
                                  2 * BK * (BQ + 1) + 2 * BQ);
}

// q, k, v, dO, dk, dv: [BH, T, D] contiguous; kv_mask: [BH / H, T] (> 0 =
// valid key) or null; lse, dvec: [BH, T] f32.
template <typename T, int DMAX>
__global__ void __launch_bounds__(NT)
flash_dkv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, const float* __restrict__ kv_mask,
                 const T* __restrict__ dO, const float* __restrict__ lse,
                 const float* __restrict__ dvec, T* __restrict__ dk,
                 T* __restrict__ dv, int H, int Tn, int D, int causal,
                 float scale) {
  constexpr int S = DMAX + 1;   // odd strides: conflict-free column reads
  constexpr int PQ = BQ + 1;
  constexpr int DJ = DMAX / 16;  // dk/dv columns per thread
  extern __shared__ float smem[];
  float* sK = smem;              // [BK][S]
  float* sV = sK + BK * S;       // [BK][S]
  float* sQ = sV + BK * S;       // [BQ][S], pre-scaled by 1/sqrt(D)
  float* sdO = sQ + BQ * S;      // [BQ][S]
  float* sP = sdO + BQ * S;      // [BK][PQ] p^T of this query tile
  float* sdS = sP + BK * PQ;     // [BK][PQ] ds^T of this query tile
  float* sLse = sdS + BK * PQ;   // [BQ]
  float* sDvec = sLse + BQ;      // [BQ]

  const int bh = blockIdx.x;
  const int k0 = (int)blockIdx.y * BK;
  const int tid = threadIdx.x;
  const int tx = tid & 15, ty = tid >> 4;
  const size_t base = (size_t)bh * Tn * D;
  const size_t rbase = (size_t)bh * Tn;
  const float* mrow = kv_mask ? kv_mask + (size_t)(bh / H) * Tn : nullptr;

  for (int i = tid; i < BK * DMAX; i += NT) {
    const int r = i / DMAX, d = i % DMAX, t = k0 + r;
    const bool in = t < Tn && d < D;
    const size_t g = base + (size_t)t * D + d;
    sK[r * S + d] = in ? to_f32(k[g]) : 0.f;
    sV[r * S + d] = in ? to_f32(v[g]) : 0.f;
  }
  bool key_ok[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int t = k0 + ty + 16 * i;
    key_ok[i] = t < Tn && (mrow == nullptr || mrow[t] > 0.f);
  }

  float adk[4][DJ], adv[4][DJ];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < DJ; ++j) adk[i][j] = adv[i][j] = 0.f;

  const int n_q = (Tn + BQ - 1) / BQ;
  // causal: query tiles wholly above this KV tile's diagonal never attend
  // to it (positions, not tile indices, decide)
  const int qt_begin = causal ? k0 / BQ : 0;
  for (int qt = qt_begin; qt < n_q; ++qt) {
    const int q0 = qt * BQ;
    __syncthreads();  // last tile's readers are done; K and V are in
    for (int i = tid; i < BQ * DMAX; i += NT) {
      const int r = i / DMAX, d = i % DMAX, t = q0 + r;
      const bool in = t < Tn && d < D;
      const size_t g = base + (size_t)t * D + d;
      sQ[r * S + d] = in ? to_f32(q[g]) * scale : 0.f;
      sdO[r * S + d] = in ? to_f32(dO[g]) : 0.f;
    }
    if (tid < BQ) {
      const int t = q0 + tid;
      sLse[tid] = t < Tn ? lse[rbase + t] : NEG_INF;
      sDvec[tid] = t < Tn ? dvec[rbase + t] : 0.f;
    }
    __syncthreads();

    // s^T[key][query] and dp^T[key][query]
    float s[4][4], dp[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = dp[i][j] = 0.f;
#pragma unroll 4
    for (int d = 0; d < DMAX; ++d) {
      float kv[4], vv[4], qv[4], ov[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        kv[i] = sK[(ty + 16 * i) * S + d];
        vv[i] = sV[(ty + 16 * i) * S + d];
      }
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        qv[j] = sQ[(tx + 16 * j) * S + d];
        ov[j] = sdO[(tx + 16 * j) * S + d];
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          s[i][j] = fmaf(qv[j], kv[i], s[i][j]);
          dp[i][j] = fmaf(ov[j], vv[i], dp[i][j]);
        }
    }

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = ty + 16 * i;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int c = tx + 16 * j;
        const float l = sLse[c];
        const bool ok = key_ok[i] && l > NEG_INF / 2 &&
                        (!causal || k0 + r <= q0 + c);
        const float p = ok ? expf(s[i][j] - l) : 0.f;
        sP[r * PQ + c] = p;
        sdS[r * PQ + c] = p * (dp[i][j] - sDvec[c]);
      }
    }
    __syncthreads();

#pragma unroll 4
    for (int c = 0; c < BQ; ++c) {
      float pv[4], dsv[4], ov[DJ], qv[DJ];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        pv[i] = sP[(ty + 16 * i) * PQ + c];
        dsv[i] = sdS[(ty + 16 * i) * PQ + c];
      }
#pragma unroll
      for (int j = 0; j < DJ; ++j) {
        ov[j] = sdO[c * S + tx + 16 * j];
        qv[j] = sQ[c * S + tx + 16 * j];
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < DJ; ++j) {
          adv[i][j] = fmaf(pv[i], ov[j], adv[i][j]);
          adk[i][j] = fmaf(dsv[i], qv[j], adk[i][j]);
        }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int t = k0 + ty + 16 * i;
    if (t >= Tn) continue;
#pragma unroll
    for (int j = 0; j < DJ; ++j) {
      const int d = tx + 16 * j;
      if (d < D) {
        // sQ holds q / sqrt(D), so adk is already dk
        store(&dk[base + (size_t)t * D + d], adk[i][j]);
        store(&dv[base + (size_t)t * D + d], adv[i][j]);
      }
    }
  }
}

template <typename T, int DMAX>
cudaError_t launch(const void* q, const void* k, const void* v,
                   const void* kv_mask, const void* dO, const void* lse,
                   const void* dvec, void* dk, void* dv, int BH, int H,
                   int Tn, int D, int causal, cudaStream_t stream) {
  constexpr size_t smem = smem_bytes<DMAX>();
  auto kern = flash_dkv_kernel<T, DMAX>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid(BH, (Tn + BK - 1) / BK);
  kern<<<grid, NT, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const float*>(kv_mask),
      static_cast<const T*>(dO), static_cast<const float*>(lse),
      static_cast<const float*>(dvec), static_cast<T*>(dk),
      static_cast<T*>(dv), H, Tn, D, causal, 1.0f / sqrtf((float)D));
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_d(const void* q, const void* k, const void* v,
                     const void* kv_mask, const void* dO, const void* lse,
                     const void* dvec, void* dk, void* dv, int BH, int H,
                     int Tn, int D, int causal, cudaStream_t stream) {
  if (D <= 32)
    return launch<T, 32>(q, k, v, kv_mask, dO, lse, dvec, dk, dv, BH, H, Tn,
                         D, causal, stream);
  if (D <= 64)
    return launch<T, 64>(q, k, v, kv_mask, dO, lse, dvec, dk, dv, BH, H, Tn,
                         D, causal, stream);
  return launch<T, 128>(q, k, v, kv_mask, dO, lse, dvec, dk, dv, BH, H, Tn, D,
                        causal, stream);
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
  if (BH < 1 || H < 1 || BH % H || Tn < 1 || (Tn + BK - 1) / BK > 65535 ||
      D < 1 || D > 128 || (dtype != 0 && dtype != 1))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return (int)launch_d<float>(q, k, v, kv_mask, dO, lse, dvec, dk, dv, BH, H,
                                Tn, D, causal, s);
  return (int)launch_d<__nv_bfloat16>(q, k, v, kv_mask, dO, lse, dvec, dk, dv,
                                      BH, H, Tn, D, causal, s);
}
