// Flash-attention backward, dq (FlashAttention-2), for Hopper (sm_90a),
// CUDA cores, f32 accumulation.
//
// Replaces the TPU kernel deeplearning4j_tpu/ops/pallas_attention.py
// `_dq_kernel` (the dq `pallas_call` of `_run_bwd`). Contract kept from it:
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
// sqrt(Dp)/sqrt(D); here the scale is 1/sqrt(D) directly, D is a template
// bound (32/64/128) with the tail zero-filled in shared memory, and the
// ragged T edge is masked inside the kernel.
//
// What bounds it on an H100: at the GPT training shape (B=32, H=8, T=256,
// D=64, causal, f32) the kernel does 6 D FLOP per causal (query, key) pair
// (s, dp and dq), ~3.2 GFLOP, against ~84 MB of q/k/v/dO/dq/lse/Dvec
// traffic: ~38 FLOP per byte, above the f32 CUDA-core ridge (67 TFLOP/s /
// 3.35 TB/s = 20). So the bound is operations. This first version does the
// arithmetic on CUDA cores with FMAs; its design mirrors the forward kernel
// (csrc/flash_attn_fwd.cu) to keep the FMA units fed:
//   * a 256-thread block owns 64 query rows and walks the KV tiles up to
//     the diagonal; thread (ty, tx) of the 16 x 16 grid owns rows ty + 16 i
//     and keys tx + 16 j (i, j < 4) of each score tile, and columns
//     tx + 16 j of dq, accumulated in registers across the tiles;
//   * s and dp come out of one pass over d: each value loaded from shared
//     memory feeds 4 FMAs, and s is summed in the forward's order, so p
//     matches the forward's lse to the rounding of lse;
//   * ds goes through shared memory once per tile for the ds k product;
//   * shared-memory rows are padded to an odd stride (conflict-free column
//     reads), and causal blocks are issued longest-first.
// One block per (batch x head, query tile) writes its own dq rows: no
// atomics, so two launches on the same inputs are bitwise equal.
// Tensor cores (mma.sync / wgmma) and TMA double-buffering are left to a
// later version.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cmath>

namespace {

constexpr int BQ = 64;        // query rows per block
constexpr int BK = 64;        // keys per KV tile
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
  return sizeof(float) * (size_t)(2 * BQ * (DMAX + 1) + 2 * BK * (DMAX + 1) +
                                  BQ * (BK + 1) + BK + 2 * BQ);
}

// q, k, v, dO, dq: [BH, T, D] contiguous; kv_mask: [BH / H, T] (> 0 = valid
// key) or null; lse, dvec: [BH, T] f32.
template <typename T, int DMAX>
__global__ void __launch_bounds__(NT)
flash_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
                const T* __restrict__ v, const float* __restrict__ kv_mask,
                const T* __restrict__ dO, const float* __restrict__ lse,
                const float* __restrict__ dvec, T* __restrict__ dq, int H,
                int Tn, int D, int causal, float scale) {
  constexpr int S = DMAX + 1;   // odd strides: conflict-free column reads
  constexpr int PS = BK + 1;
  constexpr int DJ = DMAX / 16;  // dq columns per thread
  extern __shared__ float smem[];
  float* sQ = smem;              // [BQ][S], pre-scaled by 1/sqrt(D)
  float* sdO = sQ + BQ * S;      // [BQ][S]
  float* sK = sdO + BQ * S;      // [BK][S]
  float* sV = sK + BK * S;       // [BK][S]
  float* sdS = sV + BK * S;      // [BQ][PS] ds of this tile
  float* sBias = sdS + BQ * PS;  // [BK] 0 = usable key, NEG_INF = not
  float* sLse = sBias + BK;      // [BQ]
  float* sDvec = sLse + BQ;      // [BQ]

  const int bh = blockIdx.x;
  const int n_q = (Tn + BQ - 1) / BQ;
  const int q0 = (n_q - 1 - (int)blockIdx.y) * BQ;
  const int tid = threadIdx.x;
  const int tx = tid & 15, ty = tid >> 4;
  const size_t base = (size_t)bh * Tn * D;
  const size_t rbase = (size_t)bh * Tn;
  const float* mrow = kv_mask ? kv_mask + (size_t)(bh / H) * Tn : nullptr;

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

  float acc[4][DJ];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < DJ; ++j) acc[i][j] = 0.f;

  const int n_kv = (Tn + BK - 1) / BK;
  const int kv_end = causal ? min(n_kv, (q0 + BQ - 1) / BK + 1) : n_kv;
  for (int kt = 0; kt < kv_end; ++kt) {
    const int k0 = kt * BK;
    __syncthreads();  // last tile's readers are done; Q and dO are in
    for (int i = tid; i < BK * DMAX; i += NT) {
      const int r = i / DMAX, d = i % DMAX, t = k0 + r;
      const bool in = t < Tn && d < D;
      const size_t g = base + (size_t)t * D + d;
      sK[r * S + d] = in ? to_f32(k[g]) : 0.f;
      sV[r * S + d] = in ? to_f32(v[g]) : 0.f;
    }
    if (tid < BK) {
      const int t = k0 + tid;
      sBias[tid] = (t < Tn && (mrow == nullptr || mrow[t] > 0.f)) ? 0.f
                                                                   : NEG_INF;
    }
    __syncthreads();

    float s[4][4], dp[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = dp[i][j] = 0.f;
#pragma unroll 4
    for (int d = 0; d < DMAX; ++d) {
      float qv[4], ov[4], kv[4], vv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        qv[i] = sQ[(ty + 16 * i) * S + d];
        ov[i] = sdO[(ty + 16 * i) * S + d];
      }
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        kv[j] = sK[(tx + 16 * j) * S + d];
        vv[j] = sV[(tx + 16 * j) * S + d];
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          s[i][j] = fmaf(qv[i], kv[j], s[i][j]);
          dp[i][j] = fmaf(ov[i], vv[j], dp[i][j]);
        }
    }

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = ty + 16 * i;
      const float l = sLse[r];
      const bool row_ok = l > NEG_INF / 2;
      const float dv = sDvec[r];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int c = tx + 16 * j;
        const bool ok = row_ok && sBias[c] == 0.f &&
                        (!causal || k0 + c <= q0 + r);
        const float p = ok ? expf(s[i][j] - l) : 0.f;
        sdS[r * PS + c] = p * (dp[i][j] - dv);
      }
    }
    __syncthreads();

#pragma unroll 4
    for (int c = 0; c < BK; ++c) {
      float dsv[4], kk[DJ];
#pragma unroll
      for (int i = 0; i < 4; ++i) dsv[i] = sdS[(ty + 16 * i) * PS + c];
#pragma unroll
      for (int j = 0; j < DJ; ++j) kk[j] = sK[c * S + tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < DJ; ++j) acc[i][j] = fmaf(dsv[i], kk[j], acc[i][j]);
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int t = q0 + ty + 16 * i;
    if (t >= Tn) continue;
#pragma unroll
    for (int j = 0; j < DJ; ++j) {
      const int d = tx + 16 * j;
      if (d < D) store(&dq[base + (size_t)t * D + d], acc[i][j] * scale);
    }
  }
}

template <typename T, int DMAX>
cudaError_t launch(const void* q, const void* k, const void* v,
                   const void* kv_mask, const void* dO, const void* lse,
                   const void* dvec, void* dq, int BH, int H, int Tn, int D,
                   int causal, cudaStream_t stream) {
  constexpr size_t smem = smem_bytes<DMAX>();
  auto kern = flash_dq_kernel<T, DMAX>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid(BH, (Tn + BQ - 1) / BQ);
  kern<<<grid, NT, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const float*>(kv_mask),
      static_cast<const T*>(dO), static_cast<const float*>(lse),
      static_cast<const float*>(dvec), static_cast<T*>(dq), H, Tn, D, causal,
      1.0f / sqrtf((float)D));
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_d(const void* q, const void* k, const void* v,
                     const void* kv_mask, const void* dO, const void* lse,
                     const void* dvec, void* dq, int BH, int H, int Tn, int D,
                     int causal, cudaStream_t stream) {
  if (D <= 32)
    return launch<T, 32>(q, k, v, kv_mask, dO, lse, dvec, dq, BH, H, Tn, D,
                         causal, stream);
  if (D <= 64)
    return launch<T, 64>(q, k, v, kv_mask, dO, lse, dvec, dq, BH, H, Tn, D,
                         causal, stream);
  return launch<T, 128>(q, k, v, kv_mask, dO, lse, dvec, dq, BH, H, Tn, D,
                        causal, stream);
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (q, k, v, dO and dq share it; lse and
// dvec are f32). Returns the CUDA error of the launch (0 = launched).
extern "C" int dl4j_flash_attn_dq(const void* q, const void* k, const void* v,
                                  const void* kv_mask, const void* dO,
                                  const void* lse, const void* dvec, void* dq,
                                  int BH, int H, int Tn, int D, int causal,
                                  int dtype, void* stream) {
  if (BH < 1 || H < 1 || BH % H || Tn < 1 || (Tn + BQ - 1) / BQ > 65535 ||
      D < 1 || D > 128 || (dtype != 0 && dtype != 1))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return (int)launch_d<float>(q, k, v, kv_mask, dO, lse, dvec, dq, BH, H,
                                Tn, D, causal, s);
  return (int)launch_d<__nv_bfloat16>(q, k, v, kv_mask, dO, lse, dvec, dq, BH,
                                      H, Tn, D, causal, s);
}
