// Flash-attention forward for Hopper (sm_90a), CUDA cores, f32 accumulation.
//
// Replaces the TPU kernel deeplearning4j_tpu/ops/pallas_attention.py
// `_fwd_kernel` (launched by `_run_fwd`). Contract kept from it:
//   O = softmax(q k^T / sqrt(D) + key-mask bias, causal) v, plus the
//   log-sum-exp row statistics (lse, f32) the backward pass will need;
//   causal KV tiles past the diagonal are skipped, not masked;
//   a query row with no valid key writes exactly 0 and lse = NEG_INF
//   (-1e30). Validity is tested on the running max m, as the TPU kernel
//   does: for such a row every score is NEG_INF, so m never rises and the
//   running sum l stays positive (exp(s - m) == 1), which makes l useless
//   as the test.
// Not carried over: the TPU kernel pads T and D to 128 and pre-scales q by
// sqrt(Dp)/sqrt(D); here D is a template bound (32/64/128) with the tail
// zero-filled in shared memory, the scale is 1/sqrt(D) directly, and the
// ragged T edge is masked inside the kernel. There is no residency gate:
// K and V stream through shared memory one 64-key tile at a time.
//
// What bounds it on an H100: at the GPT slice's shape (B=32, H=8, T=256,
// D=64, causal, f32) the work is ~2.2 GFLOP against ~67 MB of q/k/v/o
// traffic, i.e. ~32 FLOP per byte, above the f32 CUDA-core ridge
// (67 TFLOP/s / 3.35 TB/s = 20 FLOP/byte). So the bound is operations.
// This first version does the arithmetic on CUDA cores with FMAs, so its
// ceiling is the f32 peak, not the tensor cores. The design keeps the
// FMA units fed from registers and shared memory:
//   * a 256-thread block owns 64 query rows; thread (ty, tx) of the
//     16 x 16 grid owns rows ty + 16 i (i < 4), so it computes a 4 x 4
//     block of scores and a 4 x (D/16) block of the output, and each value
//     it loads from shared memory feeds 4 FMAs;
//   * the 16 threads sharing a row sit in one half-warp, so the row max
//     and row sum of the online softmax are warp shuffles, and the
//     running (m, l, acc) carry never leaves registers;
//   * shared-memory rows are padded to an odd stride, so the 16 rows a
//     half-warp reads at once fall into 16 different banks;
//   * causal blocks are issued longest-first (last query tile first) so
//     the short tiles fill the tail of the grid.
// Tensor cores (mma.sync / wgmma in tf32 or bf16) and TMA double-buffering
// are left to a later version.

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

// Reductions over the 16 lanes that share one query row (one half-warp).
__device__ __forceinline__ float row_max(float x) {
#pragma unroll
  for (int off = 8; off > 0; off >>= 1)
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, off));
  return x;
}
__device__ __forceinline__ float row_sum(float x) {
#pragma unroll
  for (int off = 8; off > 0; off >>= 1)
    x += __shfl_xor_sync(0xffffffffu, x, off);
  return x;
}

template <int DMAX>
constexpr size_t smem_bytes() {
  return sizeof(float) * (size_t)(BQ * (DMAX + 1) + BK * (DMAX + 1) +
                                  BK * DMAX + BQ * (BK + 1) + BK);
}

// q, k, v, o: [BH, T, D] contiguous; kv_mask: [BH / H, T] (> 0 = valid key)
// or null; lse: [BH, T] f32.
template <typename T, int DMAX>
__global__ void __launch_bounds__(NT)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, const float* __restrict__ kv_mask,
                 T* __restrict__ o, float* __restrict__ lse, int H, int Tn,
                 int D, int causal, float scale) {
  constexpr int QS = DMAX + 1;  // odd strides: conflict-free column reads
  constexpr int PS = BK + 1;
  constexpr int DJ = DMAX / 16;  // output columns per thread
  extern __shared__ float smem[];
  float* sQ = smem;              // [BQ][QS], pre-scaled by 1/sqrt(D)
  float* sK = sQ + BQ * QS;      // [BK][QS]
  float* sV = sK + BK * QS;      // [BK][DMAX]
  float* sP = sV + BK * DMAX;    // [BQ][PS] probabilities of this tile
  float* sBias = sP + BQ * PS;   // [BK] 0 = usable key, NEG_INF = not

  const int bh = blockIdx.x;
  const int n_q = (Tn + BQ - 1) / BQ;
  const int q0 = (n_q - 1 - (int)blockIdx.y) * BQ;
  const int tid = threadIdx.x;
  const int tx = tid & 15, ty = tid >> 4;
  const size_t base = (size_t)bh * Tn * D;
  const float* mrow = kv_mask ? kv_mask + (size_t)(bh / H) * Tn : nullptr;

  for (int i = tid; i < BQ * DMAX; i += NT) {
    const int r = i / DMAX, d = i % DMAX, t = q0 + r;
    sQ[r * QS + d] =
        (t < Tn && d < D) ? to_f32(q[base + (size_t)t * D + d]) * scale : 0.f;
  }

  float acc[4][DJ], m[4], l[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = NEG_INF;
    l[i] = 0.f;
#pragma unroll
    for (int j = 0; j < DJ; ++j) acc[i][j] = 0.f;
  }

  const int n_kv = (Tn + BK - 1) / BK;
  const int kv_end = causal ? min(n_kv, (q0 + BQ - 1) / BK + 1) : n_kv;
  for (int kt = 0; kt < kv_end; ++kt) {
    const int k0 = kt * BK;
    __syncthreads();  // last tile's readers are done; Q is in on pass 0
    for (int i = tid; i < BK * DMAX; i += NT) {
      const int r = i / DMAX, d = i % DMAX, t = k0 + r;
      const bool in = t < Tn && d < D;
      const size_t g = base + (size_t)t * D + d;
      sK[r * QS + d] = in ? to_f32(k[g]) : 0.f;
      sV[r * DMAX + d] = in ? to_f32(v[g]) : 0.f;
    }
    if (tid < BK) {
      const int t = k0 + tid;
      sBias[tid] = (t < Tn && (mrow == nullptr || mrow[t] > 0.f)) ? 0.f
                                                                   : NEG_INF;
    }
    __syncthreads();

    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
#pragma unroll 8
    for (int d = 0; d < DMAX; ++d) {
      float qv[4], kv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) qv[i] = sQ[(ty + 16 * i) * QS + d];
#pragma unroll
      for (int j = 0; j < 4; ++j) kv[j] = sK[(tx + 16 * j) * QS + d];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = fmaf(qv[i], kv[j], s[i][j]);
    }

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int qpos = q0 + ty + 16 * i;
      float mx = NEG_INF;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int c = tx + 16 * j;
        const bool ok = sBias[c] == 0.f && (!causal || k0 + c <= qpos);
        s[i][j] = ok ? s[i][j] : NEG_INF;
        mx = fmaxf(mx, s[i][j]);
      }
      const float m_new = fmaxf(m[i], row_max(mx));
      const float alpha = expf(m[i] - m_new);
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float p = expf(s[i][j] - m_new);
        sP[(ty + 16 * i) * PS + tx + 16 * j] = p;
        sum += p;
      }
      l[i] = l[i] * alpha + row_sum(sum);
      m[i] = m_new;
#pragma unroll
      for (int j = 0; j < DJ; ++j) acc[i][j] *= alpha;
    }
    __syncthreads();

#pragma unroll 4
    for (int c = 0; c < BK; ++c) {
      float pv[4], vv[DJ];
#pragma unroll
      for (int i = 0; i < 4; ++i) pv[i] = sP[(ty + 16 * i) * PS + c];
#pragma unroll
      for (int j = 0; j < DJ; ++j) vv[j] = sV[c * DMAX + tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < DJ; ++j) acc[i][j] = fmaf(pv[i], vv[j], acc[i][j]);
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int t = q0 + ty + 16 * i;
    if (t >= Tn) continue;
    const bool valid = m[i] > NEG_INF / 2;
    const float l_safe = fmaxf(l[i], 1e-30f);
#pragma unroll
    for (int j = 0; j < DJ; ++j) {
      const int d = tx + 16 * j;
      if (d < D)
        store(&o[base + (size_t)t * D + d], valid ? acc[i][j] / l_safe : 0.f);
    }
    if (tx == 0)
      lse[(size_t)bh * Tn + t] = valid ? m[i] + logf(l_safe) : NEG_INF;
  }
}

template <typename T, int DMAX>
cudaError_t launch(const void* q, const void* k, const void* v,
                   const void* kv_mask, void* o, void* lse, int BH, int H,
                   int Tn, int D, int causal, cudaStream_t stream) {
  constexpr size_t smem = smem_bytes<DMAX>();
  auto kern = flash_fwd_kernel<T, DMAX>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid(BH, (Tn + BQ - 1) / BQ);
  kern<<<grid, NT, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const float*>(kv_mask),
      static_cast<T*>(o), static_cast<float*>(lse), H, Tn, D, causal,
      1.0f / sqrtf((float)D));
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_d(const void* q, const void* k, const void* v,
                     const void* kv_mask, void* o, void* lse, int BH, int H,
                     int Tn, int D, int causal, cudaStream_t stream) {
  if (D <= 32)
    return launch<T, 32>(q, k, v, kv_mask, o, lse, BH, H, Tn, D, causal,
                         stream);
  if (D <= 64)
    return launch<T, 64>(q, k, v, kv_mask, o, lse, BH, H, Tn, D, causal,
                         stream);
  return launch<T, 128>(q, k, v, kv_mask, o, lse, BH, H, Tn, D, causal,
                        stream);
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (q, k, v and o share it). Returns the
// CUDA error of the launch (0 = launched).
extern "C" int dl4j_flash_attn_fwd(const void* q, const void* k,
                                   const void* v, const void* kv_mask,
                                   void* o, void* lse, int BH, int H, int Tn,
                                   int D, int causal, int dtype,
                                   void* stream) {
  if (BH < 1 || H < 1 || BH % H || Tn < 1 || (Tn + BQ - 1) / BQ > 65535 ||
      D < 1 || D > 128 || (dtype != 0 && dtype != 1))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return (int)launch_d<float>(q, k, v, kv_mask, o, lse, BH, H, Tn, D,
                                causal, s);
  return (int)launch_d<__nv_bfloat16>(q, k, v, kv_mask, o, lse, BH, H, Tn, D,
                                      causal, s);
}
