// Flash-attention forward for Hopper (sm_90a), tensor cores (mma.sync tf32,
// 3xTF32 for f32 inputs), f32 accumulation.
//
// Replaces the TPU kernel deeplearning4j_tpu/ops/pallas_attention.py:72
// `_fwd_kernel` (launched by `_run_fwd`, :121). Contract kept from it:
//   O = softmax(q k^T / sqrt(D) + key-mask bias, causal) v, plus the
//   natural-log log-sum-exp row statistics (lse, f32) the backward needs;
//   causal KV tiles past the diagonal are skipped, not masked;
//   a query row with no valid key writes exactly 0 and lse = NEG_INF
//   (-1e30). Validity is tested on the running max m, as the TPU kernel
//   does: m never rises off NEG_INF for such a row.
// Not carried over: the TPU kernel pads T and D to 128 and pre-scales q by
// sqrt(Dp)/sqrt(D); here the scale 1/sqrt(D) goes on s, D is a template
// bound (32/64/128/256) with the tail zero-filled in shared memory, and
// the ragged T edge is masked inside the kernel. There is no residency
// gate: K and V stream through shared memory one tile at a time, so any
// D runs: a head wider than 256 takes the wide template (below).
//
// What bounds it on an H100: at the GPT slice's shape (B=32, H=8, T=256,
// D=64, causal, f32) the kernel does 4 D FLOP per causal (query, key) pair
// (s = q k^T and o += p v), 2.16 GFLOP, against 67.4 MB of q/k/v/o/lse
// traffic. With the products on tensor cores in 3xTF32 (495 / 3 = 165
// TFLOP/s) the operations take 0.0131 ms and the bytes 0.0201 ms at 3.35
// TB/s: the bound is bytes, 0.0201 ms (0.0322 ms by operations at the f32
// CUDA-core peak, where the kernel this one replaced ran).
// The design, on the building blocks of the backward kernels (fragment
// layouts in flash_mma.cuh):
//   * a 128-thread block owns 64 query rows, 16 per warp, and walks the
//     KV tiles of 32 keys up to the diagonal; s = q k^T is an m16n8k8 tf32
//     mma.sync product from shared memory, one k step's products going to
//     the tile's 4 accumulators in turn;
//   * the online softmax keeps (m, l) in registers: the row max is a
//     shuffle over the 4 lanes that share a fragment row, l stays a
//     per-lane partial sum until the end (every lane of a row rescales by
//     the same factor);
//   * p goes to p v from registers: the s accumulator is the A operand
//     (the permuted key order), V's rows are read in that order, so p
//     never touches shared memory;
//   * each tile's p v lands in a fresh accumulator and joins o by one f32
//     fma (o = alpha o + p v). Accumulating o itself across the tiles in
//     the mma.sync accumulator biased it: the full GPT's step-1
//     gradients then missed the card-vs-CPU gate (1.08e-4 of the largest
//     |g| against 1e-4; 2.3e-5 this way, 3.6e-5 with the CUDA-core kernel
//     this one replaced), at the same speed;
//   * f32 operands are split into two tf32 halves as their fragments are
//     loaded (big by truncation, two instructions); bf16 operands are
//     exact in tf32, one product each, and p is rounded to tf32 once;
//   * K and V tiles are double-buffered with cp.async (zero fill past T
//     and D; rows that are not 16-byte multiples load element by element);
//     52 KB of shared memory and at most 128 registers (D <= 64) let four
//     blocks share an SM (three blocks, 140 registers: 6% slower);
//   * at D = 256 two warps share 16 rows, each holding half of o's
//     columns (64 registers, as at D = 128, where one warp would need
//     128); both compute the rows' whole s, so (m, l) agree bit for bit,
//     and s = q k^T is done twice: 1.5x the FLOP of one warp. A block
//     owns 32 rows and walks 16-key tiles there (128 threads, 98 KB of
//     shared memory, two blocks an SM), so a short batch still spreads
//     over the SMs;
//   * with a key mask, a KV tile whose keys are all invalid is skipped (a
//     block vote), and a warp skips a tile wholly past its rows' causal
//     diagonal; causal blocks are scheduled longest-first;
//   * the wide template (D > 256, DMAX = 256, WIDE): a third grid axis
//     cuts o's columns into chunks of 256 (the last one ragged), and a
//     block keeps the D = 256 template's rows and register layout for its
//     chunk. For each KV tile it sums s over all of D, chunk by chunk of
//     q and k through shared memory, in the same order in every block, so
//     every chunk's block computes the same s and (m, l) bit for bit; then
//     p v for its own chunk of v. The first chunk's block writes lse. It
//     is simple, not fast: s is recomputed once per chunk (2x at D = 512)
//     and nothing is double-buffered (PERF.md).
// One block per (batch x head, query tile, column chunk) writes its own
// outputs: no atomics, so two launches on the same inputs are bitwise
// equal.
// Measured on an NVIDIA H100 80GB HBM3 at its 700 W power limit: see
// PERF.md (chip_smoke.py, tools/flash_ab.py).

#include "flash_mma.cuh"

#include <cmath>

namespace {

using namespace flash_mma;

constexpr int BQ_MIN = 32;    // the fewest query rows a block owns

// Warps that share 16 query rows, each accumulating DMAX / DSPLIT of o's
// columns: two at DMAX = 256, so that o takes 64 registers a thread
template <int DMAX>
__host__ __device__ constexpr int dsplit() {
  return DMAX > 128 ? 2 : 1;
}
// Warps of 16 query rows a block: 4 (64 rows); 2 at DMAX = 256, so that
// a short batch still spreads over the SMs
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
template <int DMAX>
__host__ __device__ constexpr int kv_tile() {  // keys per KV tile
  return DMAX > 128 ? 16 : 32;
}

// Q, two stages of K and V, two stages of key validity: 52 KB at D = 64
// in f32, so four blocks share an SM; 98 KB at D = 256, two blocks
template <typename T, int DMAX>
constexpr size_t smem_bytes() {
  return sizeof(T) * (size_t)((q_rows<DMAX>() + 4 * kv_tile<DMAX>()) *
                              row_stride<T, DMAX>()) +
         sizeof(float) * 2 * kv_tile<DMAX>();
}

__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}
__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

// q, k, v, o: [BH, T, D] contiguous; kv_mask: [BH / H, T] (> 0 = valid key)
// or null; lse: [BH, T] f32. WIDE (DMAX = 256, D > 256): the block owns o's
// columns blockIdx.z * DMAX onwards, one chunk of DMAX, and sums s over all
// of D chunk by chunk.
template <typename T, int DMAX, bool WIDE>
__global__ void __launch_bounds__(threads<DMAX>(),
                                  DMAX > 128 ? 2 : DMAX > 64 ? 1 : 4)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, const float* __restrict__ kv_mask,
                 T* __restrict__ o, float* __restrict__ lse, int H, int Tn,
                 int D, int causal, float scale, int vec) {
  constexpr bool SPLIT = std::is_same<T, float>::value;
  constexpr int S = row_stride<T, DMAX>();
  constexpr int NT = threads<DMAX>();
  constexpr int BQ = q_rows<DMAX>();
  constexpr int BK = kv_tile<DMAX>();
  constexpr int NKC = BK / 8;     // 8-key n-tiles per tile
  constexpr int RW = row_warps<DMAX>();
  constexpr int NDW = DMAX / 8 / dsplit<DMAX>();  // this warp's o n-tiles
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* sQ = reinterpret_cast<T*>(smem_raw);  // [BQ][S]
  T* sK = sQ + BQ * S;                     // [2][BK][S]
  T* sV = sK + 2 * BK * S;                 // [2][BK][S]
  float* sValid = reinterpret_cast<float*>(sV + 2 * BK * S);  // [2][BK]

  const int bh = blockIdx.x;
  const int n_q = (Tn + BQ - 1) / BQ;
  const int q0 = (n_q - 1 - (int)blockIdx.y) * BQ;
  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31, g = lane >> 2, t = lane & 3;
  const int rw = warp % RW;               // this warp's 16 rows
  const int d0 = (warp / RW) * 8 * NDW;  // and its first o column
  const int dc = WIDE ? (int)blockIdx.z * DMAX : 0;  // of the block's chunk
  const size_t base = (size_t)bh * Tn * D;
  const float* mrow = kv_mask ? kv_mask + (size_t)(bh / H) * Tn : nullptr;

  if (!WIDE) load_rows<T, DMAX, BQ, NT>(sQ, q + base, q0, Tn, D, vec, tid);

  // this thread's two rows: r0 (accumulator slots 0, 1) and r0 + 8 (2, 3)
  const int r0 = rw * 16 + g;
  float acc[NDW][4], m[2] = {NEG_INF, NEG_INF}, l[2] = {0.f, 0.f};
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

  // s += q k^T over columns [kk0, kk1) of the tiles in shared memory
  auto add_qk = [&](const T* Ks, float (&s)[NKC][4], int kk0, int kk1) {
#pragma unroll
    for (int kk = kk0; kk < kk1; kk += 8) {
      uint32_t qb[4], qs[4];
      load_a<SPLIT>(sQ, S, r0, kk, t, qb, qs);
      uint32_t kb[NKC][2], ks[NKC][2];
#pragma unroll
      for (int j = 0; j < NKC; ++j)
        load_bt<SPLIT>(Ks, S, 8 * j, kk, g, t, kb[j], ks[j]);
      if (SPLIT) {
#pragma unroll
        for (int j = 0; j < NKC; ++j) mma_tf32(s[j], qs, kb[j]);
#pragma unroll
        for (int j = 0; j < NKC; ++j) mma_tf32(s[j], qb, ks[j]);
      }
#pragma unroll
      for (int j = 0; j < NKC; ++j) mma_tf32(s[j], qb, kb[j]);
    }
  };

  const int n_kv = (Tn + BK - 1) / BK;
  const int kv_end = causal ? min(n_kv, (q0 + BQ - 1) / BK + 1) : n_kv;
  int kt = next_tile<BK>(0, kv_end, mrow, Tn, tid);
  if (!WIDE && kt < kv_end) prefetch(kt, 0);
  cp_async_commit();
  int stage = 0;
  while (kt < kv_end) {
    const int kn = next_tile<BK>(kt + 1, kv_end, mrow, Tn, tid);
    const int k0 = kt * BK;
    // a tile wholly past this warp's last row's diagonal adds nothing
    const bool active = !causal || k0 <= q0 + rw * 16 + 15;
    float s[NKC][4];
#pragma unroll
    for (int j = 0; j < NKC; ++j)
#pragma unroll
      for (int i = 0; i < 4; ++i) s[j][i] = 0.f;
    if (WIDE) {
      // s over all of D: chunk c of q and of the tile's keys through shared
      // memory, c = 0, 1, ... in every block, so every column chunk's block
      // computes the same s, bit for bit, and the same (m, l). For f32,
      // every WIDE_SPAN columns' product goes to a fresh accumulator and
      // joins s by an f32 add; bf16, whose tolerance is 300x wider than
      // the tensor cores' drift, sums in s itself
      const int nch = n_chunks<DMAX>(D);
      for (int c = 0; c < nch; ++c) {
        load_rows<T, DMAX, BQ, NT>(sQ, q + base, q0, Tn, D, vec, tid,
                                   c * DMAX);
        load_rows<T, DMAX, BK, NT>(sK, k + base, k0, Tn, D, vec, tid,
                                   c * DMAX);
        cp_async_commit();
        cp_async_wait<0>();
        __syncthreads();
        if (active && !SPLIT) {
          add_qk(sK, s, 0, DMAX);
        } else if (active) {
#pragma unroll
          for (int kk = 0; kk < DMAX; kk += WIDE_SPAN) {
            float sc[NKC][4] = {};
            add_qk(sK, sc, kk, kk + WIDE_SPAN);
#pragma unroll
            for (int j = 0; j < NKC; ++j)
#pragma unroll
              for (int i = 0; i < 4; ++i) s[j][i] += sc[j][i];
          }
        }
        __syncthreads();  // every warp is done with this chunk
      }
      // this block's chunk of v, and the tile's key validity
      load_rows<T, DMAX, BK, NT>(sV, v + base, k0, Tn, D, vec, tid, dc);
      if (tid < BK) {
        const int key = k0 + tid;
        sValid[tid] =
            (key < Tn && (mrow == nullptr || mrow[key] > 0.f)) ? 1.f : 0.f;
      }
      cp_async_commit();
      cp_async_wait<0>();
      __syncthreads();
    } else {
      if (kn < kv_end) prefetch(kn, stage ^ 1);
      cp_async_commit();
      cp_async_wait<1>();  // this tile (and Q) have landed
      __syncthreads();
      if (active) add_qk(sK + stage * BK * S, s, 0, DMAX);
    }

    const T* Vs = sV + stage * BK * S;
    const float* valid = sValid + stage * BK;
    if (active) {
      // scale and mask (NEG_INF marks a pair outside the contract), then
      // the new row max over the 4 lanes of each fragment row
      float mx[2] = {m[0], m[1]};
#pragma unroll
      for (int j = 0; j < NKC; ++j)
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int h = i >> 1;
          const int key = 8 * j + 2 * t + (i & 1);
          const bool ok = valid[key] != 0.f &&
                          (!causal || k0 + key <= q0 + r0 + 8 * h);
          s[j][i] = ok ? s[j][i] * scale : NEG_INF;
          mx[h] = fmaxf(mx[h], s[j][i]);
        }
      float alpha[2];
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        mx[h] = quad_max(mx[h]);
        alpha[h] = expf(m[h] - mx[h]);
        m[h] = mx[h];
      }
      // p = exp(s - m), 0 off the contract by a select (a row with no
      // valid key yet has m = NEG_INF, where exp(s - m) would be 1)
      float sum[2] = {0.f, 0.f};
#pragma unroll
      for (int j = 0; j < NKC; ++j)
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int h = i >> 1;
          const float p =
              s[j][i] > NEG_INF / 2 ? expf(s[j][i] - m[h]) : 0.f;
          s[j][i] = p;
          sum[h] += p;
        }
#pragma unroll
      for (int h = 0; h < 2; ++h) l[h] = l[h] * alpha[h] + sum[h];
      // o = alpha o + p v, four o column tiles at a time: the tile's p v
      // goes to a fresh accumulator (p from registers) and joins o by one
      // f32 fma, so o's running sum is not rounded inside the tensor cores
#pragma unroll
      for (int n0 = 0; n0 < NDW; n0 += 4) {
        float pv[4][4];
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int e = 0; e < 4; ++e) pv[i][e] = 0.f;
#pragma unroll
        for (int j = 0; j < NKC; ++j) {
          uint32_t ab[4], as[4];
          acc_as_a<SPLIT>(s[j], ab, as);
          uint32_t bb[4][2], bs[4][2];
#pragma unroll
          for (int i = 0; i < 4; ++i)
            mma_pair_b<SPLIT>(Vs, S, 8 * j, d0 + 8 * (n0 + i), g, t,
                              bb[i], bs[i]);
          if (SPLIT) {
#pragma unroll
            for (int i = 0; i < 4; ++i) mma_tf32(pv[i], as, bb[i]);
#pragma unroll
            for (int i = 0; i < 4; ++i) mma_tf32(pv[i], ab, bs[i]);
          }
#pragma unroll
          for (int i = 0; i < 4; ++i) mma_tf32(pv[i], ab, bb[i]);
        }
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int e = 0; e < 4; ++e)
            acc[n0 + i][e] = fmaf(acc[n0 + i][e], alpha[e >> 1], pv[i][e]);
      }
    }
    __syncthreads();  // every warp is done with this stage
    kt = kn;
    if (!WIDE) stage ^= 1;
  }
  cp_async_wait<0>();

  // the row sums over the 4 lanes of each row; a row whose max never rose
  // off NEG_INF has no valid key: exactly 0 and NEG_INF
  bool row_ok[2];
  float l_safe[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    l_safe[h] = fmaxf(quad_sum(l[h]), 1e-30f);
    row_ok[h] = m[h] > NEG_INF / 2;
  }
#pragma unroll
  for (int n = 0; n < NDW; ++n)
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int h = i >> 1;
      const int tq = q0 + r0 + 8 * h;
      const int d = dc + d0 + 8 * n + 2 * t + (i & 1);
      if (tq < Tn && d < D)
        store(&o[base + (size_t)tq * D + d],
              row_ok[h] ? acc[n][i] / l_safe[h] : 0.f);
    }
  // one warp of the row group (of the first column chunk) writes lse
  if (t == 0 && d0 == 0 && dc == 0) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int tq = q0 + r0 + 8 * h;
      if (tq < Tn)
        lse[(size_t)bh * Tn + tq] =
            row_ok[h] ? m[h] + logf(l_safe[h]) : NEG_INF;
    }
  }
}

template <typename T, int DMAX, bool WIDE = false>
cudaError_t launch(const void* q, const void* k, const void* v,
                   const void* kv_mask, void* o, void* lse, int BH, int H,
                   int Tn, int D, int causal, int vec, cudaStream_t stream) {
  constexpr size_t smem = smem_bytes<T, DMAX>();
  auto kern = flash_fwd_kernel<T, DMAX, WIDE>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid(BH, (Tn + q_rows<DMAX>() - 1) / q_rows<DMAX>(),
                  WIDE ? n_chunks<DMAX>(D) : 1);
  kern<<<grid, threads<DMAX>(), smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const float*>(kv_mask),
      static_cast<T*>(o), static_cast<float*>(lse), H, Tn, D, causal,
      1.0f / sqrtf((float)D), vec);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_d(const void* q, const void* k, const void* v,
                     const void* kv_mask, void* o, void* lse, int BH, int H,
                     int Tn, int D, int causal, cudaStream_t stream) {
  // cp.async moves 16-byte pieces: rows of a whole number of them, and
  // 16-byte aligned tensors
  const int vec = (D * (int)sizeof(T)) % 16 == 0 &&
                  ((uintptr_t)q | (uintptr_t)k | (uintptr_t)v) % 16 == 0;
  if (D <= 32)
    return launch<T, 32>(q, k, v, kv_mask, o, lse, BH, H, Tn, D, causal, vec,
                         stream);
  if (D <= 64)
    return launch<T, 64>(q, k, v, kv_mask, o, lse, BH, H, Tn, D, causal, vec,
                         stream);
  if (D <= 128)
    return launch<T, 128>(q, k, v, kv_mask, o, lse, BH, H, Tn, D, causal,
                          vec, stream);
  if (D <= 256)
    return launch<T, 256>(q, k, v, kv_mask, o, lse, BH, H, Tn, D, causal,
                          vec, stream);
  return launch<T, 256, true>(q, k, v, kv_mask, o, lse, BH, H, Tn, D, causal,
                              vec, stream);
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (q, k, v and o share it). Returns the
// CUDA error of the launch (0 = launched).
extern "C" int dl4j_flash_attn_fwd(const void* q, const void* k,
                                   const void* v, const void* kv_mask,
                                   void* o, void* lse, int BH, int H, int Tn,
                                   int D, int causal, int dtype,
                                   void* stream) {
  if (BH < 1 || H < 1 || BH % H || Tn < 1 ||
      (Tn + BQ_MIN - 1) / BQ_MIN > 65535 || D < 1 ||
      n_chunks<256>(D) > 65535 || (dtype != 0 && dtype != 1))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return (int)launch_d<float>(q, k, v, kv_mask, o, lse, BH, H, Tn, D,
                                causal, s);
  return (int)launch_d<__nv_bfloat16>(q, k, v, kv_mask, o, lse, BH, H, Tn, D,
                                      causal, s);
}
