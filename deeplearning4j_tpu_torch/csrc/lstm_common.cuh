// Shared by the LSTM kernels (lstm_fwd_infer.cu K1, lstm_fwd_train.cu K2,
// lstm_bwd.cu K3): the type helpers, the bodies of the forward
// recurrence, which K1's and K2's kernels inline from the same source so
// that K2's hs and c_T equal K1's bit for bit (each kernel keeps its own
// name, so a profiler trace tells them apart), and the cluster launch
// helpers and phase clock that K1-K3's resident bodies share. See
// lstm_fwd_infer.cu for the forward's contract, design and bound, and
// lstm_bwd.cu for the backward's.

#pragma once

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cmath>

namespace dl4j_lstm {

constexpr int MAX_UNITS = 256;  // hidden units a block works on at once
constexpr int KSPLIT = 4;       // slices of each unit's reduction

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16(x);
}
// x rounded to T and back: the value of x as a carry in the input type
__device__ __forceinline__ float round_to(float x, float) { return x; }
__device__ __forceinline__ float round_to(float x, __nv_bfloat16) {
  return __bfloat162float(__float2bfloat16(x));
}
__device__ __forceinline__ float sigmoid_(float x) {
  return 1.f / (1.f + expf(-x));
}

// The block width for hidden size H: one thread per unit, up to MAX_UNITS.
inline int units_per_block(int H) {
  return H < MAX_UNITS ? (H + 31) / 32 * 32 : MAX_UNITS;
}

// xz: [Tn, B, 4H]; rw: [H, 4H]; pw: [3, H]; h0, c0: [B, H]; hs: [Tn, B, H];
// all contiguous, one type T. kSave = false (K1) writes cT [B, H] once;
// kSave = true (K2) writes gates [Tn, B, 4H] (post-activation i, f, g, o)
// and cs [Tn, B, H] every step instead. Grid: one block per batch row.
// Block: (units, KSPLIT) threads; thread (x, y) sums slice y of the
// reduction over k for hidden unit x (and x + blockDim.x, ... in later
// chunks). `smem` is the block's dynamic shared memory.
template <typename T, bool kSave>
__device__ __forceinline__ void lstm_fwd_steps(
    float* smem, const T* __restrict__ xz, const T* __restrict__ rw,
    const T* __restrict__ pw, const T* __restrict__ h0,
    const T* __restrict__ c0, T* __restrict__ hs, T* __restrict__ gates,
    T* __restrict__ cs, T* __restrict__ cT, int Tn, int B, int H,
    float forget_bias) {
  const int nx = blockDim.x, tx = threadIdx.x, ks = threadIdx.y;
  float* sH = smem;          // [2][H]: h_{t-1} and h_t in turns
  float* sC = sH + 2 * H;    // [H]
  float* sP = sC + H;        // [KSPLIT-1][4][nx] partial sums
  const int b = blockIdx.x;
  const int H4 = 4 * H;
  const int kc = (H + KSPLIT - 1) / KSPLIT;
  const int k_lo = min(H, ks * kc), k_hi = min(H, k_lo + kc);

  for (int u = ks * nx + tx; u < H; u += nx * KSPLIT) {
    sH[u] = to_f32(h0[(size_t)b * H + u]);
    sC[u] = to_f32(c0[(size_t)b * H + u]);
  }
  __syncthreads();

  for (int t = 0; t < Tn; ++t) {
    const float* hp = sH + (t & 1) * H;
    float* hn = sH + ((t + 1) & 1) * H;
    const size_t row = (size_t)t * B + b;
    const T* xzt = xz + row * H4;
    for (int u0 = 0; u0 < H; u0 += nx) {
      const int u = u0 + tx;
      const bool active = u < H;
      const bool owner = ks == 0 && active;  // combines and writes unit u
      float xv[4], acc[4] = {0.f, 0.f, 0.f, 0.f};
      float gi = 0.f, gf = 0.f, gg = 0.f, go = 0.f, c_new = 0.f;
#pragma unroll
      for (int q = 0; q < 4; ++q)  // loaded now, added after the sum
        xv[q] = owner ? to_f32(xzt[q * H + u]) : 0.f;
      // acc[q] = sum over this slice of k of h[k] * rw[k, qH + u], one
      // fmaf chain per q in k order. K2 reads four rows of rw into
      // registers ahead of their products, K1 one row at a time: the sums,
      // and so the bits, are the same. nvcc schedules the two loops of the
      // two kernels differently: on an NVIDIA H100 80GB HBM3 at 700 W, at
      // T=50, B=32, H=256, K2 took 1.14 ms with K1's loop (twice K1's time
      // for the same steps, chip_smoke.py) and 0.57 ms with this one,
      // which made K1 slower.
      if (active && kSave) {
        const T* w = rw + u;
        int k = k_lo;
        for (; k + 4 <= k_hi; k += 4) {
          float wv[4][4], hv[4];
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            const T* wk = w + (size_t)(k + j) * H4;
            hv[j] = hp[k + j];
#pragma unroll
            for (int q = 0; q < 4; ++q) wv[j][q] = to_f32(wk[q * H]);
          }
#pragma unroll
          for (int j = 0; j < 4; ++j)
#pragma unroll
            for (int q = 0; q < 4; ++q)
              acc[q] = fmaf(hv[j], wv[j][q], acc[q]);
        }
        for (; k < k_hi; ++k) {
          const T* wk = w + (size_t)k * H4;
          const float hk = hp[k];
          acc[0] = fmaf(hk, to_f32(wk[0]), acc[0]);
          acc[1] = fmaf(hk, to_f32(wk[H]), acc[1]);
          acc[2] = fmaf(hk, to_f32(wk[2 * H]), acc[2]);
          acc[3] = fmaf(hk, to_f32(wk[3 * H]), acc[3]);
        }
      } else if (active) {
        const T* w = rw + u;
#pragma unroll 4
        for (int k = k_lo; k < k_hi; ++k) {
          const T* wk = w + (size_t)k * H4;
          const float hk = hp[k];
          acc[0] = fmaf(hk, to_f32(wk[0]), acc[0]);
          acc[1] = fmaf(hk, to_f32(wk[H]), acc[1]);
          acc[2] = fmaf(hk, to_f32(wk[2 * H]), acc[2]);
          acc[3] = fmaf(hk, to_f32(wk[3 * H]), acc[3]);
        }
      }
      if (ks > 0) {
#pragma unroll
        for (int q = 0; q < 4; ++q) sP[((ks - 1) * 4 + q) * nx + tx] = acc[q];
      }
      __syncthreads();  // the partial sums of this chunk are in
      if (owner) {
#pragma unroll
        for (int q = 0; q < 4; ++q) {
#pragma unroll
          for (int s = 0; s < KSPLIT - 1; ++s)
            acc[q] += sP[(s * 4 + q) * nx + tx];
          acc[q] += xv[q];
        }
        const float pi = to_f32(pw[u]), pf = to_f32(pw[H + u]);
        const float po = to_f32(pw[2 * H + u]);
        const float c = sC[u];
        gi = sigmoid_(acc[0] + c * pi);
        gf = sigmoid_(acc[1] + c * pf + forget_bias);
        gg = tanhf(acc[2]);
        c_new = gf * c + gi * gg;
        go = sigmoid_(acc[3] + c_new * po);
        const float h_new = go * tanhf(c_new);
        sC[u] = round_to(c_new, T{});
        hn[u] = round_to(h_new, T{});
        store(&hs[row * H + u], h_new);
      }
      // the partial sums are read; after the last chunk, h_t is complete
      // and h_{t-1}'s readers are done
      __syncthreads();
      if (kSave && owner) {  // the residuals, off the step's critical path
        T* gt = gates + row * H4;
        store(&gt[u], gi);
        store(&gt[H + u], gf);
        store(&gt[2 * H + u], gg);
        store(&gt[3 * H + u], go);
        store(&cs[row * H + u], c_new);
      }
    }
  }

  if (!kSave && ks == 0)
    for (int u = tx; u < H; u += nx) store(&cT[(size_t)b * H + u], sC[u]);
}

// Dynamic shared memory of the forward recurrence's block for hidden size
// H: two buffers of h, one of c and the partial sums.
inline size_t fwd_smem_bytes(int H) {
  return sizeof(float) *
         (3 * (size_t)H + (KSPLIT - 1) * 4 * units_per_block(H));
}

// ------------------------------------------------------- the resident body
//
// A cluster of CLUSTER CTAs owns RES_ROWS batch rows; CTA r of the cluster owns
// hidden units [r U, r U + U), U = ceil(H / CLUSTER), and their four gate
// columns (NC = 4 U), and keeps its slice of rw, [Hp, NC], in its shared
// memory for all T steps (Hp = H padded to a multiple of 4 RES_KSPLIT with
// zero rows). A step: z = h_{t-1} @ rw_slice for the cluster's rows, each
// thread summing two columns over one of RES_KSPLIT slices of k in
// registers; the slices' partial sums meet in shared memory; then one
// thread per (row, unit) adds them in slice order, adds xz[t] (loaded into
// registers while the product ran), applies the gates, keeps c in a
// register, and writes h_t into every CTA's next h buffer through
// distributed shared memory; one cluster barrier ends the step.

constexpr int CLUSTER = 8;            // CTAs of a cluster (portable size)
constexpr int RES_THREADS = 512;      // threads of a CTA
constexpr int RES_KSPLIT = 8;         // slices of each column's sum over k
constexpr int RES_PAIRS = RES_THREADS / RES_KSPLIT;  // column pairs a pass
// Batch rows a cluster. tools/lstm_ab.py --rows builds other values with
// -DDL4J_LSTM_RES_ROWS=n to time them; every row's arithmetic is the same
// whatever the rows a cluster, so the outputs are too, bit for bit.
#ifndef DL4J_LSTM_RES_ROWS
#define DL4J_LSTM_RES_ROWS 4
#endif
constexpr int RES_ROWS = DL4J_LSTM_RES_ROWS;
constexpr size_t MAX_SMEM = 227 * 1024;  // a CTA's shared memory on an H100

__host__ __device__ inline int res_units(int H) {
  return (H + CLUSTER - 1) / CLUSTER;
}
inline int res_hp(int H) {
  return (H + 4 * RES_KSPLIT - 1) / (4 * RES_KSPLIT) * (4 * RES_KSPLIT);
}

// Dynamic shared memory of a resident CTA: its slice of rw in the input
// type, two buffers of h [RES_ROWS][Hp] and the partial sums
// [RES_KSPLIT][RES_ROWS][NC] in f32. 152 KiB at H = 256 in f32.
inline size_t resident_smem_bytes(int H, size_t elem) {
  const size_t hp = res_hp(H), nc = 4 * res_units(H);
  return elem * hp * nc + sizeof(float) * (2 * RES_ROWS * hp +
                                           (size_t)RES_KSPLIT * RES_ROWS * nc);
}

// The body a forward launch takes, from (H, input type) alone: the
// resident body wherever hidden size H fits a cluster (H <= 312 in f32,
// 424 in bf16: fused_lstm.RESIDENT_MAX_HIDDEN), else the streaming body.
inline bool resident_fits(int H, size_t elem) {
  return resident_smem_bytes(H, elem) <= MAX_SMEM &&
         RES_ROWS * res_units(H) <= RES_THREADS;
}

#ifdef DL4J_LSTM_PHASES
// Cycles (clock64) of each phase of a resident body's steps, summed over
// the steps by thread 0 of the first CTA, then T: read by
// tools/lstm_ab.py --phases from a build with -DDL4J_LSTM_PHASES.
__device__ long long lstm_phases[6];
#endif

// A resident body's phase clock: a no-op unless built with
// -DDL4J_LSTM_PHASES. Phases: 0 the product, 1 the block barriers, 2 the
// gates (K3: dz and the dc carry), 3 the DSMEM exchange and the step's
// stores, 4 the cluster barrier (K3: the wait for the step's partials);
// mark(i) adds the cycles since the last mark to phase i.
struct PhaseClock {
#ifdef DL4J_LSTM_PHASES
  bool on;
  long long sum[5], last;
  __device__ void start() {
    on = blockIdx.x == 0 && threadIdx.x == 0;
    for (int i = 0; i < 5; ++i) sum[i] = 0;
    last = clock64();
  }
  __device__ void mark(int i) {
    if (!on) return;
    const long long now = clock64();
    sum[i] += now - last;
    last = now;
  }
  __device__ void flush(int Tn) {
    if (!on) return;
    for (int i = 0; i < 5; ++i) lstm_phases[i] = sum[i];
    lstm_phases[5] = Tn;
  }
#else
  __device__ void start() {}
  __device__ void mark(int) {}
  __device__ void flush(int) {}
#endif
};

__device__ __forceinline__ float2 load2(const float* p) {
  return *reinterpret_cast<const float2*>(p);
}
__device__ __forceinline__ float2 load2(const __nv_bfloat16* p) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
}

// Same arguments and outputs as lstm_fwd_steps. Grid: CLUSTER x
// ceil(B / RES_ROWS) CTAs in clusters of CLUSTER; RES_THREADS threads a
// CTA.
template <typename T, bool kSave>
__device__ __forceinline__ void lstm_fwd_steps_resident(
    float* smem, const T* __restrict__ xz, const T* __restrict__ rw,
    const T* __restrict__ pw, const T* __restrict__ h0,
    const T* __restrict__ c0, T* __restrict__ hs, T* __restrict__ gates,
    T* __restrict__ cs, T* __restrict__ cT, int Tn, int B, int H,
    float forget_bias) {
  namespace cg = cooperative_groups;
  cg::cluster_group cluster = cg::this_cluster();
  const int tid = threadIdx.x;
  const int rank = (int)cluster.block_rank();
  const int U = (H + CLUSTER - 1) / CLUSTER, NC = 4 * U;
  const int Hp = (H + 4 * RES_KSPLIT - 1) / (4 * RES_KSPLIT) * (4 * RES_KSPLIT);
  const int u0 = rank * U;                            // this CTA's units
  const int b0 = (int)(blockIdx.x / CLUSTER) * RES_ROWS;  // cluster's rows
  const int H4 = 4 * H;
  T* sW = reinterpret_cast<T*>(smem);                        // [Hp][NC]
  // [2][RES_ROWS][Hp], then [RES_KSPLIT][RES_ROWS][NC]
  float* sH = reinterpret_cast<float*>(sW + (size_t)Hp * NC);
  float* sP = sH + 2 * RES_ROWS * Hp;

  // rw's slice: column c = q U + j of this CTA is rw's column q H + u0 + j
  for (int i = tid; i < Hp * NC; i += RES_THREADS) {
    const int k = i / NC, c = i % NC, u = u0 + c % U;
    store(&sW[i],
          (k < H && u < H) ? to_f32(rw[(size_t)k * H4 + (c / U) * H + u])
                           : 0.f);
  }
  for (int i = tid; i < RES_ROWS * Hp; i += RES_THREADS) {
    const int r = i / Hp, k = i % Hp, b = b0 + r;
    sH[i] = (k < H && b < B) ? to_f32(h0[(size_t)b * H + k]) : 0.f;
    sH[RES_ROWS * Hp + i] = 0.f;  // the padding of the second buffer stays 0
  }
  // the thread of (row r, unit u) for the gates, c and h
  const bool gate = tid < RES_ROWS * U;
  const int r = gate ? tid / U : 0, j = tid % U, u = u0 + j, b = b0 + r;
  const bool valid = gate && u < H && b < B;
  float c = 0.f, pi = 0.f, pf = 0.f, po = 0.f, xn[4] = {0.f, 0.f, 0.f, 0.f};
  if (valid) {
    c = to_f32(c0[(size_t)b * H + u]);
    pi = to_f32(pw[u]);
    pf = to_f32(pw[H + u]);
    po = to_f32(pw[2 * H + u]);
#pragma unroll
    for (int q = 0; q < 4; ++q) xn[q] = to_f32(xz[(size_t)b * H4 + q * H + u]);
  }
  const int ks = tid / RES_PAIRS, pair = tid % RES_PAIRS;
  const int kc = Hp / RES_KSPLIT, k_lo = ks * kc;
  cluster.sync();  // every CTA's buffers are ready before any remote write

  PhaseClock clock;  // product, barrier, gates, exchange, cluster barrier
  clock.start();
  for (int t = 0; t < Tn; ++t) {
    const int cur = t & 1;
    // the partial sums over slice ks of k, one fmaf chain per column in k
    // order, for columns (col, col + 1) and every row
    const float* hb = sH + cur * RES_ROWS * Hp;
    for (int col = 2 * pair; col < NC; col += 2 * RES_PAIRS) {
      float acc[RES_ROWS][2];
#pragma unroll
      for (int i = 0; i < RES_ROWS; ++i) acc[i][0] = acc[i][1] = 0.f;
      for (int k = k_lo; k < k_lo + kc; k += 4) {
        float2 w[4];
#pragma unroll
        for (int e = 0; e < 4; ++e) w[e] = load2(sW + (k + e) * NC + col);
#pragma unroll
        for (int i = 0; i < RES_ROWS; ++i) {
          const float4 h4 = *reinterpret_cast<const float4*>(hb + i * Hp + k);
          acc[i][0] = fmaf(h4.x, w[0].x, acc[i][0]);
          acc[i][1] = fmaf(h4.x, w[0].y, acc[i][1]);
          acc[i][0] = fmaf(h4.y, w[1].x, acc[i][0]);
          acc[i][1] = fmaf(h4.y, w[1].y, acc[i][1]);
          acc[i][0] = fmaf(h4.z, w[2].x, acc[i][0]);
          acc[i][1] = fmaf(h4.z, w[2].y, acc[i][1]);
          acc[i][0] = fmaf(h4.w, w[3].x, acc[i][0]);
          acc[i][1] = fmaf(h4.w, w[3].y, acc[i][1]);
        }
      }
#pragma unroll
      for (int i = 0; i < RES_ROWS; ++i)
        *reinterpret_cast<float2*>(sP + (ks * RES_ROWS + i) * NC + col) =
            make_float2(acc[i][0], acc[i][1]);
    }
    clock.mark(0);
    __syncthreads();  // the partial sums are in
    clock.mark(1);

    if (gate) {
      float z[4];
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const float* p = sP + r * NC + q * U + j;
        z[q] = p[0];
#pragma unroll
        for (int s = 1; s < RES_KSPLIT; ++s) z[q] += p[s * RES_ROWS * NC];
        z[q] += xn[q];  // the product first, then xz[t]
      }
      const float gi = sigmoid_(z[0] + c * pi);
      const float gf = sigmoid_(z[1] + c * pf + forget_bias);
      const float gg = tanhf(z[2]);
      const float c_new = gf * c + gi * gg;
      const float go = sigmoid_(z[3] + c_new * po);
      const float h_new = go * tanhf(c_new);
      c = round_to(c_new, T{});
      clock.mark(2);
      if (u < H) {  // into slot (r, u) of every CTA's next h buffer
        const float h_carry = round_to(h_new, T{});
        float* slot = sH + ((cur ^ 1) * RES_ROWS + r) * Hp + u;
#pragma unroll
        for (int d = 0; d < CLUSTER; ++d)
          *cluster.map_shared_rank(slot, d) = h_carry;
      }
      if (valid) {  // the step's outputs, and xz[t + 1] for the next
        const size_t row = (size_t)t * B + b;
        store(&hs[row * H + u], h_new);
        if (kSave) {
          T* gt = gates + row * H4 + u;
          store(&gt[0], gi);
          store(&gt[H], gf);
          store(&gt[2 * H], gg);
          store(&gt[3 * H], go);
          store(&cs[row * H + u], c);
        }
        if (t + 1 < Tn) {
          const T* x1 = xz + (row + B) * H4 + u;
#pragma unroll
          for (int q = 0; q < 4; ++q) xn[q] = to_f32(x1[q * H]);
        }
      }
    }
    clock.mark(3);
    // h_t is in every CTA's buffer, and every read of h_{t-1} and of the
    // partial sums is done
    cluster.sync();
    clock.mark(4);
  }
  clock.flush(Tn);
  if (!kSave && valid) store(&cT[(size_t)b * H + u], c);
}

// Launch of the streaming body: one block of (units, KSPLIT) threads per
// batch row.
template <typename... KArgs, typename... Args>
cudaError_t launch_streaming(void (*kern)(KArgs...), int B, int H,
                             cudaStream_t stream, Args... args) {
  kern<<<B, dim3(units_per_block(H), KSPLIT), fwd_smem_bytes(H), stream>>>(
      args...);
  return cudaGetLastError();
}

// A resident body's launch configuration (clusters of CLUSTER CTAs, one
// cluster per RES_ROWS batch rows, `smem` bytes of dynamic shared memory a
// CTA); `attr` must outlive `cfg`. The caller has checked that the body
// fits.
template <typename... KArgs>
cudaError_t resident_config(void (*kern)(KArgs...), int B, size_t smem,
                            cudaStream_t stream, cudaLaunchConfig_t& cfg,
                            cudaLaunchAttribute& attr) {
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  cfg = cudaLaunchConfig_t{};
  cfg.gridDim = dim3(CLUSTER * ((B + RES_ROWS - 1) / RES_ROWS));
  cfg.blockDim = dim3(RES_THREADS);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  attr.id = cudaLaunchAttributeClusterDimension;
  attr.val.clusterDim.x = CLUSTER;
  attr.val.clusterDim.y = 1;
  attr.val.clusterDim.z = 1;
  cfg.attrs = &attr;
  cfg.numAttrs = 1;
  return cudaSuccess;
}

template <typename... KArgs, typename... Args>
cudaError_t launch_resident(void (*kern)(KArgs...), int B, size_t smem,
                            cudaStream_t stream, Args... args) {
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr;
  cudaError_t err = resident_config(kern, B, smem, stream, cfg, attr);
  if (err != cudaSuccess) return err;
  err = cudaLaunchKernelEx(&cfg, kern, args...);
  return err != cudaSuccess ? err : cudaGetLastError();
}

// What a launch for B rows runs, `kern` being its resident kernel and
// `res_smem` that kernel's shared memory (0: the launch takes the
// streaming body, one block of `stream_threads` threads and `stream_smem`
// bytes a row): out[0] rows a cluster (0 = the streaming body), out[1]
// CTAs a cluster (0 = no cluster), out[2] blocks, out[3] threads a block,
// out[4] dynamic shared memory bytes, out[5] clusters that fit on the card
// at once (cudaOccupancyMaxActiveClusters; -1 for the streaming body).
template <typename... KArgs>
cudaError_t describe(void (*kern)(KArgs...), int B, size_t res_smem,
                     int stream_threads, size_t stream_smem, int* out) {
  if (res_smem == 0) {
    const int plan[6] = {0, 0, B, stream_threads, (int)stream_smem, -1};
    for (int i = 0; i < 6; ++i) out[i] = plan[i];
    return cudaSuccess;
  }
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr;
  cudaError_t err = resident_config(kern, B, res_smem, 0, cfg, attr);
  if (err != cudaSuccess) return err;
  int n = 0;
  err = cudaOccupancyMaxActiveClusters(&n, kern, &cfg);
  const int plan[6] = {RES_ROWS, CLUSTER, (int)cfg.gridDim.x, RES_THREADS,
                       (int)cfg.dynamicSmemBytes, n};
  for (int i = 0; i < 6; ++i) out[i] = plan[i];
  return err;
}

// `describe` for a forward launch (K1, K2) for (B, H, elem).
template <typename... KArgs>
cudaError_t describe_fwd(void (*kern)(KArgs...), int B, int H, size_t elem,
                         int* out) {
  return describe(kern, B,
                  resident_fits(H, elem) ? resident_smem_bytes(H, elem) : 0,
                  units_per_block(H) * KSPLIT, fwd_smem_bytes(H), out);
}

}  // namespace dl4j_lstm

#ifdef DL4J_LSTM_PHASES
// The resident body's phase cycles of the last launch (lstm_phases).
extern "C" int dl4j_lstm_phases_read(long long* out) {
  return (int)cudaMemcpyFromSymbol(out, dl4j_lstm::lstm_phases,
                                   6 * sizeof(long long));
}
#endif
