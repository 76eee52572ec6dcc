// LSTM backward (reverse-time sweep) for Hopper (sm_90a), CUDA cores, f32
// arithmetic.
//
// Replaces the TPU kernel deeplearning4j_tpu/ops/pallas_kernels.py
// `_lstm_bwd_kernel` (launched by `_run_lstm_bwd`, the backward of
// `_fused_lstm_core`'s custom VJP). Contract, term for term, over the
// forward's residuals gates [T, B, 4H] (post-activation i, f, g, o) and
// cs [T, B, H] (from K2, lstm_fwd_train.cu), the cotangent eps = dL/dhs
// [T, B, H], rwT = rw^T [4H, H], peepholes pw [3, H] (rows i, f, o) and the
// carry seeds dh_T, dc_T [B, H]; for t = T-1 down to 0, with c_prev = cs[t-1]
// (c0 at t = 0; the kernel reads cs and c0 itself instead of taking the
// concatenated c_prev the JAX wrapper builds):
//   dh  = dh_carry + eps[t];        do = dh * tanh(c_t)
//   dzo = do * o(1-o)
//   dc  = dc_carry + dh * o * (1 - tanh^2 c_t) + dzo * po
//   dzi = dc * g * i(1-i);  dzf = dc * c_prev * f(1-f);  dzg = dc * i(1-g^2)
//   dc_prev = dc * f + dzi * pi + dzf * pf;   dh_prev = dz @ rw^T
// dz[t] = [dzi, dzf, dzg, dzo] is written every step and the last carries
// as dh0, dc0. Types: float32, or bfloat16 with f32 arithmetic; dz and the
// (dh, dc) carry are rounded to the input type every step, where the TPU
// kernel keeps them in its output and VMEM scratch of that type, and
// dh_prev is summed from the rounded dz.
//
// What bounds it on an H100: at the char-RNN's tBPTT window (T=50, B=32,
// H=256, f32) dz @ rw^T is 2*32*1024*256*50 = 0.84 GFLOP, 0.0051 ms at the
// 3xTF32 tensor-core peak (0.0125 ms at the f32 CUDA-core peak of 67
// TFLOP/s, the units it uses), against ~17.6 MB of eps / gates / cs / rwT
// / dz traffic, 0.0053 ms at 3.35 TB/s: the bound is bytes. As in the
// forward (K1, K2), the T dependent steps hold it far above that bound,
// each with only 32 x 256 outputs of a product over 1024 terms, and rw^T
// (1 MiB in f32) is more than one SM's 227 KB of shared memory.
//
// Two bodies, picked in the C entry from (H, dtype) alone
// (bwd_resident_fits):
//   * the resident body, wherever rw^T's slices fit a cluster (H <= 312 in
//     f32, 420 in bf16: fused_lstm.BWD_RESIDENT_MAX_HIDDEN) and every CTA
//     of the cluster owns a unit, the mirror image of K1/K2's. A cluster of 8 CTAs takes 4 batch rows; CTA r owns
//     hidden units [r U, r U + U), U = ceil(H / 8), and their four gate
//     columns of dz (column q U + j of the CTA is dz's column q H + r U +
//     j), and keeps the matching rows of rw^T ([4U, H], 128 KiB at H = 256
//     in f32) in shared memory for all T steps. A step: one thread per
//     (row, unit) waits for the last step's partial sums of its dh, adds
//     them in rank order and rounds them into its dh carry, adds eps[t]
//     (loaded while the last step ran), computes its four dz entries and
//     its dc carry in registers, writes dz[t] and puts the rounded dz in
//     shared memory; each of 512 threads then sums, for a pair of k and
//     every row, the CTA's **partial** dh_prev[row][k] over one of 4
//     slices of its own dz columns (an fmaf chain in column order), so no
//     CTA needs another's dz; the slices meet in shared memory and are
//     added in slice order, and each (row, k) goes through distributed
//     shared memory (st.async) into slot [rank][row][k - d U] of the
//     receive buffer of CTA d, the owner of unit k. Two receive buffers,
//     by the step's parity, each with an mbarrier that counts the bytes
//     of a step's partials from all 8 CTAs: two block barriers a step and
//     no cluster barrier (with one a step in their place, 1,230 of a
//     step's ~5,150 cycles, K3 took 0.147 ms against 0.130 in turns on
//     an NVIDIA H100 80GB HBM3 at 700 W, tools/lstm_ab.py --kernel bwd).
//     The products stay on CUDA cores, as in K1/K2: at 4
//     rows a step's [4 x 128] x [128 x 256] is bound by the shared-memory
//     reads of the slice either way (PERF.md, "CUDA cores, not tensor
//     cores");
//   * the streaming body, past that up to H = 3072 (fused_lstm.MAX_HIDDEN),
//     the first design, which mirrors K1's streaming body: one block per
//     batch row looping t from T-1 down to 0; thread (x, 0) owns hidden
//     unit x (and x + blockDim.x, ...), computes its four dz entries and
//     its dc carry and puts dz in shared memory; thread (x, y) then sums
//     slice y of dh_prev[x] = sum_j dz[j] rwT[j, x] over the 4H columns
//     (slice y is gate block y), reading eight rows of rwT from L2 ahead of
//     their products (adjacent threads read adjacent addresses of rwT,
//     which is why the wrapper passes rw transposed); slices 1..3 add
//     their sums through shared memory and the owner rounds dh_prev into
//     the carry; two __syncthreads() a step while H <= 256 (one more per
//     extra chunk of 256 units). Its shared memory holds the carries, dz
//     and the partial sums: 4 * (6H + 3 * 256) bytes, 75 KB at H = 3072, so
//     above 48 KB the launch raises the block's dynamic shared-memory
//     limit.
// Both bodies sum in a fixed order and use no atomics, so two launches on
// the same inputs are bitwise equal. A refused launch (a cluster the card
// cannot place included) comes back as its CUDA error. Measured on an
// NVIDIA H100 80GB HBM3 at 700 W: PERF.md's kernel table (chip_smoke.py,
// tools/lstm_ab.py --kernel bwd). A step of the resident body at 4 rows
// (tools/lstm_ab.py --kernel bwd --phases, 1.98 GHz): the product ~2,500
// cycles (bound by the shared-memory reads of the slice, as in K1), dz
// ~700, the exchange ~400, the wait for the partials ~360.

#include "lstm_common.cuh"

namespace dl4j_lstm {

// One (row, unit)'s step of the sweep from its carries (dh already holds
// eps[t]): its four dz entries (i, f, g, o) and the next dc carry, before
// rounding. Both bodies run it.
__device__ __forceinline__ float bwd_cell(float dh, float dc_carry, float i,
                                          float f, float g, float o,
                                          float c_t, float c_prev, float pi,
                                          float pf, float po, float* d) {
  const float tc = tanhf(c_t);
  const float dzo = dh * tc * o * (1.f - o);
  const float dc = dc_carry + dh * o * (1.f - tc * tc) + dzo * po;
  d[0] = dc * g * i * (1.f - i);
  d[1] = dc * c_prev * f * (1.f - f);
  d[2] = dc * i * (1.f - g * g);
  d[3] = dzo;
  return dc * f + d[0] * pi + d[1] * pf;
}

// eps, cs: [Tn, B, H]; gates, dz: [Tn, B, 4H]; rwT: [4H, H]; pw: [3, H];
// c0, dhT, dcT, dh0, dc0: [B, H]; all contiguous, one type T. Grid: one
// block per batch row. Block: (units, KSPLIT) threads.
template <typename T>
__device__ __forceinline__ void lstm_bwd_steps(
    float* smem, const T* __restrict__ eps, const T* __restrict__ gates,
    const T* __restrict__ cs, const T* __restrict__ c0,
    const T* __restrict__ rwT, const T* __restrict__ pw,
    const T* __restrict__ dhT, const T* __restrict__ dcT, T* __restrict__ dz,
    T* __restrict__ dh0, T* __restrict__ dc0, int Tn, int B, int H) {
  const int nx = blockDim.x, tx = threadIdx.x, ks = threadIdx.y;
  float* sDh = smem;          // [H] the dh carry
  float* sDc = sDh + H;       // [H] the dc carry
  float* sDz = sDc + H;       // [4H] this step's dz
  float* sP = sDz + 4 * H;    // [KSPLIT-1][nx] partial sums
  const int b = blockIdx.x;
  const int H4 = 4 * H;

  // each owner seeds the carries of its own units, which only it touches
  // until the end
  if (ks == 0)
    for (int u = tx; u < H; u += nx) {
      sDh[u] = to_f32(dhT[(size_t)b * H + u]);
      sDc[u] = to_f32(dcT[(size_t)b * H + u]);
    }

  for (int t = Tn - 1; t >= 0; --t) {
    const size_t row = (size_t)t * B + b;
    if (ks == 0) {  // 1. the owner's four dz entries and its dc carry
      const T* g4 = gates + row * H4;
      const T* cp = t > 0 ? cs + (row - B) * H : c0 + (size_t)b * H;
      for (int u = tx; u < H; u += nx) {
        float d[4];
        const float dc = bwd_cell(
            sDh[u] + to_f32(eps[row * H + u]), sDc[u], to_f32(g4[u]),
            to_f32(g4[H + u]), to_f32(g4[2 * H + u]), to_f32(g4[3 * H + u]),
            to_f32(cs[row * H + u]), to_f32(cp[u]), to_f32(pw[u]),
            to_f32(pw[H + u]), to_f32(pw[2 * H + u]), d);
        sDc[u] = round_to(dc, T{});
        T* dzt = dz + row * H4;
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          sDz[q * H + u] = round_to(d[q], T{});
          store(&dzt[q * H + u], d[q]);
        }
      }
    }
    __syncthreads();  // dz is complete
    // 2. dh_prev = dz @ rw^T, gate block ks of the sum in thread row ks
    const float* d = sDz + ks * H;
    const T* wq = rwT + (size_t)ks * H * H;
    for (int u0 = 0; u0 < H; u0 += nx) {
      const int k = u0 + tx;
      float acc = 0.f;
      if (k < H) {  // eight rows of rw^T read ahead of their products
        const T* w = wq + k;
        int j = 0;
        for (; j + 8 <= H; j += 8) {
          float wv[8];
#pragma unroll
          for (int jj = 0; jj < 8; ++jj)
            wv[jj] = to_f32(w[(size_t)(j + jj) * H]);
#pragma unroll
          for (int jj = 0; jj < 8; ++jj) acc = fmaf(d[j + jj], wv[jj], acc);
        }
        for (; j < H; ++j) acc = fmaf(d[j], to_f32(w[(size_t)j * H]), acc);
      }
      if (ks > 0) sP[(ks - 1) * nx + tx] = acc;
      __syncthreads();  // the partial sums of this chunk are in
      if (ks == 0 && k < H) {
#pragma unroll
        for (int s = 0; s < KSPLIT - 1; ++s) acc += sP[s * nx + tx];
        sDh[k] = round_to(acc, T{});
      }
      // the next chunk overwrites the partial sums; after the last chunk
      // the next step's first barrier orders them, and dz is read
      if (u0 + nx < H) __syncthreads();
    }
  }

  if (ks == 0)
    for (int u = tx; u < H; u += nx) {
      store(&dh0[(size_t)b * H + u], sDh[u]);
      store(&dc0[(size_t)b * H + u], sDc[u]);
    }
}

// Dynamic shared memory of the streaming body's block for hidden size H.
inline size_t bwd_smem_bytes(int H) {
  return sizeof(float) * (6 * (size_t)H + (KSPLIT - 1) * units_per_block(H));
}

// ------------------------------------------------------- the resident body

constexpr int BWD_CSPLIT = 4;  // slices of a CTA's dz columns in the product
constexpr int BWD_PAIRS = RES_THREADS / BWD_CSPLIT;  // pairs of k a pass
constexpr int BWD_SENDS = 4;   // (row, k) partials a thread sends a step

// A CTA's dz columns, 4U padded with zero columns to a multiple of
// 4 BWD_CSPLIT (each slice a multiple of 4), and H padded to even (the
// product's pairs of k).
__host__ __device__ inline int bwd_ncp(int H) {
  return (4 * res_units(H) + 4 * BWD_CSPLIT - 1) / (4 * BWD_CSPLIT) *
         (4 * BWD_CSPLIT);
}
__host__ __device__ inline int bwd_hp(int H) { return (H + 1) / 2 * 2; }

// Dynamic shared memory of a resident CTA: its rows of rw^T [NCp, Hp] in
// the input type; dz [RES_ROWS][NCp], the slices' partial sums
// [BWD_CSPLIT][RES_ROWS][Hp] and two receive buffers
// [2][CLUSTER][RES_ROWS][U] in f32; the buffers' two mbarriers. 154 KiB
// (and 16 bytes) at H = 256 in f32.
inline size_t bwd_resident_smem_bytes(int H, size_t elem) {
  const size_t nc = bwd_ncp(H), hp = bwd_hp(H), u = res_units(H);
  return elem * nc * hp +
         sizeof(float) * (RES_ROWS * nc + BWD_CSPLIT * RES_ROWS * hp +
                          2 * CLUSTER * RES_ROWS * u) +
         2 * sizeof(uint64_t);
}

// The body a backward launch takes, from (H, input type) alone: the
// resident body wherever hidden size H fits a cluster (H <= 312 in f32,
// 420 in bf16: fused_lstm.BWD_RESIDENT_MAX_HIDDEN) and every CTA of the
// cluster owns a unit, else the streaming body. A CTA without a unit
// receives no partials, so no wait holds it to the others' pace: it can
// send a step's partials two steps ahead, into a receive buffer its owner
// has not read, and count them on the wrong phase of the owner's
// mbarrier, which then never completes (H = 7 and 33 trapped so).
inline bool bwd_resident_fits(int H, size_t elem) {
  return bwd_resident_smem_bytes(H, elem) <= MAX_SMEM &&
         RES_ROWS * res_units(H) <= RES_THREADS &&
         RES_ROWS * H <= BWD_SENDS * RES_THREADS &&
         (CLUSTER - 1) * res_units(H) < H;
}

// The partials' exchange: st.async writes a value into another CTA's
// shared memory and counts its bytes on that CTA's mbarrier, whose phase
// completes once a step's bytes from all 8 CTAs are in; no cluster-wide
// barrier (whose arrive would also wait for the step's dz stores to reach
// memory) is needed.
__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}
__device__ __forceinline__ uint32_t mapa_u32(uint32_t a, int rank) {
  uint32_t r;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;"
               : "=r"(r) : "r"(a), "r"(rank));
  return r;
}
__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar,
                                               uint32_t bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(
          smem_u32(bar)),
      "r"(bytes)
      : "memory");
}
// Waits for the phase of `bar` with parity `parity` to complete. A wait of
// more than 2^34 cycles (~9 s) can only be a lost store: it traps, so the
// launch fails with an error instead of hanging the card.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t a = smem_u32(bar);
  const long long t0 = clock64();
  for (uint32_t done = 0; !done;) {
    asm volatile(
        "{\n .reg .pred p;\n"
        " mbarrier.try_wait.parity.acquire.cluster.shared::cta.b64 p, [%1], "
        "%2;\n selp.u32 %0, 1, 0, p;\n}"
        : "=r"(done)
        : "r"(a), "r"(parity)
        : "memory");
    if (!done && clock64() - t0 > (1ll << 34)) __trap();
  }
}
__device__ __forceinline__ void st_async(uint32_t addr, float v,
                                         uint32_t bar) {
  asm volatile(
      "st.async.shared::cluster.mbarrier::complete_tx::bytes.b32 [%0], %1, "
      "[%2];" ::"r"(addr),
      "r"(__float_as_uint(v)), "r"(bar)
      : "memory");
}

// Same arguments and outputs as lstm_bwd_steps. Grid: CLUSTER x
// ceil(B / RES_ROWS) CTAs in clusters of CLUSTER; RES_THREADS threads a
// CTA.
template <typename T>
__device__ __forceinline__ void lstm_bwd_steps_resident(
    float* smem, const T* __restrict__ eps, const T* __restrict__ gates,
    const T* __restrict__ cs, const T* __restrict__ c0,
    const T* __restrict__ rwT, const T* __restrict__ pw,
    const T* __restrict__ dhT, const T* __restrict__ dcT, T* __restrict__ dz,
    T* __restrict__ dh0, T* __restrict__ dc0, int Tn, int B, int H) {
  namespace cg = cooperative_groups;
  cg::cluster_group cluster = cg::this_cluster();
  const int tid = threadIdx.x;
  const int rank = (int)cluster.block_rank();
  const int U = res_units(H), NC = 4 * U, NCp = bwd_ncp(H), Hp = bwd_hp(H);
  const int u0 = rank * U;                                // this CTA's units
  const int b0 = (int)(blockIdx.x / CLUSTER) * RES_ROWS;  // cluster's rows
  const int H4 = 4 * H;
  T* sW = reinterpret_cast<T*>(smem);                         // [NCp][Hp]
  float* sDz = reinterpret_cast<float*>(sW + (size_t)NCp * Hp);
  float* sP = sDz + RES_ROWS * NCp;       // [BWD_CSPLIT][RES_ROWS][Hp]
  float* sR = sP + BWD_CSPLIT * RES_ROWS * Hp;  // [2][CLUSTER][RES_ROWS][U]
  // bars[p]: receive buffer p is full (its phase n completes with the
  // partials of step 2 n + p)
  uint64_t* bars =
      reinterpret_cast<uint64_t*>(sR + 2 * CLUSTER * RES_ROWS * U);

  // rw^T's rows, a warp to a row: row c = q U + j of this CTA is rw^T's
  // row q H + u0 + j
  for (int c = tid / 32; c < NCp; c += RES_THREADS / 32) {
    const int u = u0 + c % U;
    const bool on = c < NC && u < H;
    const T* w = rwT + (size_t)((c / U) * H + u) * H;
    for (int k = tid % 32; k < Hp; k += 32)
      store(&sW[(size_t)c * Hp + k], on && k < H ? to_f32(w[k]) : 0.f);
  }
  // dz's padding (columns and units past H, rows past B) stays 0
  for (int i = tid; i < RES_ROWS * NCp; i += RES_THREADS) sDz[i] = 0.f;
  // the thread of (row r, unit u) for dz and the carries; its inputs for
  // step t (gates, c_t, c_prev, eps) are loaded a step ahead
  const bool gate = tid < RES_ROWS * U;
  const int r = gate ? tid / U : 0, j = tid % U, u = u0 + j, b = b0 + r;
  const bool valid = gate && u < H && b < B;
  float dh = 0.f, dc = 0.f, pi = 0.f, pf = 0.f, po = 0.f;
  float g4[4] = {0.f, 0.f, 0.f, 0.f}, c_t = 0.f, c_prev = 0.f, e_t = 0.f;
  if (valid) {
    dh = to_f32(dhT[(size_t)b * H + u]);
    dc = to_f32(dcT[(size_t)b * H + u]);
    pi = to_f32(pw[u]);
    pf = to_f32(pw[H + u]);
    po = to_f32(pw[2 * H + u]);
    const size_t row = (size_t)(Tn - 1) * B + b;
#pragma unroll
    for (int q = 0; q < 4; ++q) g4[q] = to_f32(gates[row * H4 + q * H + u]);
    c_t = to_f32(cs[row * H + u]);
    c_prev = to_f32(Tn > 1 ? cs[(row - B) * H + u] : c0[(size_t)b * H + u]);
    e_t = to_f32(eps[row * H + u]);
  }
  const int slice = tid / BWD_PAIRS, pair = tid % BWD_PAIRS;
  const int ncs = NCp / BWD_CSPLIT, c_lo = slice * ncs;
  // the (row, k) partials this thread sends every step, (row, k) = (i / H,
  // i % H) for i = tid + e RES_THREADS: where each lies in sP, its slot
  // [rank][row][k - d U] in the first receive buffer of CTA d, the owner
  // of unit k, and that CTA's first mbarrier (-1: none, or a row past B)
  int src[BWD_SENDS];
  uint32_t dst[BWD_SENDS], dbar[BWD_SENDS];
#pragma unroll
  for (int e = 0; e < BWD_SENDS; ++e) {
    const int i = tid + e * RES_THREADS, row = i / H, k = i % H, d = k / U;
    const bool on = i < RES_ROWS * H && b0 + row < B;
    src[e] = on ? row * Hp + k : -1;
    dst[e] = on ? mapa_u32(smem_u32(sR + (rank * RES_ROWS + row) * U +
                                    (k - d * U)), d)
                : 0u;
    dbar[e] = on ? mapa_u32(smem_u32(bars), d) : 0u;
  }
  // the bytes a step's partials bring this CTA: 8 senders x its valid
  // rows x its units below H
  const uint32_t rx_bytes =
      (uint32_t)(CLUSTER * min(RES_ROWS, B - b0) *
                 max(0, min(U, H - u0)) * sizeof(float));
  if (tid == 0) {  // one arrival (this arming) and rx_bytes a phase
    asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;" ::"r"(
        smem_u32(&bars[0])));
    asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;" ::"r"(
        smem_u32(&bars[1])));
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
    mbar_expect_tx(&bars[0], rx_bytes);
    mbar_expect_tx(&bars[1], rx_bytes);
  }
  cluster.sync();  // every CTA's mbarriers are set before any remote write

  // Receive buffer p is written by steps p, p + 2, ...: a CTA sends step
  // s + 2's partials only once it has step s + 1's from every CTA, which
  // each sent after it had read step s's, so two buffers never overrun.
  PhaseClock clock;  // product, barriers, dz, exchange, wait for partials
  clock.start();
  for (int t = Tn - 1; t >= 0; --t) {
    const int par = (Tn - 1 - t) & 1;  // the receive buffer this step fills
    if (gate && t < Tn - 1) {  // step t+1's partials are in; rearm
      const int s1 = Tn - 2 - t;
      mbar_wait(&bars[par ^ 1], (s1 >> 1) & 1);
      if (tid == 0) mbar_expect_tx(&bars[par ^ 1], rx_bytes);
    }
    clock.mark(4);
    if (valid) {
      if (t < Tn - 1) {  // dh_t: step t+1's 8 partials, in rank order
        const float* p = sR + ((par ^ 1) * CLUSTER * RES_ROWS + r) * U + j;
        float s = p[0];
#pragma unroll
        for (int d = 1; d < CLUSTER; ++d) s += p[d * RES_ROWS * U];
        dh = round_to(s, T{});
      }
      float d[4];
      dc = round_to(bwd_cell(dh + e_t, dc, g4[0], g4[1], g4[2], g4[3], c_t,
                             c_prev, pi, pf, po, d),
                    T{});
      const size_t row = (size_t)t * B + b;
      T* dzt = dz + row * H4 + u;
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        sDz[r * NCp + q * U + j] = round_to(d[q], T{});
        store(&dzt[q * H], d[q]);
      }
      if (t > 0) {  // step t-1's inputs; its c_t is this step's c_prev
        const size_t row1 = row - B;
#pragma unroll
        for (int q = 0; q < 4; ++q)
          g4[q] = to_f32(gates[row1 * H4 + q * H + u]);
        c_t = c_prev;
        c_prev = to_f32(t > 1 ? cs[(row1 - B) * H + u]
                              : c0[(size_t)b * H + u]);
        e_t = to_f32(eps[row1 * H + u]);
      }
    }
    clock.mark(2);
    __syncthreads();  // dz is complete
    clock.mark(1);
    // the CTA's partial dh_prev over slice `slice` of its dz columns, one
    // fmaf chain per (row, k) in column order, for k = (2 kp, 2 kp + 1)
    for (int kp = pair; 2 * kp < Hp; kp += BWD_PAIRS) {
      const int k = 2 * kp;
      float acc[RES_ROWS][2];
#pragma unroll
      for (int i = 0; i < RES_ROWS; ++i) acc[i][0] = acc[i][1] = 0.f;
      // four groups of columns in flight: 5% faster than one or two at
      // the char-RNN's shape (tools/lstm_ab.py --kernel bwd)
#pragma unroll 4
      for (int c = c_lo; c < c_lo + ncs; c += 4) {
        float2 w[4];
#pragma unroll
        for (int e = 0; e < 4; ++e) w[e] = load2(sW + (size_t)(c + e) * Hp + k);
#pragma unroll
        for (int i = 0; i < RES_ROWS; ++i) {
          const float4 d4 = *reinterpret_cast<const float4*>(sDz + i * NCp + c);
          acc[i][0] = fmaf(d4.x, w[0].x, acc[i][0]);
          acc[i][1] = fmaf(d4.x, w[0].y, acc[i][1]);
          acc[i][0] = fmaf(d4.y, w[1].x, acc[i][0]);
          acc[i][1] = fmaf(d4.y, w[1].y, acc[i][1]);
          acc[i][0] = fmaf(d4.z, w[2].x, acc[i][0]);
          acc[i][1] = fmaf(d4.z, w[2].y, acc[i][1]);
          acc[i][0] = fmaf(d4.w, w[3].x, acc[i][0]);
          acc[i][1] = fmaf(d4.w, w[3].y, acc[i][1]);
        }
      }
#pragma unroll
      for (int i = 0; i < RES_ROWS; ++i)
        *reinterpret_cast<float2*>(sP + (slice * RES_ROWS + i) * Hp + k) =
            make_float2(acc[i][0], acc[i][1]);
    }
    clock.mark(0);
    __syncthreads();  // the partial sums are in, and dz is read
    clock.mark(1);
    // each (row, k): the slices in slice order, into its owner's slot in
    // receive buffer `par`
#pragma unroll
    for (int e = 0; e < BWD_SENDS; ++e) {
      if (src[e] < 0) continue;
      const float* p = sP + src[e];
      float s = p[0];
#pragma unroll
      for (int q = 1; q < BWD_CSPLIT; ++q) s += p[q * RES_ROWS * Hp];
      st_async(dst[e] + par * CLUSTER * RES_ROWS * U * 4, s,
               dbar[e] + par * 8);
    }
    clock.mark(3);
  }
  clock.flush(Tn);
  if (gate) mbar_wait(&bars[(Tn - 1) & 1], ((Tn - 1) >> 1) & 1);
  if (valid) {  // dh_0: the last step's partials
    const float* p = sR + (((Tn - 1) & 1) * CLUSTER * RES_ROWS + r) * U + j;
    float s = p[0];
#pragma unroll
    for (int d = 1; d < CLUSTER; ++d) s += p[d * RES_ROWS * U];
    store(&dh0[(size_t)b * H + u], s);
    store(&dc0[(size_t)b * H + u], dc);
  }
  cluster.sync();  // no CTA leaves while the cluster's stores are in flight
}

// kResident = false: the streaming body (lstm_bwd_steps); true: the
// resident body (lstm_bwd_steps_resident).
template <typename T, bool kResident>
__global__ void __launch_bounds__(kResident ? RES_THREADS : MAX_UNITS * KSPLIT)
lstm_bwd_kernel(const T* __restrict__ eps, const T* __restrict__ gates,
                const T* __restrict__ cs, const T* __restrict__ c0,
                const T* __restrict__ rwT, const T* __restrict__ pw,
                const T* __restrict__ dhT, const T* __restrict__ dcT,
                T* __restrict__ dz, T* __restrict__ dh0,
                T* __restrict__ dc0, int Tn, int B, int H) {
  extern __shared__ __align__(16) float smem[];
  if constexpr (kResident)
    lstm_bwd_steps_resident<T>(smem, eps, gates, cs, c0, rwT, pw, dhT, dcT,
                               dz, dh0, dc0, Tn, B, H);
  else
    lstm_bwd_steps<T>(smem, eps, gates, cs, c0, rwT, pw, dhT, dcT, dz, dh0,
                      dc0, Tn, B, H);
}

// The resident body wherever H fits it (bwd_resident_fits), else the
// streaming body.
template <typename T>
cudaError_t launch_bwd(const void* eps, const void* gates, const void* cs,
                       const void* c0, const void* rwT, const void* pw,
                       const void* dhT, const void* dcT, void* dz, void* dh0,
                       void* dc0, int Tn, int B, int H, cudaStream_t stream) {
  auto eps_ = static_cast<const T*>(eps),
       gates_ = static_cast<const T*>(gates),
       cs_ = static_cast<const T*>(cs), c0_ = static_cast<const T*>(c0),
       rwT_ = static_cast<const T*>(rwT), pw_ = static_cast<const T*>(pw),
       dhT_ = static_cast<const T*>(dhT), dcT_ = static_cast<const T*>(dcT);
  auto dz_ = static_cast<T*>(dz), dh0_ = static_cast<T*>(dh0),
       dc0_ = static_cast<T*>(dc0);
  if (bwd_resident_fits(H, sizeof(T)))
    return launch_resident(lstm_bwd_kernel<T, true>, B,
                           bwd_resident_smem_bytes(H, sizeof(T)), stream,
                           eps_, gates_, cs_, c0_, rwT_, pw_, dhT_, dcT_, dz_,
                           dh0_, dc0_, Tn, B, H);
  const size_t smem = bwd_smem_bytes(H);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        lstm_bwd_kernel<T, false>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return e;
  }
  lstm_bwd_kernel<T, false><<<B, dim3(units_per_block(H), KSPLIT), smem,
                              stream>>>(eps_, gates_, cs_, c0_, rwT_, pw_,
                                        dhT_, dcT_, dz_, dh0_, dc0_, Tn, B,
                                        H);
  return cudaGetLastError();
}

template <typename T>
cudaError_t describe_bwd(int B, int H, int* out) {
  return describe(lstm_bwd_kernel<T, true>, B,
                  bwd_resident_fits(H, sizeof(T))
                      ? bwd_resident_smem_bytes(H, sizeof(T))
                      : 0,
                  units_per_block(H) * KSPLIT, bwd_smem_bytes(H), out);
}

}  // namespace dl4j_lstm

// dtype: 0 = float32, 1 = bfloat16 (every tensor shares it). Returns the
// CUDA error of the launch (0 = launched).
extern "C" int dl4j_lstm_bwd(const void* eps, const void* gates,
                             const void* cs, const void* c0, const void* rwT,
                             const void* pw, const void* dhT, const void* dcT,
                             void* dz, void* dh0, void* dc0, int Tn, int B,
                             int H, int dtype, void* stream) {
  using namespace dl4j_lstm;
  if (Tn < 1 || B < 1 || H < 1 || (dtype != 0 && dtype != 1))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return (int)launch_bwd<float>(eps, gates, cs, c0, rwT, pw, dhT, dcT, dz,
                                  dh0, dc0, Tn, B, H, s);
  return (int)launch_bwd<__nv_bfloat16>(eps, gates, cs, c0, rwT, pw, dhT,
                                        dcT, dz, dh0, dc0, Tn, B, H, s);
}

// The launch dl4j_lstm_bwd makes for (B, H, dtype): out[6] as `describe`
// fills it.
extern "C" int dl4j_lstm_bwd_plan(int B, int H, int dtype, int* out) {
  using namespace dl4j_lstm;
  if (B < 1 || H < 1 || (dtype != 0 && dtype != 1))
    return (int)cudaErrorInvalidValue;
  if (dtype == 0) return (int)describe_bwd<float>(B, H, out);
  return (int)describe_bwd<__nv_bfloat16>(B, H, out);
}
