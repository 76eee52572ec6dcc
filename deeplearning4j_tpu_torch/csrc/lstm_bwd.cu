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
// H=256, f32) dz @ rw^T is 2*32*1024*256*50 = 0.84 GFLOP, 0.0125 ms at the
// f32 CUDA-core peak of 67 TFLOP/s, against ~17.5 MB of eps / gates / cs /
// rwT / dz traffic, 0.0052 ms at 3.35 TB/s: the bound is operations. As in
// the forward (K1, K2), the T dependent steps and the per-step L2 read of
// rwT (1 MB in f32) hold it far above the bound. This first design mirrors
// K1:
//   * one block per batch row, looping t from T-1 down to 0 in one launch;
//   * thread (x, 0) owns hidden unit x (and x + blockDim.x, ...): it reads
//     that unit's four gates and computes its four dz entries and its
//     dc carry (K1's column ownership: k, H+k, 2H+k, 3H+k), and puts dz in
//     shared memory, a broadcast to the whole block;
//   * thread (x, y) then sums slice y of dh_prev[x] = sum_j dz[j] rwT[j, x]
//     over the 4H columns (slice y is gate block y), reading eight rows
//     of rwT ahead of their products (on an NVIDIA H100 80GB HBM3 at
//     700 W a window took 0.67 ms one row at a time, 0.57 ms so,
//     chip_smoke.py; the same sums); adjacent threads read adjacent
//     addresses of rwT, which is why the wrapper passes rw transposed;
//     slices 1..3 add their sums through shared memory and the owner
//     rounds dh_prev into the carry;
//   * two __syncthreads() a step while H <= 256 (one more per extra chunk
//     of 256 units); no atomics, so two launches on the same inputs are
//     bitwise equal.
// Shared memory holds the dh and dc carries, dz and the partial sums:
// 4 * (6H + 3 * 256) bytes, 75 KB at H = 3072 (fused_lstm.MAX_HIDDEN), so
// above 48 KB the launch raises the block's dynamic shared-memory limit; a
// refused launch comes back as an error. The redesign is K1's (ROADMAP B):
// rwT resident across a thread-block cluster in distributed shared memory,
// dz exchanged through DSMEM with a cluster barrier per step, and the
// per-step product on tensor cores.

#include "lstm_common.cuh"

namespace dl4j_lstm {

// eps, cs: [Tn, B, H]; gates, dz: [Tn, B, 4H]; rwT: [4H, H]; pw: [3, H];
// c0, dhT, dcT, dh0, dc0: [B, H]; all contiguous, one type T. Grid: one
// block per batch row. Block: (units, KSPLIT) threads.
template <typename T>
__global__ void __launch_bounds__(MAX_UNITS * KSPLIT)
lstm_bwd_kernel(const T* __restrict__ eps, const T* __restrict__ gates,
                const T* __restrict__ cs, const T* __restrict__ c0,
                const T* __restrict__ rwT, const T* __restrict__ pw,
                const T* __restrict__ dhT, const T* __restrict__ dcT,
                T* __restrict__ dz, T* __restrict__ dh0,
                T* __restrict__ dc0, int Tn, int B, int H) {
  extern __shared__ float smem[];
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
        const float i = to_f32(g4[u]), f = to_f32(g4[H + u]);
        const float g = to_f32(g4[2 * H + u]), o = to_f32(g4[3 * H + u]);
        const float c_t = to_f32(cs[row * H + u]);
        const float c_prev = to_f32(cp[u]);
        const float pi = to_f32(pw[u]), pf = to_f32(pw[H + u]);
        const float po = to_f32(pw[2 * H + u]);
        const float dh = sDh[u] + to_f32(eps[row * H + u]);
        const float tc = tanhf(c_t);
        const float dzo = dh * tc * o * (1.f - o);
        const float dc = sDc[u] + dh * o * (1.f - tc * tc) + dzo * po;
        const float dzi = dc * g * i * (1.f - i);
        const float dzf = dc * c_prev * f * (1.f - f);
        const float dzg = dc * i * (1.f - g * g);
        sDc[u] = round_to(dc * f + dzi * pi + dzf * pf, T{});
        sDz[u] = round_to(dzi, T{});
        sDz[H + u] = round_to(dzf, T{});
        sDz[2 * H + u] = round_to(dzg, T{});
        sDz[3 * H + u] = round_to(dzo, T{});
        T* dzt = dz + row * H4;
        store(&dzt[u], dzi);
        store(&dzt[H + u], dzf);
        store(&dzt[2 * H + u], dzg);
        store(&dzt[3 * H + u], dzo);
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

template <typename T>
cudaError_t launch_bwd(const void* eps, const void* gates, const void* cs,
                       const void* c0, const void* rwT, const void* pw,
                       const void* dhT, const void* dcT, void* dz, void* dh0,
                       void* dc0, int Tn, int B, int H, cudaStream_t stream) {
  const int nx = units_per_block(H);
  const size_t smem = sizeof(float) * (6 * (size_t)H + (KSPLIT - 1) * nx);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        lstm_bwd_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return e;
  }
  lstm_bwd_kernel<T><<<B, dim3(nx, KSPLIT), smem, stream>>>(
      static_cast<const T*>(eps), static_cast<const T*>(gates),
      static_cast<const T*>(cs), static_cast<const T*>(c0),
      static_cast<const T*>(rwT), static_cast<const T*>(pw),
      static_cast<const T*>(dhT), static_cast<const T*>(dcT),
      static_cast<T*>(dz), static_cast<T*>(dh0), static_cast<T*>(dc0), Tn, B,
      H);
  return cudaGetLastError();
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
