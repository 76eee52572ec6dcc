// Inference LSTM recurrence for Hopper (sm_90a), CUDA cores, f32 arithmetic.
//
// Replaces the TPU kernel deeplearning4j_tpu/ops/pallas_kernels.py
// `_lstm_fwd_infer_kernel` (launched by `_run_lstm_fwd_infer`). Contract
// kept from it, over time-major xz [T, B, 4H] (= x @ W + b, gate blocks
// i, f, g, o), rw [H, 4H], peepholes pw [3, H] (rows i, f, o) and the
// carries h0, c0 [B, H]:
//   z   = xz[t] + h @ rw
//   i   = sigmoid(z_i + c * pw[0]),  f = sigmoid(z_f + c * pw[1] + fb)
//   g   = tanh(z_g),                 c' = f * c + i * g
//   o   = sigmoid(z_o + c' * pw[2]), h' = o * tanh(c')
// hs[t] = h' is written every step and c_T once at the end. The carry
// (h, c) is rounded to the input type after every step (a no-op in f32),
// as the TPU kernel's VMEM carry in that type is; all arithmetic is f32.
// As in the TPU kernel and the plain version, h @ rw is summed first and
// xz[t] added to the sum: with a bf16 carry, adding xz at the start of the
// sum instead flips roundings that a unit whose forget gate is near 1
// keeps for the rest of the sequence (tests/test_torch_lstm.py emulates
// both orders).
// Not carried over: the TPU kernel walks a sequential grid of T steps with
// RW and (h, c) resident in VMEM, and its wrapper pads H to 128 and B to 8
// with zero gate blocks. Here one launch loops over all T steps inside the
// kernel, one block per batch row, and H is not padded. The size limit is
// the default 48 KB of shared memory a block gets: 4 * (3H + 3 * 4 * 256)
// bytes, so H <= 3072 (fused_lstm.MAX_HIDDEN); a wider H fails to launch.
//
// What bounds it on an H100: at the char-RNN slice's shape (B=32, T=64,
// H=256, f32) the h @ rw products are 2*32*256*1024*64 = 1.07 GFLOP, or
// 0.016 ms at the f32 CUDA-core peak of 67 TFLOP/s, against ~11.6 MB of
// xz/hs/rw/carry traffic, or 0.0035 ms at 3.35 TB/s: the bound is
// operations. But the 64 steps depend on each other, each with only
// 32 x 1024 outputs, and RW (1 MB in f32) does not fit one SM's 227 KB of
// shared memory, so a block that owns a whole row of h must stream all of
// RW from L2 every step. This first, simple design accepts that:
//   * a block owns one batch row and all H hidden units, so a step needs
//     no exchange between blocks;
//   * thread (x, y) of the block's (256, 4) threads owns hidden unit x
//     (and x + 256, ...) and sums slice y of the H terms of h @ rw: its
//     four gate columns x, H+x, 2H+x, 3H+x, so the gates combine in
//     registers; adjacent threads read adjacent columns (coalesced), and
//     the four slices keep four times as many L2 reads in flight as one
//     thread per unit would (a first version with 256 threads a block took
//     2.2 ms, held by L2 latency); slices 1..3 add their sums through
//     shared memory;
//   * h_{t-1} and h_t are two buffers in shared memory (each h value is
//     read by every thread, a broadcast), c stays in shared memory owned
//     by one thread, and two __syncthreads() a step order the partial sums
//     and the new h.
// Its ceiling is each SM's L2 read rate for the 1 MB of rw per step, well
// above the bound. The planned redesign (ROADMAP B, K1) keeps rw on chip
// across a thread-block cluster (each CTA owns a slice of the 4H columns,
// h exchanged through distributed shared memory with a cluster barrier per
// step) and runs h @ rw on tensor cores.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cmath>

namespace {

constexpr int MAX_UNITS = 256;  // hidden units a block works on at once
constexpr int KSPLIT = 4;       // slices of the reduction over k

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

// xz: [Tn, B, 4H]; rw: [H, 4H]; pw: [3, H]; h0, c0, cT: [B, H];
// hs: [Tn, B, H]; all contiguous, one type T. Grid: one block per batch
// row. Block: (units, KSPLIT) threads; thread (x, y) sums slice y of the
// reduction over k for hidden unit x (and x + blockDim.x, ... in later
// chunks).
template <typename T>
__global__ void __launch_bounds__(MAX_UNITS * KSPLIT)
lstm_fwd_infer_kernel(const T* __restrict__ xz, const T* __restrict__ rw,
                      const T* __restrict__ pw, const T* __restrict__ h0,
                      const T* __restrict__ c0, T* __restrict__ hs,
                      T* __restrict__ cT, int Tn, int B, int H,
                      float forget_bias) {
  extern __shared__ float smem[];
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
    const T* xzt = xz + ((size_t)t * B + b) * H4;
    for (int u0 = 0; u0 < H; u0 += nx) {
      const int u = u0 + tx;
      const bool active = u < H;
      const bool owner = ks == 0 && active;  // combines and writes unit u
      float xv[4], acc[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
      for (int q = 0; q < 4; ++q)  // loaded now, added after the sum
        xv[q] = owner ? to_f32(xzt[q * H + u]) : 0.f;
      if (active) {
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
        const float i = sigmoid_(acc[0] + c * pi);
        const float f = sigmoid_(acc[1] + c * pf + forget_bias);
        const float g = tanhf(acc[2]);
        const float c_new = f * c + i * g;
        const float o = sigmoid_(acc[3] + c_new * po);
        const float h_new = o * tanhf(c_new);
        sC[u] = round_to(c_new, T{});
        hn[u] = round_to(h_new, T{});
        store(&hs[((size_t)t * B + b) * H + u], h_new);
      }
      // the partial sums are read; after the last chunk, h_t is complete
      // and h_{t-1}'s readers are done
      __syncthreads();
    }
  }

  if (ks == 0)
    for (int u = tx; u < H; u += nx) store(&cT[(size_t)b * H + u], sC[u]);
}

template <typename T>
cudaError_t launch(const void* xz, const void* rw, const void* pw,
                   const void* h0, const void* c0, void* hs, void* cT, int Tn,
                   int B, int H, float forget_bias, cudaStream_t stream) {
  const int nx = min(MAX_UNITS, (H + 31) / 32 * 32);
  const size_t smem = sizeof(float) * (3 * (size_t)H + (KSPLIT - 1) * 4 * nx);
  lstm_fwd_infer_kernel<T><<<B, dim3(nx, KSPLIT), smem, stream>>>(
      static_cast<const T*>(xz), static_cast<const T*>(rw),
      static_cast<const T*>(pw), static_cast<const T*>(h0),
      static_cast<const T*>(c0), static_cast<T*>(hs), static_cast<T*>(cT), Tn,
      B, H, forget_bias);
  return cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (every tensor shares it). Returns the
// CUDA error of the launch (0 = launched).
extern "C" int dl4j_lstm_fwd_infer(const void* xz, const void* rw,
                                   const void* pw, const void* h0,
                                   const void* c0, void* hs, void* cT, int Tn,
                                   int B, int H, float forget_bias, int dtype,
                                   void* stream) {
  if (Tn < 1 || B < 1 || H < 1 || (dtype != 0 && dtype != 1))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return (int)launch<float>(xz, rw, pw, h0, c0, hs, cT, Tn, B, H,
                              forget_bias, s);
  return (int)launch<__nv_bfloat16>(xz, rw, pw, h0, c0, hs, cT, Tn, B, H,
                                    forget_bias, s);
}
