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

#include "lstm_common.cuh"

namespace dl4j_lstm {

// The recurrence's body (lstm_fwd_steps) lives in lstm_common.cuh, shared
// with the training forward K2.
template <typename T>
__global__ void __launch_bounds__(MAX_UNITS * KSPLIT)
lstm_fwd_infer_kernel(const T* __restrict__ xz, const T* __restrict__ rw,
                      const T* __restrict__ pw, const T* __restrict__ h0,
                      const T* __restrict__ c0, T* __restrict__ hs,
                      T* __restrict__ cT, int Tn, int B, int H,
                      float forget_bias) {
  extern __shared__ float smem[];
  lstm_fwd_steps<T, false>(smem, xz, rw, pw, h0, c0, hs, nullptr, nullptr,
                           cT, Tn, B, H, forget_bias);
}

template <typename T>
cudaError_t launch(const void* xz, const void* rw, const void* pw,
                   const void* h0, const void* c0, void* hs, void* cT, int Tn,
                   int B, int H, float forget_bias, cudaStream_t stream) {
  lstm_fwd_infer_kernel<T><<<B, dim3(units_per_block(H), KSPLIT),
                             fwd_smem_bytes(H), stream>>>(
      static_cast<const T*>(xz), static_cast<const T*>(rw),
      static_cast<const T*>(pw), static_cast<const T*>(h0),
      static_cast<const T*>(c0), static_cast<T*>(hs), static_cast<T*>(cT), Tn,
      B, H, forget_bias);
  return cudaGetLastError();
}

}  // namespace dl4j_lstm

// dtype: 0 = float32, 1 = bfloat16 (every tensor shares it). Returns the
// CUDA error of the launch (0 = launched).
extern "C" int dl4j_lstm_fwd_infer(const void* xz, const void* rw,
                                   const void* pw, const void* h0,
                                   const void* c0, void* hs, void* cT, int Tn,
                                   int B, int H, float forget_bias, int dtype,
                                   void* stream) {
  using namespace dl4j_lstm;
  if (Tn < 1 || B < 1 || H < 1 || (dtype != 0 && dtype != 1))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return (int)launch<float>(xz, rw, pw, h0, c0, hs, cT, Tn, B, H,
                              forget_bias, s);
  return (int)launch<__nv_bfloat16>(xz, rw, pw, h0, c0, hs, cT, Tn, B, H,
                                    forget_bias, s);
}
