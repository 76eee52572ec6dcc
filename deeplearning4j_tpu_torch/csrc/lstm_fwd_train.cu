// Training LSTM forward for Hopper (sm_90a), CUDA cores, f32 arithmetic.
//
// Replaces the TPU kernel deeplearning4j_tpu/ops/pallas_kernels.py
// `_lstm_fwd_kernel` (launched by `_run_lstm_fwd`, the forward of
// `_fused_lstm_core`'s custom VJP). Contract: K1's (lstm_fwd_infer.cu) over
// the same inputs, types, peepholes, forget bias and carries, plus the
// residuals the backward K3 (lstm_bwd.cu) reads: every step writes hs[t],
// the four post-activation gates [i, f, g, o] into gates[t] [B, 4H] and the
// new cell into cs[t] [B, H], all in the input type. c_T is cs[T-1].
//
// Design: K1's, instantiated from the same source (lstm_common.cuh,
// lstm_fwd_steps<T, true>): one block per batch row, all T steps in one
// launch, rw streamed from L2 every step, each unit's sum over k split
// across four thread groups, h @ rw summed first and xz[t] added after;
// only its loop over k reads four rows of rw ahead of their products
// (lstm_fwd_steps says why). So hs and c_T equal K1's bit for bit on the
// same inputs, and the training forward computes exactly what serving
// does. The five extra stores a unit
// makes per step sit after the step's second __syncthreads(), so no thread
// waits on them at a barrier. Shared memory is K1's (3H + 3 * 4 * 256
// floats), so K2 takes every H that K1 takes (fused_lstm.MAX_HIDDEN).
//
// What bounds it on an H100: at the char-RNN's tBPTT window (T=50, B=32,
// H=256, f32) the h @ rw products are 2*32*256*1024*50 = 0.84 GFLOP,
// 0.0125 ms at the f32 CUDA-core peak of 67 TFLOP/s, against ~17.4 MB of
// xz / gates / hs / cs / rw traffic, 0.0052 ms at 3.35 TB/s: the bound is
// operations. As for K1, the 50 dependent steps and the per-step L2 read
// of rw (1 MB in f32, more than one SM's shared memory) hold it far above
// that bound. The redesign is K1's (ROADMAP B): rw resident across a
// thread-block cluster in distributed shared memory, each CTA owning a
// slice of the 4H columns, h exchanged through DSMEM with a cluster
// barrier per step, and the per-step product on tensor cores.

#include "lstm_common.cuh"

namespace dl4j_lstm {

template <typename T>
__global__ void __launch_bounds__(MAX_UNITS * KSPLIT)
lstm_fwd_train_kernel(const T* __restrict__ xz, const T* __restrict__ rw,
                      const T* __restrict__ pw, const T* __restrict__ h0,
                      const T* __restrict__ c0, T* __restrict__ hs,
                      T* __restrict__ gates, T* __restrict__ cs, int Tn,
                      int B, int H, float forget_bias) {
  extern __shared__ float smem[];
  lstm_fwd_steps<T, true>(smem, xz, rw, pw, h0, c0, hs, gates, cs, nullptr,
                          Tn, B, H, forget_bias);
}

template <typename T>
cudaError_t launch(const void* xz, const void* rw, const void* pw,
                   const void* h0, const void* c0, void* hs, void* gates,
                   void* cs, int Tn, int B, int H, float forget_bias,
                   cudaStream_t stream) {
  lstm_fwd_train_kernel<T><<<B, dim3(units_per_block(H), KSPLIT),
                             fwd_smem_bytes(H), stream>>>(
      static_cast<const T*>(xz), static_cast<const T*>(rw),
      static_cast<const T*>(pw), static_cast<const T*>(h0),
      static_cast<const T*>(c0), static_cast<T*>(hs), static_cast<T*>(gates),
      static_cast<T*>(cs), Tn, B, H, forget_bias);
  return cudaGetLastError();
}

}  // namespace dl4j_lstm

// dtype: 0 = float32, 1 = bfloat16 (every tensor shares it). Returns the
// CUDA error of the launch (0 = launched).
extern "C" int dl4j_lstm_fwd_train(const void* xz, const void* rw,
                                   const void* pw, const void* h0,
                                   const void* c0, void* hs, void* gates,
                                   void* cs, int Tn, int B, int H,
                                   float forget_bias, int dtype,
                                   void* stream) {
  using namespace dl4j_lstm;
  if (Tn < 1 || B < 1 || H < 1 || (dtype != 0 && dtype != 1))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return (int)launch<float>(xz, rw, pw, h0, c0, hs, gates, cs, Tn, B, H,
                              forget_bias, s);
  return (int)launch<__nv_bfloat16>(xz, rw, pw, h0, c0, hs, gates, cs, Tn, B,
                                    H, forget_bias, s);
}
