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
// Design: K1's, instantiated from the same source (lstm_common.cuh: the
// resident body lstm_fwd_steps_resident<T, true> wherever H fits it, H <=
// 312 in f32 and 424 in bf16, else the streaming body lstm_fwd_steps<T,
// true>), picked the same way in the C entry. So hs and c_T equal K1's bit
// for bit on the same inputs, and the training forward computes exactly
// what serving does. The residual stores (the four gates and the cell, in
// the input type) are the step's only extra work: in the resident body
// the thread of each (row, unit) makes them after it has sent h_t to the
// cluster, before the step's barrier.
//
// What bounds it on an H100: at the char-RNN's tBPTT window (T=50, B=32,
// H=256, f32) the h @ rw products are 2*32*256*1024*50 = 0.84 GFLOP,
// 0.0051 ms at the 3xTF32 tensor-core peak (0.0125 ms at the f32
// CUDA-core peak of 67 TFLOP/s, the units it uses), against ~17.4 MB of
// xz / gates / hs / cs / rw traffic, 0.0052 ms at 3.35 TB/s: the two
// bounds are about equal, bytes just ahead. As for K1,
// the 50 dependent steps hold it above that bound: each step's product,
// gates, DSMEM exchange and cluster barrier (K1's note has the cycles).
// Measured on an NVIDIA H100 80GB HBM3 at 700 W: PERF.md's kernel table
// (chip_smoke.py, tools/lstm_ab.py).

#include "lstm_common.cuh"

namespace dl4j_lstm {

// kResident = false: the streaming body; true: the resident body
// (lstm_common.cuh, shared with K1).
template <typename T, bool kResident>
__global__ void __launch_bounds__(kResident ? RES_THREADS : MAX_UNITS * KSPLIT)
lstm_fwd_train_kernel(const T* __restrict__ xz, const T* __restrict__ rw,
                      const T* __restrict__ pw, const T* __restrict__ h0,
                      const T* __restrict__ c0, T* __restrict__ hs,
                      T* __restrict__ gates, T* __restrict__ cs, int Tn,
                      int B, int H, float forget_bias) {
  extern __shared__ __align__(16) float smem[];
  if constexpr (kResident)
    lstm_fwd_steps_resident<T, true>(smem, xz, rw, pw, h0, c0, hs, gates, cs,
                                     nullptr, Tn, B, H, forget_bias);
  else
    lstm_fwd_steps<T, true>(smem, xz, rw, pw, h0, c0, hs, gates, cs,
                            nullptr, Tn, B, H, forget_bias);
}

// The resident body wherever H fits it (resident_fits), else the streaming
// body: K1's choice.
template <typename T>
cudaError_t launch(const void* xz, const void* rw, const void* pw,
                   const void* h0, const void* c0, void* hs, void* gates,
                   void* cs, int Tn, int B, int H, float forget_bias,
                   cudaStream_t stream) {
  auto xz_ = static_cast<const T*>(xz), rw_ = static_cast<const T*>(rw),
       pw_ = static_cast<const T*>(pw), h0_ = static_cast<const T*>(h0),
       c0_ = static_cast<const T*>(c0);
  auto hs_ = static_cast<T*>(hs), gates_ = static_cast<T*>(gates),
       cs_ = static_cast<T*>(cs);
  if (resident_fits(H, sizeof(T)))
    return launch_resident(lstm_fwd_train_kernel<T, true>, B,
                           resident_smem_bytes(H, sizeof(T)), stream, xz_,
                           rw_, pw_, h0_, c0_, hs_, gates_, cs_, Tn, B, H,
                           forget_bias);
  return launch_streaming(lstm_fwd_train_kernel<T, false>, B, H, stream, xz_,
                          rw_, pw_, h0_, c0_, hs_, gates_, cs_, Tn, B, H,
                          forget_bias);
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

// The launch dl4j_lstm_fwd_train makes for (B, H, dtype): out[6] as
// `describe` fills it.
extern "C" int dl4j_lstm_fwd_train_plan(int B, int H, int dtype, int* out) {
  using namespace dl4j_lstm;
  if (B < 1 || H < 1 || (dtype != 0 && dtype != 1))
    return (int)cudaErrorInvalidValue;
  if (dtype == 0)
    return (int)describe_fwd(lstm_fwd_train_kernel<float, true>, B, H, 4,
                             out);
  return (int)describe_fwd(lstm_fwd_train_kernel<__nv_bfloat16, true>, B, H,
                           2, out);
}
