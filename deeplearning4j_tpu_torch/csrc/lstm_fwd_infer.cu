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
// kernel, and H is not padded (the resident body pads its own slice of
// RW with zero rows).
//
// What bounds it on an H100: at the char-RNN slice's shape (B=32, T=64,
// H=256, f32) the h @ rw products are 2*32*256*1024*64 = 1.07 GFLOP, or
// 0.0065 ms at the 3xTF32 tensor-core peak, the card's fastest f32
// products (0.016 ms at the f32 CUDA-core peak of 67 TFLOP/s, the units
// this kernel uses), against ~11.6 MB of xz/hs/rw/carry traffic, or
// 0.0035 ms at 3.35 TB/s: the bound is operations. But the 64 steps
// depend on each other, each with only 32 x 1024 outputs, and RW (1 MB in
// f32) is more than one SM's 227 KB of shared memory.
//
// Two bodies (lstm_common.cuh), picked in the C entry from (H, dtype)
// alone (resident_fits):
//   * the resident body, wherever RW's slices fit a cluster (H <= 312 in
//     f32, 424 in bf16: fused_lstm.RESIDENT_MAX_HIDDEN). The Hopper
//     counterpart of the TPU kernel's VMEM residency: a cluster of 8 CTAs
//     (launched with cudaLaunchKernelEx and a cluster dimension), CTA r
//     owning hidden units [r H/8, (r+1) H/8) and their four gate columns,
//     keeps its slice of RW ([H, H/2], 128 KiB at H = 256 in f32) in
//     shared memory for all T steps. One cluster takes 4 batch rows, so
//     B = 32 runs 8 clusters on 64 SMs, each reading RW once a launch (a
//     larger batch runs more clusters, in waves past the ones the card
//     holds at once; 8 rows a cluster was 1.5x slower at B = 32,
//     tools/lstm_ab.py --rows). A step: each of 512 threads sums two
//     columns of h @ rw_slice over one of 8 slices of k for every row,
//     an fmaf chain in k order; the slices meet in shared memory; one
//     thread per (row, unit) adds them in slice order, then
//     xz[t] (loaded while the previous step finished), applies the gates,
//     keeps c in a register and writes h_t into every CTA's next h buffer
//     through distributed shared memory; one cluster barrier ends the
//     step. The products stay on CUDA cores: 3xTF32 mma.sync on a step's
//     [4 x 256] x [256 x 128] (M padded to 16) takes ~1,536 tensor-core
//     cycles a CTA against ~1,024 cycles of FMAs, and keeps the plain
//     fmaf chains' numerics;
//   * the streaming body, past that up to H = 3072 (fused_lstm.MAX_HIDDEN,
//     the default 48 KB of shared memory a block gets: 4 * (3H + 3 * 4 *
//     256) bytes): a block owns one batch row and all H hidden units, and
//     streams all of RW from L2 every step; thread (x, y) of its (256, 4)
//     threads owns unit x (and x + 256, ...) and sums slice y of the H
//     terms of its four gate columns, slices 1..3 through shared memory;
//     h_{t-1} and h_t are two shared buffers, and two __syncthreads() a
//     step order the partial sums and the new h.
// Both sum each column over k in slices, then add xz[t].
// Measured on an NVIDIA H100 80GB HBM3 at 700 W (chip_smoke.py,
// tools/lstm_ab.py; PERF.md): see PERF.md's kernel table. A per-phase
// clock count of one step at 4 rows (tools/lstm_ab.py --phases): the
// product ~2,800 cycles (bound by shared-memory reads of rw and h, 2.7x
// its FMAs' time), the gates ~770, the DSMEM exchange ~300, the cluster
// barrier ~900.

#include "lstm_common.cuh"

namespace dl4j_lstm {

// kResident = false: the streaming body (lstm_fwd_steps); true: the
// resident body (lstm_fwd_steps_resident). Both live in lstm_common.cuh,
// shared with the training forward K2.
template <typename T, bool kResident>
__global__ void __launch_bounds__(kResident ? RES_THREADS : MAX_UNITS * KSPLIT)
lstm_fwd_infer_kernel(const T* __restrict__ xz, const T* __restrict__ rw,
                      const T* __restrict__ pw, const T* __restrict__ h0,
                      const T* __restrict__ c0, T* __restrict__ hs,
                      T* __restrict__ cT, int Tn, int B, int H,
                      float forget_bias) {
  extern __shared__ __align__(16) float smem[];
  if constexpr (kResident)
    lstm_fwd_steps_resident<T, false>(smem, xz, rw, pw, h0, c0, hs, nullptr,
                                      nullptr, cT, Tn, B, H, forget_bias);
  else
    lstm_fwd_steps<T, false>(smem, xz, rw, pw, h0, c0, hs, nullptr, nullptr,
                             cT, Tn, B, H, forget_bias);
}

// The resident body wherever H fits it (resident_fits), else the streaming
// body.
template <typename T>
cudaError_t launch(const void* xz, const void* rw, const void* pw,
                   const void* h0, const void* c0, void* hs, void* cT, int Tn,
                   int B, int H, float forget_bias, cudaStream_t stream) {
  auto xz_ = static_cast<const T*>(xz), rw_ = static_cast<const T*>(rw),
       pw_ = static_cast<const T*>(pw), h0_ = static_cast<const T*>(h0),
       c0_ = static_cast<const T*>(c0);
  auto hs_ = static_cast<T*>(hs), cT_ = static_cast<T*>(cT);
  if (resident_fits(H, sizeof(T)))
    return launch_resident(lstm_fwd_infer_kernel<T, true>, B,
                           resident_smem_bytes(H, sizeof(T)), stream, xz_,
                           rw_, pw_, h0_, c0_, hs_, cT_, Tn, B, H,
                           forget_bias);
  return launch_streaming(lstm_fwd_infer_kernel<T, false>, B, H, stream, xz_,
                          rw_, pw_, h0_, c0_, hs_, cT_, Tn, B, H,
                          forget_bias);
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

// The launch dl4j_lstm_fwd_infer makes for (B, H, dtype): out[6] as
// `describe` fills it.
extern "C" int dl4j_lstm_fwd_infer_plan(int B, int H, int dtype, int* out) {
  using namespace dl4j_lstm;
  if (B < 1 || H < 1 || (dtype != 0 && dtype != 1))
    return (int)cudaErrorInvalidValue;
  if (dtype == 0)
    return (int)describe_fwd(lstm_fwd_infer_kernel<float, true>, B, H, 4,
                             out);
  return (int)describe_fwd(lstm_fwd_infer_kernel<__nv_bfloat16, true>, B, H,
                           2, out);
}
