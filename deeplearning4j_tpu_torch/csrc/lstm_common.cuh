// Shared by the LSTM kernels (lstm_fwd_infer.cu K1, lstm_fwd_train.cu K2,
// lstm_bwd.cu K3): the type helpers and the body of the forward
// recurrence, which K1's and K2's kernels inline from the same source so
// that K2's hs and c_T equal K1's bit for bit (each kernel keeps its own
// name, so a profiler trace tells them apart). See lstm_fwd_infer.cu for
// the contract, the design and what bounds it.

#pragma once

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

}  // namespace dl4j_lstm
