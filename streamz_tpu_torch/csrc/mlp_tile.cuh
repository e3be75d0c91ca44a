// Block-level pieces of the 60 -> 512 -> 256 -> capacity MLP's forward and
// backward: K7 (forward_probs.cu) uses the products, K5 (corpus_grads.cu)
// the row softmax (softmax_delta_row).
//
// The product works on a tile of T rows that lives in shared memory (A)
// against one weight matrix that stays in device memory (W), which Hopper's
// 50 MB L2 holds: w2 alone is 512 KB, far over the 227 KB of shared memory
// one block can have.  All arithmetic is FP32 on the CUDA cores with f32
// sums; every sum runs in a fixed order, so a launch gives the same bits
// every time.  Widths (F, H1, H2, capacity) are multiples of 4, rows of
// shared buffers are 16-byte aligned, and float4 loads are used along the
// rows.  The callers synchronise the block between pieces.

#pragma once

#include <cuda_runtime.h>

namespace streamz {

constexpr float kMaskLogit = -1e30f;  // streamz_tpu/nn/model.py:MASK_LOGIT

enum Act { kNone = 0, kRelu = 1, kTanh = 2 };

// out[r, n] = act(sum_k A[r, k] W[k, n] + bias[n]) for r < T, n < N.
// A: [T, K] with row stride lda; W: [K, N] row-major in device memory.
// One thread per column n; its T sums stay in registers.
template <int T, int ACT>
__device__ __forceinline__ void rows_times_w(const float* A, int lda, int K,
                                             const float* W, const float* bias,
                                             int N, float* out, int ldo) {
  for (int n = threadIdx.x; n < N; n += blockDim.x) {
    float acc[T];
#pragma unroll
    for (int r = 0; r < T; ++r) acc[r] = 0.f;
    for (int k = 0; k < K; k += 4) {
      const float w0 = W[static_cast<size_t>(k) * N + n];
      const float w1 = W[static_cast<size_t>(k + 1) * N + n];
      const float w2 = W[static_cast<size_t>(k + 2) * N + n];
      const float w3 = W[static_cast<size_t>(k + 3) * N + n];
#pragma unroll
      for (int r = 0; r < T; ++r) {
        const float4 a = *reinterpret_cast<const float4*>(A + r * lda + k);
        acc[r] = fmaf(a.x, w0, acc[r]);
        acc[r] = fmaf(a.y, w1, acc[r]);
        acc[r] = fmaf(a.z, w2, acc[r]);
        acc[r] = fmaf(a.w, w3, acc[r]);
      }
    }
    const float b = bias[n];
#pragma unroll
    for (int r = 0; r < T; ++r) {
      float v = acc[r] + b;
      if (ACT == kRelu) v = fmaxf(v, 0.f);
      if (ACT == kTanh) v = tanhf(v);
      out[r * ldo + n] = v;
    }
  }
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

struct RowStats {
  float lse;   // logsumexp of the masked logits
  float tdot;  // <target, masked logits>
};

// One warp turns one row of logits L [cap] into the loss delta, in place:
// columns c >= ns are masked to kMaskLogit, p = softmax, and
// L[c] = (p_c - t_c) * w * (c < ns).  The live-column factor is the exact
// backward of the mask: with ns == 0 the softmax is uniform and only this
// factor keeps the update at zero (streamz_tpu/nn/pallas_train.py:105-112).
template <typename Target>
__device__ __forceinline__ RowStats softmax_delta_row(float* L, int cap, int ns,
                                                      float w, Target target) {
  const int lane = threadIdx.x & 31;
  float m = __int_as_float(0xff800000);  // -inf
  for (int c = lane; c < cap; c += 32) m = fmaxf(m, c < ns ? L[c] : kMaskLogit);
  m = warp_max(m);
  float se = 0.f;
  for (int c = lane; c < cap; c += 32) se += expf((c < ns ? L[c] : kMaskLogit) - m);
  se = warp_sum(se);
  float tdot = 0.f;
  for (int c = lane; c < cap; c += 32) {
    const bool live = c < ns;
    const float l = live ? L[c] : kMaskLogit;
    const float p = expf(l - m) / se;
    const float t = target(c);
    tdot = fmaf(t, l, tdot);
    L[c] = live ? (p - t) * w : 0.f;
  }
  RowStats s;
  s.lse = m + logf(se);
  s.tdot = warp_sum(tdot);
  return s;
}

}  // namespace streamz
