// Block-level pieces of the 60 -> 512 -> 256 -> capacity MLP's forward and
// backward, shared by K5 (corpus_grads.cu) and K7 (forward_probs.cu).
//
// Every piece works on a tile of T rows that lives in shared memory (A, D,
// H below) against one weight matrix that stays in device memory (W, G),
// which Hopper's 50 MB L2 holds: w2 alone is 512 KB, far over the 227 KB of
// shared memory one block can have.  All arithmetic is FP32 FMA on the CUDA
// cores with f32 sums; every sum runs in a fixed order, so a launch gives
// the same bits every time.  Widths (F, H1, H2, capacity) are multiples of
// 4, rows of shared buffers are 16-byte aligned, and float4 loads are used
// along every contiguous axis.  The callers synchronise the block between
// pieces.

#pragma once

#include <cuda_runtime.h>

namespace streamz {

constexpr float kMaskLogit = -1e30f;  // streamz_tpu/nn/model.py:MASK_LOGIT

enum Act { kNone = 0, kRelu = 1, kTanh = 2 };
enum Deriv { kTanhDeriv = 1, kReluDeriv = 2 };
enum Store { kWrite = 0, kAdd = 1 };

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

// out[r, k] = (sum_n D[r, n] W[k, n]) * deriv(H[r, k]) for r < T, k < K:
// the backward of a layer, W: [K, N] row-major in device memory.  deriv is
// 1 - h^2 (tanh) or h > 0 (ReLU).  out may alias H: each (r, k) is read and
// written by the same thread.
template <int T, int DERIV>
__device__ __forceinline__ void rows_times_wt(const float* D, int ldd, int N,
                                              const float* W, int K,
                                              const float* H, int ldh,
                                              float* out, int ldo) {
  for (int k = threadIdx.x; k < K; k += blockDim.x) {
    float acc[T];
#pragma unroll
    for (int r = 0; r < T; ++r) acc[r] = 0.f;
    const float* wrow = W + static_cast<size_t>(k) * N;
    for (int n = 0; n < N; n += 4) {
      const float4 w = *reinterpret_cast<const float4*>(wrow + n);
#pragma unroll
      for (int r = 0; r < T; ++r) {
        const float4 d = *reinterpret_cast<const float4*>(D + r * ldd + n);
        acc[r] = fmaf(d.x, w.x, acc[r]);
        acc[r] = fmaf(d.y, w.y, acc[r]);
        acc[r] = fmaf(d.z, w.z, acc[r]);
        acc[r] = fmaf(d.w, w.w, acc[r]);
      }
    }
#pragma unroll
    for (int r = 0; r < T; ++r) {
      const float h = H[r * ldh + k];
      const float g = DERIV == kTanhDeriv ? 1.f - h * h : (h > 0.f ? 1.f : 0.f);
      out[r * ldo + k] = acc[r] * g;
    }
  }
}

// The weight gradient of a layer, sum_r A[r, k] D[r, n] over the T rows,
// stored into G [K, N] (device memory) by STORE: written (kWrite) or added
// (kAdd).  Each thread owns 4 x 4 outputs at a time: 16 FMAs per two 16-byte
// shared loads.
template <int T, int STORE>
__device__ __forceinline__ void outer_rows(const float* A, int lda, int K,
                                           const float* D, int ldd, int N,
                                           float* G) {
  const int nq = N / 4;
  const int items = (K / 4) * nq;
  for (int it = threadIdx.x; it < items; it += blockDim.x) {
    const int k0 = (it / nq) * 4;
    const int n0 = (it % nq) * 4;
    float acc[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
#pragma unroll 4
    for (int r = 0; r < T; ++r) {
      const float4 a4 = *reinterpret_cast<const float4*>(A + r * lda + k0);
      const float4 d4 = *reinterpret_cast<const float4*>(D + r * ldd + n0);
      const float a[4] = {a4.x, a4.y, a4.z, a4.w};
      const float d[4] = {d4.x, d4.y, d4.z, d4.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(a[i], d[j], acc[i][j]);
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      float4* g = reinterpret_cast<float4*>(G + static_cast<size_t>(k0 + i) * N + n0);
      float4 v;
      if (STORE == kWrite) {
        v = make_float4(acc[i][0], acc[i][1], acc[i][2], acc[i][3]);
      } else {
        v = *g;
        v.x += acc[i][0]; v.y += acc[i][1]; v.z += acc[i][2]; v.w += acc[i][3];
      }
      *g = v;
    }
  }
}

// The bias gradient, sum_r D[r, n], stored into G [N] as outer_rows does.
template <int T, int STORE>
__device__ __forceinline__ void col_sums(const float* D, int ldd, int N, float* G) {
  for (int n = threadIdx.x; n < N; n += blockDim.x) {
    float acc = 0.f;
#pragma unroll 4
    for (int r = 0; r < T; ++r) acc += D[r * ldd + n];
    if (STORE == kWrite) G[n] = acc;
    else G[n] += acc;
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
  float lse;     // logsumexp of the masked logits
  float tdot;    // <target, masked logits>
  float report;  // sum_c target_c * log(max(p_c, 1e-12))
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
  float tdot = 0.f, report = 0.f;
  for (int c = lane; c < cap; c += 32) {
    const bool live = c < ns;
    const float l = live ? L[c] : kMaskLogit;
    const float p = expf(l - m) / se;
    const float t = target(c);
    tdot = fmaf(t, l, tdot);
    report = fmaf(t, logf(fmaxf(p, 1e-12f)), report);
    L[c] = live ? (p - t) * w : 0.f;
  }
  RowStats s;
  s.lse = m + logf(se);
  s.tdot = warp_sum(tdot);
  s.report = warp_sum(report);
  return s;
}

}  // namespace streamz
