// The row softmax of the 60 -> 512 -> 256 -> capacity MLP's backward, for
// K5 (corpus_grads.cu): softmax_delta_row turns one row of logits into the
// loss delta in place, one warp a row, with warp_max / warp_sum.  Every sum
// runs in a fixed order, so a launch gives the same bits every time.

#pragma once

#include <cuda_runtime.h>

namespace streamz {

constexpr float kMaskLogit = -1e30f;  // streamz_tpu/nn/model.py:MASK_LOGIT

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
