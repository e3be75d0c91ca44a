// K7 on Hopper: the fused classifier forward, hand-written for sm_90a.
//
// Replaces the TPU kernel streamz_tpu/nn/pallas_forward.py:_fwd_kernel
// (reached through forward_probs_pallas).  For window features x [R, F] f32
// and the MLP's parameters it computes
//
//   h1 = relu(x w1 + b1), h2 = tanh(h1 w2 + b2), logits = h2 w3 + b3,
//   columns >= ns masked to -1e30, probs = softmax(logits),
//
// and writes probs [R, capacity] with the inactive columns exactly 0.0, also
// when ns == 0, where the all-masked softmax would be a uniform row (the TPU
// kernel writes zeros there too).
//
// What bounds it on this card: 2 (F H1 + H1 H2 + H2 cap) = 0.39 MFLOP per row
// at 60 -> 512 -> 256 -> 128 against 240 bytes in and 512 bytes out, about
// 500 FLOP per byte: operations bound it (FP32 ridge about 20 FLOP per byte).
// The design: each block takes one 32-row tile; x, h1 and h2 stay in shared
// memory (106 KB, two blocks per SM) and only x is read and the probabilities
// written; the weights are read through L2 (w2 alone is 512 KB); the three
// products are mlp_tile.cuh's rows_times_w (FP32 FMA on the CUDA cores, one
// thread per output column, the tile's 32 sums in registers), the masked
// softmax one warp per row with warp_max/warp_sum.  The logits are written
// into the output rows and turned into probabilities in place, so every
// capacity runs without more shared memory.  Tensor cores are later work.
//
// Plain C interface, loaded with ctypes from streamz_tpu_torch/nn/
// forward_kernel.py, which builds this file with nvcc at first use.

#include <climits>
#include <cuda_runtime.h>

#include "mlp_tile.cuh"

namespace {

using namespace streamz;

constexpr int kThreads = 256;
constexpr int kTile = 32;         // rows per block
constexpr int kMaxSmem = 232448;  // 227 KB, the most a Hopper block may have

long long smem_bytes(int F, int H1, int H2) {
  return 4LL * kTile * (F + H1 + H2);
}

__global__ void __launch_bounds__(kThreads)
forward_probs_kernel(const float* __restrict__ x, long long R, int F, int ns,
                     const float* __restrict__ w1, const float* __restrict__ b1,
                     const float* __restrict__ w2, const float* __restrict__ b2,
                     const float* __restrict__ w3, const float* __restrict__ b3,
                     int H1, int H2, int cap, float* __restrict__ out) {
  extern __shared__ float4 smem4[];
  float* sx = reinterpret_cast<float*>(smem4);  // [T, F]
  float* sh1 = sx + kTile * F;                  // [T, H1]
  float* sh2 = sh1 + kTile * H1;                // [T, H2]
  const long long row0 = static_cast<long long>(blockIdx.x) * kTile;
  float* logits = out + row0 * cap;             // [T, cap] rows of the padded output
  for (int i = threadIdx.x; i < kTile * F; i += blockDim.x) {
    const long long row = row0 + i / F;
    sx[i] = row < R ? x[row * F + i % F] : 0.f;
  }
  __syncthreads();
  rows_times_w<kTile, kRelu>(sx, F, F, w1, b1, H1, sh1, H1);
  __syncthreads();
  rows_times_w<kTile, kTanh>(sh1, H1, H1, w2, b2, H2, sh2, H2);
  __syncthreads();
  rows_times_w<kTile, kNone>(sh2, H2, H2, w3, b3, cap, logits, cap);
  __syncthreads();  // the block's global writes are visible to the block

  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  for (int r = warp; r < kTile; r += kThreads / 32) {
    float* L = logits + static_cast<size_t>(r) * cap;
    float m = __int_as_float(0xff800000);  // -inf
    for (int c = lane; c < cap; c += 32) m = fmaxf(m, c < ns ? L[c] : kMaskLogit);
    m = warp_max(m);
    float se = 0.f;
    for (int c = lane; c < cap; c += 32) se += expf((c < ns ? L[c] : kMaskLogit) - m);
    se = warp_sum(se);
    for (int c = lane; c < cap; c += 32) L[c] = c < ns ? expf(L[c] - m) / se : 0.f;
  }
}

}  // namespace

extern "C" {

// Launch K7 on `stream`.  x: [R, F] f32 contiguous; w1 [F, H1], b1 [H1],
// w2 [H1, H2], b2 [H2], w3 [H2, cap], b3 [cap] f32; out: [ceil(R / 32) * 32,
// cap] f32 (whole tiles; the rows past R are scratch).  F, H1, H2 and cap
// are multiples of 4.  Returns the CUDA error of the launch (0 on success);
// it does not synchronise.
int streamz_forward_probs(const float* x, long long R, int F, int ns,
                          const float* w1, const float* b1, const float* w2,
                          const float* b2, const float* w3, const float* b3,
                          int H1, int H2, int cap, float* out, void* stream) {
  if (R <= 0 || F <= 0 || H1 <= 0 || H2 <= 0 || cap <= 0 || F % 4 || H1 % 4 ||
      H2 % 4 || cap % 4)
    return static_cast<int>(cudaErrorInvalidValue);
  const long long tiles = (R + kTile - 1) / kTile;
  const long long smem = smem_bytes(F, H1, H2);
  if (tiles > INT_MAX || smem > kMaxSmem) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaFuncSetAttribute(
      forward_probs_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  forward_probs_kernel<<<static_cast<unsigned>(tiles), kThreads,
                         static_cast<size_t>(smem), static_cast<cudaStream_t>(stream)>>>(
      x, R, F, ns, w1, b1, w2, b2, w3, b3, H1, H2, cap, out);
  return static_cast<int>(cudaGetLastError());
}

// Rows per tile: the wrapper pads the output to whole tiles.
int streamz_forward_probs_tile() { return kTile; }

}  // extern "C"
