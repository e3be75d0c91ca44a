// K6 on Hopper: the whole per-file chunk-SGD loop of the discovery loop in
// one launch, hand-written for sm_90a.
//
// Replaces the TPU kernel streamz_tpu/nn/pallas_train.py:_file_train_kernel
// (reached through train_windows_pallas).  Over S chunks of B windows
// (chunks [S, B, F] f32, masks [S, B] f32 0/1), with a target vector tgt
// [cap] and the live class count ns read from device memory, it runs, for
// each chunk in order,
//
//   forward, masked softmax, report = -sum tgt * log(max(p, 1e-12)),
//   delta = (p - tgt) * mask * (col < ns), backward,
//   count = sum mask; p -= lr / count * grad (no update when count == 0),
//   stats += (sum report * mask, count),
//
// updating the six parameter tensors IN PLACE, and writes stats [2].  A
// chunk with no surviving window leaves the parameters and stats as they are
// (the TPU kernel's zero scale), so it is skipped outright.
//
// What bounds it on this card: a chunk is about 9 MFLOP at capacity 128,
// but the chunks are strictly sequential and every phase of a step needs
// the previous phase across all of w1/w2/w3 (0.78 MB of f32 at capacity
// 128, more than one SM's shared memory).  So its time is latency: per step,
// the phases' dependent passes over the weights in L2.  The design: one
// persistent block of 512 threads walks all S steps; the weights stay in
// device memory (L2-resident) and are read and updated in place there; the
// step's activations (x, h1, h2, dh2, dh1 and the [B, cap] logits/delta)
// live in shared memory, the logits in a device scratch buffer when they do
// not fit.  One launch per file, never one per step.  Spreading the weights
// over a thread-block cluster's distributed shared memory is later work.
//
// Plain C interface, loaded with ctypes from streamz_tpu_torch/nn/
// train_kernels.py, which builds this file with nvcc at first use.

#include <cuda_runtime.h>

#include "mlp_tile.cuh"

namespace {

using namespace streamz;

constexpr int kThreads = 512;
constexpr int kMaxSmem = 232448;  // 227 KB, the most a Hopper block may have

long long smem_bytes(int F, int H1, int H2, int cap, int T, bool global_logits) {
  return 4LL * (1LL * T * (F + 2 * H1 + 2 * H2) + 2LL * T +
                (global_logits ? 0LL : 1LL * T * cap));
}

template <int T>
__global__ void __launch_bounds__(kThreads)
file_train_kernel(const float* chunks, const float* masks, int S, int B, int F,
                  const float* tgt, const int* ns_ptr, float lr, float* w1, float* b1,
                  float* w2, float* b2, float* w3, float* b3, int H1, int H2, int cap,
                  float* logits_scratch, float* stats) {
  extern __shared__ float4 smem4[];
  float* sx = reinterpret_cast<float*>(smem4);  // [T, F]
  float* sh1 = sx + T * F;                     // [T, H1]
  float* sh2 = sh1 + T * H1;                   // [T, H2]
  float* sdh2 = sh2 + T * H2;                  // [T, H2]
  float* sdh1 = sdh2 + T * H2;                 // [T, H1]
  float* srow = sdh1 + T * H1;                 // [2, T]: mask * report, mask
  float* sl = logits_scratch != nullptr ? logits_scratch : srow + 2 * T;  // [T, cap]
  const int ns = *ns_ptr;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int nwarps = blockDim.x >> 5;
  float loss_sum = 0.f, loss_cnt = 0.f;  // thread 0's

  for (int s = 0; s < S; ++s) {
    const float* xs = chunks + static_cast<size_t>(s) * B * F;
    for (int i = threadIdx.x; i < T * F; i += blockDim.x)
      sx[i] = i < B * F ? xs[i] : 0.f;
    for (int r = threadIdx.x; r < T; r += blockDim.x)
      srow[T + r] = r < B ? masks[static_cast<size_t>(s) * B + r] : 0.f;
    __syncthreads();
    float count = 0.f;
    for (int r = 0; r < T; ++r) count += srow[T + r];
    if (count == 0.f) {  // the same on every thread: skip the whole step
      __syncthreads();
      continue;
    }
    const float scale = lr / fmaxf(count, 1.f);

    rows_times_w<T, kRelu>(sx, F, F, w1, b1, H1, sh1, H1);
    __syncthreads();
    rows_times_w<T, kTanh>(sh1, H1, H1, w2, b2, H2, sh2, H2);
    __syncthreads();
    rows_times_w<T, kNone>(sh2, H2, H2, w3, b3, cap, sl, cap);
    __syncthreads();
    for (int r = warp; r < T; r += nwarps) {
      const float w = srow[T + r];
      const RowStats st =
          softmax_delta_row(sl + r * cap, cap, ns, w, [=](int c) { return tgt[c]; });
      if (lane == 0) srow[r] = -st.report * w;
    }
    __syncthreads();
    // The gradients of every layer use the weights from before this step's
    // update: dh2 reads w3 before it moves, dh1 reads w2 before it moves.
    rows_times_wt<T, kTanhDeriv>(sl, cap, cap, w3, H2, sh2, H2, sdh2, H2);
    __syncthreads();
    rows_times_wt<T, kReluDeriv>(sdh2, H2, H2, w2, H1, sh1, H1, sdh1, H1);
    outer_rows<T, kSgd>(sh2, H2, H2, sl, cap, cap, w3, scale);
    col_sums<T, kSgd>(sl, cap, cap, b3, scale);
    __syncthreads();
    outer_rows<T, kSgd>(sh1, H1, H1, sdh2, H2, H2, w2, scale);
    col_sums<T, kSgd>(sdh2, H2, H2, b2, scale);
    outer_rows<T, kSgd>(sx, F, F, sdh1, H1, H1, w1, scale);
    col_sums<T, kSgd>(sdh1, H1, H1, b1, scale);
    if (threadIdx.x == 0) {
      float loss = 0.f;
      for (int r = 0; r < T; ++r) loss += srow[r];
      loss_sum += loss;
      loss_cnt += count;
    }
    __syncthreads();
  }
  if (threadIdx.x == 0) {
    stats[0] = loss_sum;
    stats[1] = loss_cnt;
  }
}

template <int T>
cudaError_t launch(const float* chunks, const float* masks, int S, int B, int F,
                   const float* tgt, const int* ns, float lr, float* w1, float* b1,
                   float* w2, float* b2, float* w3, float* b3, int H1, int H2, int cap,
                   float* logits_scratch, float* stats, cudaStream_t stream) {
  const int smem = static_cast<int>(
      smem_bytes(F, H1, H2, cap, T, logits_scratch != nullptr));
  cudaError_t err = cudaFuncSetAttribute(
      file_train_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  file_train_kernel<T><<<1, kThreads, smem, stream>>>(
      chunks, masks, S, B, F, tgt, ns, lr, w1, b1, w2, b2, w3, b3, H1, H2, cap,
      logits_scratch, stats);
  return cudaGetLastError();
}

int rows_for(int B) { return B <= 8 ? 8 : B <= 16 ? 16 : B <= 32 ? 32 : 0; }

}  // namespace

extern "C" {

// Rows one step computes for chunks of B windows (0: B is too large).
int streamz_file_train_rows(int B) { return rows_for(B); }

// Whether the [rows, cap] logits must go to device scratch because they do
// not fit in shared memory beside the step's activations.
int streamz_file_train_global_logits(int F, int H1, int H2, int cap, int B) {
  return smem_bytes(F, H1, H2, cap, rows_for(B), false) > kMaxSmem ? 1 : 0;
}

// Launch K6 on `stream`.  The parameters are updated in place; stats gets
// (loss sum, count).  logits_scratch: null, or [rows, cap] when the logits
// do not fit in shared memory.  The wrapper handles S == 0 without
// launching.  Returns the CUDA error of the launch (0 on success); it does
// not synchronise.
int streamz_file_train(const float* chunks, const float* masks, int S, int B, int F,
                       const float* tgt, const int* ns, float lr, float* w1,
                       float* b1, float* w2, float* b2, float* w3, float* b3, int H1,
                       int H2, int cap, float* logits_scratch, float* stats,
                       void* stream) {
  const int T = rows_for(B);
  if (S <= 0 || B <= 0 || T == 0 || F <= 0 || H1 <= 0 || H2 <= 0 || cap <= 0 ||
      F % 4 || H1 % 4 || H2 % 4 || cap % 4)
    return static_cast<int>(cudaErrorInvalidValue);
  if (smem_bytes(F, H1, H2, cap, T, logits_scratch != nullptr) > kMaxSmem)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  switch (T) {
    case 8: err = launch<8>(chunks, masks, S, B, F, tgt, ns, lr, w1, b1, w2, b2, w3, b3, H1, H2, cap, logits_scratch, stats, s); break;
    case 16: err = launch<16>(chunks, masks, S, B, F, tgt, ns, lr, w1, b1, w2, b2, w3, b3, H1, H2, cap, logits_scratch, stats, s); break;
    default: err = launch<32>(chunks, masks, S, B, F, tgt, ns, lr, w1, b1, w2, b2, w3, b3, H1, H2, cap, logits_scratch, stats, s); break;
  }
  return static_cast<int>(err);
}

}  // extern "C"
