// K5 on Hopper: the fused corpus training gradient, hand-written for sm_90a.
//
// Replaces the TPU kernel streamz_tpu/nn/pallas_train.py:_train_kernel
// (reached through corpus_grads_pallas and corpus_step_pallas).  For a
// labelled batch x [B, F] f32, labels [B] i32, weights [B] f32, a live class
// count ns read from device memory and the MLP's parameters it computes
//
//   h1 = relu(x w1 + b1), h2 = tanh(h1 w2 + b2), logits = h2 w3 + b3,
//   columns >= ns masked to -1e30, target = onehot(label) * (label < ns),
//   delta = (softmax - target) * w * (col < ns),
//   dh2 = delta w3^T (1 - h2^2), dh1 = dh2 w2^T (h1 > 0),
//
// and writes the six gradient SUMS over the batch (dw1 = x^T dh1, db1 =
// sum dh1, ..., dw3 = h2^T delta, db3 = sum delta) plus loss_sum =
// sum w (lse - <target, logits>) and count = sum w, in one flat buffer
// [dw1 | db1 | dw2 | db2 | dw3 | db3 | loss, count, 0, 0].
//
// What bounds it on this card: about 1.1 MFLOP per row (forward, the data
// backward and the weight backward) against 248 bytes of input per row, so
// operations, not bytes, bound it (FP32 ridge about 20 FLOP per byte).
// What differs from the TPU design, and what this one does about it:
//   * The TPU grid runs in order and carries the gradient sums across grid
//     steps.  Here blocks run in parallel: each block walks row tiles
//     blockIdx.x, blockIdx.x + gridDim.x, ... and keeps its own partial sums
//     in its own slot of a workspace [slots, size]; a second kernel adds the
//     slots in a fixed order.  No float atomics, so two runs give the same
//     bits.
//   * A row tile of T rows runs forward and backward in shared memory (x,
//     h1/dh1, h2/dh2 and the [T, capacity] logits/delta, the backward written
//     over the forward in place); the weights are read from device memory,
//     which L2 holds (w2 alone is 512 KB).  T shrinks as the capacity grows
//     (32, 16, 8 rows, as _tile_for halves the TPU tile); past what 8 rows of
//     logits leave room for, the logits go to a device scratch buffer, so
//     every capacity runs.
//   * FP32 FMA on the CUDA cores, TF32 off; register-tiled products (see
//     mlp_tile.cuh).  wgmma is later work.
//
// Plain C interface, loaded with ctypes from streamz_tpu_torch/nn/
// train_kernels.py, which builds this file with nvcc at first use.

#include <cuda_runtime.h>

#include "mlp_tile.cuh"

namespace {

using namespace streamz;

constexpr int kThreads = 512;
constexpr int kMaxSmem = 232448;  // 227 KB, the most a Hopper block may have
constexpr int kTiles[] = {32, 16, 8};  // rows per tile, shrinking as capacity grows

struct Dims {
  int F, H1, H2, cap;
  __host__ __device__ long long slot() const {
    return 1LL * F * H1 + H1 + 1LL * H1 * H2 + H2 + 1LL * H2 * cap + cap + 4;
  }
};

long long smem_bytes(const Dims& d, int T, bool global_logits) {
  return 4LL * (1LL * T * (d.F + d.H1 + d.H2) + 2LL * T +
                (global_logits ? 0LL : 1LL * T * d.cap));
}

template <int T, int STORE>
__device__ __forceinline__ void tile_grads(const float* sx, float* sh1, float* sh2,
                                           float* sl, const float* w2, const float* w3,
                                           const Dims& d, float* slot) {
  float* dw1 = slot;
  float* db1 = dw1 + static_cast<size_t>(d.F) * d.H1;
  float* dw2 = db1 + d.H1;
  float* db2 = dw2 + static_cast<size_t>(d.H1) * d.H2;
  float* dw3 = db2 + d.H2;
  float* db3 = dw3 + static_cast<size_t>(d.H2) * d.cap;
  outer_rows<T, STORE>(sh2, d.H2, d.H2, sl, d.cap, d.cap, dw3);
  col_sums<T, STORE>(sl, d.cap, d.cap, db3);
  __syncthreads();
  rows_times_wt<T, kTanhDeriv>(sl, d.cap, d.cap, w3, d.H2, sh2, d.H2, sh2, d.H2);
  __syncthreads();
  outer_rows<T, STORE>(sh1, d.H1, d.H1, sh2, d.H2, d.H2, dw2);
  col_sums<T, STORE>(sh2, d.H2, d.H2, db2);
  __syncthreads();
  rows_times_wt<T, kReluDeriv>(sh2, d.H2, d.H2, w2, d.H1, sh1, d.H1, sh1, d.H1);
  __syncthreads();
  outer_rows<T, STORE>(sx, d.F, d.F, sh1, d.H1, d.H1, dw1);
  col_sums<T, STORE>(sh1, d.H1, d.H1, db1);
}

template <int T>
__global__ void __launch_bounds__(kThreads)
corpus_grads_kernel(const float* x, const int* labels, const float* wts, int B,
                    const int* ns_ptr, const float* w1, const float* b1,
                    const float* w2, const float* b2, const float* w3,
                    const float* b3, Dims d, float* part, float* logits_scratch) {
  extern __shared__ float4 smem4[];
  float* sx = reinterpret_cast<float*>(smem4);  // [T, F]
  float* sh1 = sx + T * d.F;                   // [T, H1]: h1, then dh1
  float* sh2 = sh1 + T * d.H1;                 // [T, H2]: h2, then dh2
  float* srow = sh2 + T * d.H2;                // [2, T]: w * loss, w
  float* sl = logits_scratch != nullptr        // [T, cap]: logits, then delta
                  ? logits_scratch + static_cast<size_t>(blockIdx.x) * T * d.cap
                  : srow + 2 * T;
  const int ns = *ns_ptr;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int nwarps = blockDim.x >> 5;
  float* slot = part + static_cast<size_t>(blockIdx.x) * d.slot();
  float* stats = slot + (d.slot() - 4);
  const int tiles = (B + T - 1) / T;

  for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
    const bool first = tile == static_cast<int>(blockIdx.x);
    const long long row0 = 1LL * tile * T;
    for (int i = threadIdx.x; i < T * d.F; i += blockDim.x) {
      const long long row = row0 + i / d.F;
      sx[i] = row < B ? x[row * d.F + i % d.F] : 0.f;
    }
    __syncthreads();
    rows_times_w<T, kRelu>(sx, d.F, d.F, w1, b1, d.H1, sh1, d.H1);
    __syncthreads();
    rows_times_w<T, kTanh>(sh1, d.H1, d.H1, w2, b2, d.H2, sh2, d.H2);
    __syncthreads();
    rows_times_w<T, kNone>(sh2, d.H2, d.H2, w3, b3, d.cap, sl, d.cap);
    __syncthreads();
    for (int r = warp; r < T; r += nwarps) {
      const long long row = row0 + r;
      const int label = row < B ? labels[row] : -1;
      const float w = row < B ? wts[row] : 0.f;
      const bool hot = label < ns;  // out-of-range labels train a zero target
      const RowStats s = softmax_delta_row(
          sl + r * d.cap, d.cap, ns, w,
          [=](int c) { return hot && c == label ? 1.f : 0.f; });
      if (lane == 0) {
        srow[r] = (s.lse - s.tdot) * w;
        srow[T + r] = w;
      }
    }
    __syncthreads();
    if (threadIdx.x == 0) {
      float loss = 0.f, count = 0.f;
      for (int r = 0; r < T; ++r) {
        loss += srow[r];
        count += srow[T + r];
      }
      if (first) {
        stats[0] = loss; stats[1] = count; stats[2] = 0.f; stats[3] = 0.f;
      } else {
        stats[0] += loss; stats[1] += count;
      }
    }
    if (first) {
      tile_grads<T, kWrite>(sx, sh1, sh2, sl, w2, w3, d, slot);
    } else {
      tile_grads<T, kAdd>(sx, sh1, sh2, sl, w2, w3, d, slot);
    }
    __syncthreads();
  }
}

// out[i] = sum over slots s, in order, of part[s, i].
__global__ void sum_slots_kernel(const float* part, int slots, long long size,
                                 float* out) {
  for (long long i = 1LL * blockIdx.x * blockDim.x + threadIdx.x; i < size;
       i += 1LL * gridDim.x * blockDim.x) {
    float acc = 0.f;
    for (int s = 0; s < slots; ++s) acc += part[static_cast<size_t>(s) * size + i];
    out[i] = acc;
  }
}

template <int T>
cudaError_t launch(const float* x, const int* labels, const float* wts, int B,
                   const int* ns, const float* w1, const float* b1, const float* w2,
                   const float* b2, const float* w3, const float* b3, const Dims& d,
                   int slots, float* part, float* logits_scratch, cudaStream_t stream) {
  const int smem = static_cast<int>(smem_bytes(d, T, logits_scratch != nullptr));
  cudaError_t err = cudaFuncSetAttribute(
      corpus_grads_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  corpus_grads_kernel<T><<<slots, kThreads, smem, stream>>>(
      x, labels, wts, B, ns, w1, b1, w2, b2, w3, b3, d, part, logits_scratch);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Floats of one gradient slot: the six gradients and 4 stats lanes.
long long streamz_corpus_grads_slot_size(int F, int H1, int H2, int cap) {
  return Dims{F, H1, H2, cap}.slot();
}

// The row tile for these widths: the largest of 32, 16 and 8 rows whose
// activations and logits fit in a block's shared memory; when not even 8
// rows' logits fit, 8 rows with the logits in device scratch
// (*global_logits = 1).
int streamz_corpus_grads_tile(int F, int H1, int H2, int cap, int* global_logits) {
  const Dims d{F, H1, H2, cap};
  *global_logits = 0;
  for (int tile : kTiles)
    if (smem_bytes(d, tile, false) <= kMaxSmem) return tile;
  *global_logits = 1;
  return 8;
}

// Launch K5 on `stream`: `slots` blocks walk the ceil(B / tile) row tiles,
// then the slots are summed into out [slot_size].  part: [slots, slot_size]
// workspace; logits_scratch: null, or [slots, tile, cap] when the logits do
// not fit in shared memory.  Returns the CUDA error of the launches (0 on
// success); it does not synchronise.
int streamz_corpus_grads(const float* x, const int* labels, const float* wts, int B,
                         const int* ns, const float* w1, const float* b1,
                         const float* w2, const float* b2, const float* w3,
                         const float* b3, int F, int H1, int H2, int cap, int tile,
                         int slots, float* part, float* logits_scratch, float* out,
                         void* stream) {
  const Dims d{F, H1, H2, cap};
  const int tiles = B > 0 ? (B + tile - 1) / tile : 0;
  if (B <= 0 || slots < 1 || slots > tiles || F % 4 || H1 % 4 || H2 % 4 ||
      cap % 4 || F <= 0 || H1 <= 0 || H2 <= 0 || cap <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  if (smem_bytes(d, tile, logits_scratch != nullptr) > kMaxSmem)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  switch (tile) {
    case 32: err = launch<32>(x, labels, wts, B, ns, w1, b1, w2, b2, w3, b3, d, slots, part, logits_scratch, s); break;
    case 16: err = launch<16>(x, labels, wts, B, ns, w1, b1, w2, b2, w3, b3, d, slots, part, logits_scratch, s); break;
    case 8: err = launch<8>(x, labels, wts, B, ns, w1, b1, w2, b2, w3, b3, d, slots, part, logits_scratch, s); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long size = d.slot();
  const long long blocks = (size + 255) / 256;
  sum_slots_kernel<<<static_cast<unsigned>(blocks < 4096 ? blocks : 4096), 256, 0, s>>>(
      part, slots, size, out);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
