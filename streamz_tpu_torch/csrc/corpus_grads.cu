// K5 on Hopper: the fused corpus training step, hand-written for sm_90a.
//
// Replaces the TPU kernel streamz_tpu/nn/pallas_train.py:_train_kernel
// (reached through corpus_grads_pallas and corpus_step_pallas).  For R rows,
// each with features x [F], a label and a weight w, a live class count ns
// read from device memory and the MLP's parameters it computes
//
//   h1 = relu(x w1 + b1), h2 = tanh(h1 w2 + b2), logits = h2 w3 + b3,
//   columns >= ns masked to -1e30, target = onehot(label) * (label < ns),
//   delta = (softmax - target) * w * (col < ns),
//   dh2 = delta w3^T (1 - h2^2), dh1 = dh2 w2^T (h1 > 0),
//
// the six gradient SUMS over the rows (dw1 = x^T dh1, db1 = sum dh1, ...,
// dw3 = h2^T delta, db3 = sum delta), loss_sum = sum w (lse - <target,
// logits>) and count = sum w.  Rows come from one of two sources:
//
//   a batch:  x [R, F], labels [R], weights [R];
//   a pool:   row i is pool_x[order[i]] (times keep[i], a 0/1 byte per
//             feature, under dropout), labelled pool_y[order[i]], with weight
//             1, or under dropout any(row != 0) (src/lib.rs:119-129,
//             :607-609).  Only the step's real rows are passed: the epoch's
//             padding rows carry no weight and are not computed.
//
// and the result takes one of two forms:
//
//   sums:  [dw1 | db1 | dw2 | db2 | dw3 | db3] and (loss_sum, count, 0, 0);
//   step:  p -= lr / max(count, 1) * grad for every parameter IN PLACE (no
//          update when count == 0) and loss_sum / max(count, 1) to a slot.
//
// What bounds it on this card: about 1.1 MFLOP per row (forward, the data
// backward and the weight backward) against 248 bytes of input per row, so
// operations bound it.  The products after the first layer run on the
// tensor cores in 3xTF32 (mma.sync m16n8k8: a = a_big + a_small in TF32,
// a b = a_small b_big + a_big b_small + a_big b_big with f32 accumulation),
// about f32 accuracy.  The first layer (K = F = 60, 5% of the work) runs in
// FP32 FMA, since the ReLU's kink turns a pre-activation's last bits into a
// whole unit's gradient.
//
// The design, as eight launches on one stream per step, each spread over
// the whole card:
//   phase A, by rows and output columns (64 x 64 tiles): the gather of x
//            (with a ones column at F), labels and weights into a device
//            workspace, which L2 holds (about 28 MB at 4096 rows: x, h1,
//            h2, delta, dh2, dh1; h1 and h2 also carry a ones column, at H1
//            and H2), fused with h1; h2 and the logits (bias and activation
//            in the epilogue); the masked softmax, delta and each row's loss
//            (one warp per row); dh2 and dh1 (the derivative in the
//            epilogue);
//   phase B, by outputs: [dw1; db1] = [x | 1]^T dh1, [dw2; db2] = [h1 | 1]^T
//            dh2 and [dw3; db3] = [h2 | 1]^T delta, the ones column giving
//            the bias sums in the same reduction; each 64 x 64 output tile
//            reduces a fixed share of the rows (the row range is cut into
//            `parts` when the tiles alone would leave SMs idle), while one
//            more block sums the rows' losses and weights in a fixed order;
//            the last launch adds the parts in order and writes the sums or
//            applies the step.
// Every sum runs in a fixed order and nothing uses atomics, so two launches
// on the same inputs give the same bits.
//
// Plain C interface, loaded with ctypes from streamz_tpu_torch/nn/
// train_kernels.py, which builds this file with nvcc at first use.

#include <cstdint>
#include <cuda_runtime.h>

#include "mlp_tile.cuh"

namespace {

using streamz::RowStats;
using streamz::softmax_delta_row;

constexpr int BM = 64, BN = 64, BK = 32;  // the product tile and its depth step
constexpr int kGemmThreads = 128;         // 4 warps, 2 x 2, each 32 x 32
constexpr int kALd = BK + 4;              // row strides of the staged planes, k
constexpr int kBLd = BN + 8;              // along rows (36) or across them (72)
constexpr int kGemmBlocksPerSm = 4;       // 128 registers a thread
constexpr int kMaxParts = 16;
constexpr int kRowWarps = 8;              // rows per block of the row kernels
constexpr int kMaxF = 64;                 // feature width, as the TPU kernel's padding

inline long long cdiv(long long a, long long b) { return (a + b - 1) / b; }
inline int round4i(int n) { return (n + 3) / 4 * 4; }

// The workspace carve (offsets in floats, each 128-byte aligned).
struct Work {
  int ldx, ldh1, ldh2;
  long long x, h1, h2, lg, dh2, dh1, lab, wt, rl, stats, part, floats;
};

inline long long take(long long& o, long long n) {
  const long long at = o;
  o += (n + 31) / 32 * 32;
  return at;
}

inline Work make_work(int R, int F, int H1, int H2, int cap, int parts) {
  Work w;
  w.ldx = round4i(F + 1);
  w.ldh1 = round4i(H1 + 1);
  w.ldh2 = round4i(H2 + 1);
  long long o = 0;
  w.x = take(o, 1LL * R * w.ldx);
  w.h1 = take(o, 1LL * R * w.ldh1);
  w.h2 = take(o, 1LL * R * w.ldh2);
  w.lg = take(o, 1LL * R * cap);  // logits, then delta
  w.dh2 = take(o, 1LL * R * H2);
  w.dh1 = take(o, 1LL * R * H1);
  w.lab = take(o, R);  // int32
  w.wt = take(o, R);
  w.rl = take(o, R);   // w * loss per row
  w.stats = take(o, 4);
  const long long G = 1LL * (F + 1) * H1 + 1LL * (H1 + 1) * H2 + 1LL * (H2 + 1) * cap;
  w.part = take(o, parts * G);
  w.floats = o;
  return w;
}

// ---------------------------------------------------------------------------
// The 3xTF32 product tile.
// ---------------------------------------------------------------------------

// x rounded to TF32 (to nearest, ties away), its 13 low bits cleared so
// that the value is exact as an f32 too.
__device__ __forceinline__ uint32_t tf32(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(r) : "f"(x));
  return r & 0xffffe000u;
}

__device__ __forceinline__ void split(float x, uint32_t& big, uint32_t& small) {
  const uint32_t b = tf32(x);
  big = b;
  small = tf32(x - __uint_as_float(b));
}

__device__ __forceinline__ void mma(float (&d)[4], const uint32_t (&a)[4],
                                    const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// Four consecutive elements of a row-major matrix P [rows, ld] along its
// rows' contiguous axis: P[r, c .. c + 3], those past (rows, cols) read as 0.
// ld and c are multiples of 4, so a whole in-bounds vector is one 16-byte
// load.
__device__ __forceinline__ float4 load4(const float* __restrict__ P, long long ld, int r,
                                        int c, int rows, int cols) {
  if (r >= rows) return make_float4(0.f, 0.f, 0.f, 0.f);
  const float* p = P + r * ld + c;
  if (c + 3 < cols) return *reinterpret_cast<const float4*>(p);
  return make_float4(c < cols ? p[0] : 0.f, c + 1 < cols ? p[1] : 0.f,
                     c + 2 < cols ? p[2] : 0.f, c + 3 < cols ? p[3] : 0.f);
}

// acc += op(A)[m0:+64, k_lo:k_hi] op(B)[k_lo:k_hi, n0:+64] for this warp's
// 32 x 32 share, where op(A)(m, k) = A[m * lda + k] (A_K) or A[k * lda + m],
// op(B)(k, n) = B[k * ldb + n] (B_N) or B[n * ldb + k].  Elements past M, N
// or k_hi read as 0.  Each thread stages four 16-byte vectors of each
// operand per depth step along the operand's contiguous axis (the next
// step's loads in flight during this one's products), split once into TF32
// big and small planes in shared memory, each plane kept in the operand's
// own orientation ([m][k] or [k][m] for A, [k][n] or [n][k] for B) so that
// a vector is one 16-byte store, with row strides that put the fragment
// reads on distinct banks.
template <bool A_K, bool B_N>
__device__ __forceinline__ void tile_product(const float* __restrict__ A, long long lda,
                                             const float* __restrict__ B, long long ldb,
                                             int M, int N, int k_lo, int k_hi, int m0,
                                             int n0, float (&acc)[2][4][4]) {
  constexpr int kPlane = BM * kALd;  // == BK * kBLd: either orientation
  static_assert(BM * kALd == BK * kBLd && BN == BM, "one plane size for both layouts");
  __shared__ __align__(16) uint32_t Ab[kPlane], Asm[kPlane], Bb[kPlane], Bsm[kPlane];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int wm = (warp >> 1) * 32, wn = (warp & 1) * 32;
  constexpr int kVec = BM * BK / 4 / kGemmThreads;  // 4 vectors per operand
  float4 ra[kVec], rb[kVec];

  // Plane offsets of A(m, k) and B(k, n).
  auto ai = [](int m, int k) { return A_K ? m * kALd + k : k * kBLd + m; };
  auto bi = [](int k, int n) { return B_N ? k * kBLd + n : n * kALd + k; };
  // Vector e's first element: A's (am, ak), B's (bk, bn).
  auto am = [](int e) { return A_K ? e / (BK / 4) : (e % (BM / 4)) * 4; };
  auto ak = [](int e) { return A_K ? (e % (BK / 4)) * 4 : e / (BM / 4); };
  auto bk = [](int e) { return B_N ? e / (BN / 4) : (e % (BK / 4)) * 4; };
  auto bn = [](int e) { return B_N ? (e % (BN / 4)) * 4 : e / (BK / 4); };
  auto load = [&](int k0) {
#pragma unroll
    for (int i = 0; i < kVec; ++i) {
      const int e = tid + i * kGemmThreads;
      ra[i] = A_K ? load4(A, lda, m0 + am(e), k0 + ak(e), M, k_hi)
                  : load4(A, lda, k0 + ak(e), m0 + am(e), k_hi, M);
      rb[i] = B_N ? load4(B, ldb, k0 + bk(e), n0 + bn(e), k_hi, N)
                  : load4(B, ldb, n0 + bn(e), k0 + bk(e), N, k_hi);
    }
  };
  auto put = [](const float4& v, uint32_t* big, uint32_t* small, int at) {
    uint4 b, s;
    split(v.x, b.x, s.x);
    split(v.y, b.y, s.y);
    split(v.z, b.z, s.z);
    split(v.w, b.w, s.w);
    *reinterpret_cast<uint4*>(big + at) = b;
    *reinterpret_cast<uint4*>(small + at) = s;
  };
  auto store = [&]() {
#pragma unroll
    for (int i = 0; i < kVec; ++i) {
      const int e = tid + i * kGemmThreads;
      put(ra[i], Ab, Asm, ai(am(e), ak(e)));
      put(rb[i], Bb, Bsm, bi(bk(e), bn(e)));
    }
  };

  if (k_lo >= k_hi) return;
  load(k_lo);
  for (int k0 = k_lo; k0 < k_hi; k0 += BK) {
    store();
    __syncthreads();
    if (k0 + BK < k_hi) load(k0 + BK);
#pragma unroll
    for (int kk = 0; kk < BK; kk += 8) {
      uint32_t ab[2][4], as[2][4], bb[4][2], bs[4][2];
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int r = wm + 16 * i + g;
        const int o[4] = {ai(r, kk + t), ai(r + 8, kk + t), ai(r, kk + t + 4),
                          ai(r + 8, kk + t + 4)};
#pragma unroll
        for (int h = 0; h < 4; ++h) {
          ab[i][h] = Ab[o[h]];
          as[i][h] = Asm[o[h]];
        }
      }
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int c = wn + 8 * j + g;
        const int o[2] = {bi(kk + t, c), bi(kk + t + 4, c)};
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          bb[j][h] = Bb[o[h]];
          bs[j][h] = Bsm[o[h]];
        }
      }
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          mma(acc[i][j], as[i], bb[j]);
          mma(acc[i][j], ab[i], bs[j]);
          mma(acc[i][j], ab[i], bb[j]);
        }
    }
    __syncthreads();
  }
}

// epi(m, n, v) for every element of the warp's share inside [M, N).
template <typename Epi>
__device__ __forceinline__ void tile_epilogue(const float (&acc)[2][4][4], int M, int N,
                                              int m0, int n0, const Epi& epi) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int wm = (warp >> 1) * 32, wn = (warp & 1) * 32;
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int h = 0; h < 4; ++h) {
        const int m = m0 + wm + 16 * i + g + 8 * (h >> 1);
        const int n = n0 + wn + 8 * j + 2 * t + (h & 1);
        if (m < M && n < N) epi(m, n, acc[i][j][h]);
      }
}

enum Act { kNone = 0, kRelu = 1, kTanh = 2 };

// out[m, n] = act(v + bias[n]): h1, h2 and the logits.
struct BiasAct {
  const float* bias;
  float* out;
  int ldo, act;
  __device__ void operator()(int m, int n, float v) const {
    v += bias[n];
    if (act == kRelu) v = fmaxf(v, 0.f);
    if (act == kTanh) v = tanhf(v);
    out[static_cast<long long>(m) * ldo + n] = v;
  }
};

// out[m, n] = v * deriv(h[m, n]), deriv = 1 - h^2 (tanh) or h > 0 (ReLU):
// dh2 and dh1.
struct Deriv {
  const float* h;
  float* out;
  int ldh, ldo;
  bool tanh_;
  __device__ void operator()(int m, int n, float v) const {
    const float x = h[static_cast<long long>(m) * ldh + n];
    out[static_cast<long long>(m) * ldo + n] = v * (tanh_ ? 1.f - x * x : (x > 0.f ? 1.f : 0.f));
  }
};

// Phase A's products: an [M, N] = [R, N] output over 64 x 64 tiles.
template <bool A_K, bool B_N, typename Epi>
__global__ void __launch_bounds__(kGemmThreads, kGemmBlocksPerSm)
layer_kernel(const float* __restrict__ A, long long lda, const float* __restrict__ B,
             long long ldb, int M, int N, int K, Epi epi) {
  float acc[2][4][4] = {};
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;
  tile_product<A_K, B_N>(A, lda, B, ldb, M, N, 0, K, m0, n0, acc);
  tile_epilogue(acc, M, N, m0, n0, epi);
}

// Phase B: the three weight gradients (with their bias rows) over all tiles
// and parts, one block each; block b is (problem, tile, part).
struct GradProblem {
  const float* A;  // [R, lda]: the layer's input with its ones column
  const float* D;  // [R, N]: the layer's output gradient
  int lda, M, N, tiles_n, blocks;
  long long out;   // offset in the flat sums
};

struct GradArgs {
  GradProblem p[3];
  int R, rows_per_part, parts, tile_blocks;
  long long G;
  float* part;  // [parts, G]
  const float* rl;  // [R] w * loss per row
  const float* wt;  // [R] weights
  float* stats;     // the workspace's (loss_sum, count)
  float* stats_out;  // the sums form's (loss_sum, count, 0, 0), or null
  float* loss_out;   // the step form's mean loss, or null
};

// The loss sum and the count over the R rows in a fixed order (each thread
// a strided share in row order, then a halving tree); the step form also
// writes loss_sum / max(count, 1).
__device__ void row_stats(const GradArgs& a) {
  __shared__ float sl[kGemmThreads], sc[kGemmThreads];
  float l = 0.f, c = 0.f;
  for (int r = threadIdx.x; r < a.R; r += kGemmThreads) {
    l += a.rl[r];
    c += a.wt[r];
  }
  sl[threadIdx.x] = l;
  sc[threadIdx.x] = c;
  __syncthreads();
  for (int h = kGemmThreads / 2; h > 0; h >>= 1) {
    if (threadIdx.x < h) {
      sl[threadIdx.x] += sl[threadIdx.x + h];
      sc[threadIdx.x] += sc[threadIdx.x + h];
    }
    __syncthreads();
  }
  if (threadIdx.x == 0) {
    a.stats[0] = sl[0];
    a.stats[1] = sc[0];
    if (a.stats_out) {
      a.stats_out[0] = sl[0];
      a.stats_out[1] = sc[0];
      a.stats_out[2] = 0.f;
      a.stats_out[3] = 0.f;
    }
    if (a.loss_out) a.loss_out[0] = sl[0] / fmaxf(sc[0], 1.f);
  }
}

// Blocks 0 .. tile_blocks - 1: a (problem, tile, part) each; the last
// block: row_stats.
__global__ void __launch_bounds__(kGemmThreads, kGemmBlocksPerSm)
grads_kernel(const GradArgs a) {
  if (static_cast<int>(blockIdx.x) == a.tile_blocks) {
    row_stats(a);
    return;
  }
  int b = blockIdx.x, q = 0;
  while (q < 2 && b >= a.p[q].blocks) b -= a.p[q++].blocks;
  const GradProblem& pr = a.p[q];
  const int tile = b / a.parts, p = b % a.parts;
  const int m0 = (tile / pr.tiles_n) * BM, n0 = (tile % pr.tiles_n) * BN;
  const int k_lo = p * a.rows_per_part, k_hi = min(a.R, k_lo + a.rows_per_part);
  float acc[2][4][4] = {};
  tile_product<false, true>(pr.A, pr.lda, pr.D, pr.N, pr.M, pr.N, k_lo, k_hi, m0, n0, acc);
  float* out = a.part + p * a.G + pr.out;
  const int N = pr.N;
  tile_epilogue(acc, pr.M, N, m0, n0, [&](int m, int n, float v) {
    out[static_cast<long long>(m) * N + n] = v;
  });
}

// ---------------------------------------------------------------------------
// The row kernels.
// ---------------------------------------------------------------------------

// The gather and the first layer, h1 = relu(x w1 + b1), for a 64 x 64 tile
// of h1.  Each warp gathers rows of the tile: x (times keep), a zero row of
// weight 0 and label -1 for a pool index out of range; the blocks of column
// 0 also write x with its ones column at F (zeros to ldx), the ones columns
// of h1 and h2, the label and the weight to the workspace.  The product is
// FP32 FMA in k order, then the bias, so that the ReLU's kink sees the
// pre-activations an FP32 product in that order gives
// (a TF32 error of 1e-6 flips a pre-activation of 4e-8, and one flipped
// unit moves its whole gradient row).
constexpr int kL1Threads = 256;

__global__ void __launch_bounds__(kL1Threads)
layer1_kernel(const float* __restrict__ x, const int* __restrict__ y,
              const float* __restrict__ wts, const int* __restrict__ order,
              const unsigned char* __restrict__ keep, int n_src, int R, int F, int H1,
              int H2, const float* __restrict__ w1, const float* __restrict__ b1, Work wk,
              float* ws) {
  __shared__ float xs[BM][kMaxF + 1];
  __shared__ __align__(16) float w1s[kMaxF][BN];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;
  const bool writer = blockIdx.x == 0;
  for (int rr = warp; rr < BM; rr += kL1Threads / 32) {
    const int r = m0 + rr;
    if (r >= R) {
      for (int f = lane; f < F; f += 32) xs[rr][f] = 0.f;
      continue;
    }
    const int src = order ? order[r] : r;
    const bool ok = src >= 0 && src < n_src;
    bool nz = false;
    for (int f = lane; f < F; f += 32) {
      float v = 0.f;
      if (ok) {
        v = x[static_cast<long long>(src) * F + f];
        if (keep) v = v * (keep[static_cast<long long>(r) * F + f] ? 1.f : 0.f);
      }
      nz |= v != 0.f;
      xs[rr][f] = v;
    }
    nz = __any_sync(0xffffffffu, nz);
    if (!writer) continue;
    float* xr = ws + wk.x + static_cast<long long>(r) * wk.ldx;
    for (int f = lane; f < wk.ldx; f += 32) xr[f] = f < F ? xs[rr][f] : (f == F ? 1.f : 0.f);
    float* h1r = ws + wk.h1 + static_cast<long long>(r) * wk.ldh1;
    for (int c = H1 + lane; c < wk.ldh1; c += 32) h1r[c] = c == H1 ? 1.f : 0.f;
    float* h2r = ws + wk.h2 + static_cast<long long>(r) * wk.ldh2;
    for (int c = H2 + lane; c < wk.ldh2; c += 32) h2r[c] = c == H2 ? 1.f : 0.f;
    if (lane == 0) {
      reinterpret_cast<int*>(ws + wk.lab)[r] = ok ? y[src] : -1;
      ws[wk.wt + r] = !ok ? 0.f : order == nullptr ? wts[r] : keep == nullptr ? 1.f
                                                                              : (nz ? 1.f : 0.f);
    }
  }
  for (int i = tid; i < F * BN; i += kL1Threads) {
    const int k = i / BN, n = n0 + i % BN;
    w1s[k][i % BN] = n < H1 ? w1[static_cast<long long>(k) * H1 + n] : 0.f;
  }
  __syncthreads();
  // Each thread: rows ty * 4 .. + 3, columns tx * 4 .. + 3 of the tile.
  const int ty = tid / 16, tx = tid % 16;
  float acc[4][4] = {};
  for (int k = 0; k < F; ++k) {
    const float4 wv = *reinterpret_cast<const float4*>(&w1s[k][tx * 4]);
    const float wk4[4] = {wv.x, wv.y, wv.z, wv.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float a = xs[ty * 4 + i][k];
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(a, wk4[j], acc[i][j]);
    }
  }
  float* h1 = ws + wk.h1;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int m = m0 + ty * 4 + i;
    if (m >= R) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int n = n0 + tx * 4 + j;
      if (n < H1) h1[static_cast<long long>(m) * wk.ldh1 + n] = fmaxf(acc[i][j] + b1[n], 0.f);
    }
  }
}

// One warp per row: the masked softmax of the logits, delta in place, and
// w * (lse - <target, logits>).
__global__ void __launch_bounds__(32 * kRowWarps)
softmax_kernel(const int* __restrict__ ns_ptr, int R, int cap, Work wk, float* ws) {
  const int r = blockIdx.x * kRowWarps + (threadIdx.x >> 5);
  if (r >= R) return;
  const int ns = *ns_ptr;
  const int label = reinterpret_cast<const int*>(ws + wk.lab)[r];
  const float w = ws[wk.wt + r];
  const bool hot = label < ns;  // out-of-range labels train a zero target
  const RowStats s = softmax_delta_row(ws + wk.lg + static_cast<long long>(r) * cap, cap,
                                       ns, w, [=](int c) { return hot && c == label ? 1.f : 0.f; });
  if ((threadIdx.x & 31) == 0) ws[wk.rl + r] = (s.lse - s.tdot) * w;
}

// The six parameters, for the step form.
struct Params {
  float *w1, *b1, *w2, *b2, *w3, *b3;
  long long n1, n2, n3, n4, n5;  // segment ends of w1 .. w3 in the flat sums
};

// g = sum of the parts in order; sums[i] = g, or the step p -= scale * g
// with scale = lr / max(count, 1) (0 when count == 0).
__global__ void finish_kernel(const float* __restrict__ part, int parts, long long G,
                              const float* __restrict__ stats, float* sums, Params pp,
                              float lr) {
  const float count = stats[1];
  const float scale = count > 0.f ? lr / fmaxf(count, 1.f) : 0.f;
  for (long long i = 1LL * blockIdx.x * blockDim.x + threadIdx.x; i < G;
       i += 1LL * gridDim.x * blockDim.x) {
    float g = part[i];
    for (int p = 1; p < parts; ++p) g += part[p * G + i];
    if (sums) {
      sums[i] = g;
      continue;
    }
    float* dst = i < pp.n1 ? pp.w1 + i
                 : i < pp.n2 ? pp.b1 + (i - pp.n1)
                 : i < pp.n3 ? pp.w2 + (i - pp.n2)
                 : i < pp.n4 ? pp.b2 + (i - pp.n3)
                 : i < pp.n5 ? pp.w3 + (i - pp.n4)
                             : pp.b3 + (i - pp.n5);
    *dst = *dst - scale * g;
  }
}

int grad_tiles(int F, int H1, int H2, int cap) {
  return static_cast<int>(cdiv(F + 1, BM) * cdiv(H1, BN) + cdiv(H1 + 1, BM) * cdiv(H2, BN) +
                          cdiv(H2 + 1, BM) * cdiv(cap, BN));
}

}  // namespace

extern "C" {

// Floats of the gradient sums, [dw1 | db1 | dw2 | db2 | dw3 | db3].
long long streamz_k5_grad_size(int F, int H1, int H2, int cap) {
  return 1LL * (F + 1) * H1 + 1LL * (H1 + 1) * H2 + 1LL * (H2 + 1) * cap;
}

// The parts phase B cuts the row reduction into: enough blocks to fill
// every SM's kGemmBlocksPerSm slots, at most 16, each part at least one
// depth step of rows.  A function of the shapes alone, so a rerun sums in
// the same order.
int streamz_k5_parts(int R, int F, int H1, int H2, int cap, int sms) {
  long long P = cdiv(1LL * kGemmBlocksPerSm * sms, grad_tiles(F, H1, H2, cap));
  P = P < kMaxParts ? P : kMaxParts;
  const long long steps = cdiv(R, BK);
  P = P < steps ? P : steps;
  return static_cast<int>(P < 1 ? 1 : P);
}

// Floats of the workspace of a launch over R rows.
long long streamz_k5_workspace(int R, int F, int H1, int H2, int cap, int parts) {
  return make_work(R, F, H1, H2, cap, parts).floats;
}

// Launch K5 on `stream` over R rows.  Rows: x [R, F], y [R], wts [R] when
// order is null; else the pool x [n_src, F], y [n_src] read through order
// [R] (and keep [R, F] bytes, or null).  Form: sums [grad_size] and
// stats_out [4] when sums is not null; else the step on the parameters in
// place with lr, the mean loss to loss_out [1].  ws: the workspace.
// Returns the CUDA error of the launches (0 on success); it does not
// synchronise.
int streamz_k5(const float* x, const int* y, const float* wts, const int* order,
               const unsigned char* keep, int n_src, int R, const int* ns, float* w1,
               float* b1, float* w2, float* b2, float* w3, float* b3, int F, int H1,
               int H2, int cap, int parts, float* ws, float* sums, float* stats_out,
               float lr, float* loss_out, void* stream) {
  if (R <= 0 || F <= 0 || F > kMaxF || H1 <= 0 || H2 <= 0 || cap <= 0 || parts < 1 ||
      parts > kMaxParts || (sums == nullptr) == (loss_out == nullptr) ||
      (sums != nullptr) != (stats_out != nullptr) || (order == nullptr && keep != nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const Work wk = make_work(R, F, H1, H2, cap, parts);
  float* xw = ws + wk.x;
  float* h1 = ws + wk.h1;
  float* h2 = ws + wk.h2;
  float* lg = ws + wk.lg;
  float* dh2 = ws + wk.dh2;
  float* dh1 = ws + wk.dh1;
  const unsigned rows_grid = static_cast<unsigned>(cdiv(R, kRowWarps));
  auto grid = [&](int N) {
    return dim3(static_cast<unsigned>(cdiv(N, BN)), static_cast<unsigned>(cdiv(R, BM)));
  };
  cudaError_t err;
#define K5_CHECK()                                 \
  if ((err = cudaGetLastError()) != cudaSuccess) \
    return static_cast<int>(err);

  // Phase A: the gather and the forward, the softmax and the data backward.
  layer1_kernel<<<grid(H1), kL1Threads, 0, s>>>(x, y, wts, order, keep, n_src, R, F, H1,
                                                H2, w1, b1, wk, ws);
  K5_CHECK();
  layer_kernel<true, true><<<grid(H2), kGemmThreads, 0, s>>>(
      h1, wk.ldh1, w2, H2, R, H2, H1, BiasAct{b2, h2, wk.ldh2, kTanh});
  K5_CHECK();
  layer_kernel<true, true><<<grid(cap), kGemmThreads, 0, s>>>(
      h2, wk.ldh2, w3, cap, R, cap, H2, BiasAct{b3, lg, cap, kNone});
  K5_CHECK();
  softmax_kernel<<<rows_grid, 32 * kRowWarps, 0, s>>>(ns, R, cap, wk, ws);
  K5_CHECK();
  layer_kernel<true, false><<<grid(H2), kGemmThreads, 0, s>>>(
      lg, cap, w3, cap, R, H2, cap, Deriv{h2, dh2, wk.ldh2, H2, true});
  K5_CHECK();
  layer_kernel<true, false><<<grid(H1), kGemmThreads, 0, s>>>(
      dh2, H2, w2, H2, R, H1, H2, Deriv{h1, dh1, wk.ldh1, H1, false});
  K5_CHECK();

  // Phase B: the weight gradients with their bias rows, then the form.
  GradArgs ga;
  const int dims[3][2] = {{F + 1, H1}, {H1 + 1, H2}, {H2 + 1, cap}};
  const float* ins[3][2] = {{xw, dh1}, {h1, dh2}, {h2, lg}};
  const int lds[3] = {wk.ldx, wk.ldh1, wk.ldh2};
  long long off = 0, blocks = 0;
  for (int q = 0; q < 3; ++q) {
    GradProblem& pr = ga.p[q];
    pr.A = ins[q][0];
    pr.D = ins[q][1];
    pr.lda = lds[q];
    pr.M = dims[q][0];
    pr.N = dims[q][1];
    pr.tiles_n = static_cast<int>(cdiv(pr.N, BN));
    pr.blocks = static_cast<int>(cdiv(pr.M, BM) * pr.tiles_n * parts);
    pr.out = off;
    off += 1LL * pr.M * pr.N;
    blocks += pr.blocks;
  }
  ga.R = R;
  ga.parts = parts;
  ga.rows_per_part = static_cast<int>(cdiv(cdiv(R, parts), BK) * BK);
  ga.G = off;
  ga.part = ws + wk.part;
  ga.tile_blocks = static_cast<int>(blocks);
  ga.rl = ws + wk.rl;
  ga.wt = ws + wk.wt;
  ga.stats = ws + wk.stats;
  ga.stats_out = stats_out;
  ga.loss_out = loss_out;
  grads_kernel<<<static_cast<unsigned>(blocks + 1), kGemmThreads, 0, s>>>(ga);
  K5_CHECK();
  Params pp{w1, b1, w2, b2, w3, b3, 0, 0, 0, 0, 0};
  pp.n1 = 1LL * F * H1;
  pp.n2 = pp.n1 + H1;
  pp.n3 = pp.n2 + 1LL * H1 * H2;
  pp.n4 = pp.n3 + H2;
  pp.n5 = pp.n4 + 1LL * H2 * cap;
  const long long fin = cdiv(off, 256);
  finish_kernel<<<static_cast<unsigned>(fin < 2048 ? fin : 2048), 256, 0, s>>>(
      ga.part, parts, off, ws + wk.stats, sums, pp, lr);
  K5_CHECK();
#undef K5_CHECK
  return 0;
}

}  // extern "C"
