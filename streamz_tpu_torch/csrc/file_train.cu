// K6 on Hopper: the whole per-file chunk-SGD loop of the discovery loop in
// one launch of one thread-block cluster, hand-written for sm_90a.
//
// Replaces the TPU kernel streamz_tpu/nn/pallas_train.py:_file_train_kernel
// (pallas_train.py:237, reached through train_windows_pallas).  Over S chunks
// of B windows (chunks [S, B, F] f32, masks [S, B] f32 0/1), with a target
// vector tgt [cap] and the live class count ns read from device memory, it
// runs, for each chunk in order,
//
//   forward, masked softmax, report = -sum tgt * log(max(p, 1e-12)),
//   delta = (p - tgt) * mask * (col < ns), backward,
//   count = sum mask; p -= lr / count * grad (no update when count == 0),
//   stats += (sum report * mask, count),
//
// updating the six parameter tensors IN PLACE, and writes stats [2].  A
// chunk with no surviving window leaves the parameters and stats as they are
// (the TPU kernel's zero scale), so it is skipped outright.  Like the TPU
// kernel it takes any chunk size and any widths (F <= 64, as the TPU
// kernel's input padding; every width a multiple of 4).
//
// What bounds it on this card: a step is about 4.4 M multiply-adds at
// capacity 128, but the steps are strictly sequential and each layer needs
// the whole previous layer, so one file runs on C of the 132 SMs.  On those
// SMs the time goes to the per-step barriers across the cluster and to the
// shared-memory reads of the products' operands, not to the FMAs.
//
// The design: one cluster of kCluster CTAs per file.  The TPU kernel keeps
// all parameters resident in VMEM; here they are partitioned by unit over
// the CTAs' shared memory, loaded once and written back once:
//
//   CTA c owns the h1 units J_c (w1[:, J_c], b1[J_c], the rows w2[J_c, :]),
//   the h2 units K_c (b2[K_c]) and the class columns C_c (w3[:, C_c],
//   b3[C_c]).  Slices are a multiple of 4 wide; the last ones are ragged,
//   down to empty.
//
// Per step, with five cluster barriers (A-E):
//   every CTA takes the chunk that cp.async prefetched during the last step;
//   h1[:, J_c] locally; its partial h1[:, J_c] w2[J_c, :] [T, H2]      (A)
//   reduce-scattered over distributed shared memory: CTA c sums K_c's
//   columns of every CTA's partial in rank order, applies b2 and tanh and
//   writes the h2 slice into every CTA (the all-gather)                 (B)
//   logits[:, C_c] locally; per-row (max, sum exp) of its columns       (C)
//   combined in rank order by every CTA; p, delta and the report for C_c;
//   the partial delta[:, C_c] w3[:, C_c]^T                              (D)
//   reduce-scattered and all-gathered like h2, times tanh'              (E)
//   dh1[:, J_c] and every update locally.
// Each weight is read by the backward before its own CTA updates it, so
// only the exchange buffers need the barriers; each buffer is next written
// only after a barrier that every reader has passed.  The products split
// their reduction across warps and add the parts in a fixed order, and
// every cross-CTA sum runs in rank order, so two launches on the same
// inputs give the same bits.  FP32 FMA on the CUDA cores.
//
// Routes, by what fits in a CTA's shared memory (route_for):
//   0 kResident:  every slice and buffer in shared memory;
//   1 kW3Global:  w3 and the logits in device memory (L2), each CTA reading
//                 and updating its own column slice there (capacity past
//                 about 2048 at 16 CTAs, and chunks of 17 or more rows);
//   2 kGlobal:    w1, w2 and w3 in place in device memory, and the
//                 activations and exchange buffers [T, H2] in a device
//                 scratch, one region per CTA; the exchanges read and write
//                 the peers' regions through L2 (wide layers, e.g.
//                 H1 = 4096, or an H2 whose [T, H2] buffers do not fit).
// Chunks of more than 32 windows run as row tiles of 32 within a step
// (T = 32, tiles = ceil(B / 32)): every tile's forward and backward read the
// weights as they were before the chunk, each CTA adds its slices'
// gradient sums tile by tile in order into a device accumulator, and the
// last tile applies p -= lr / count * (sum) with the count over all B rows.
// Chunks of up to 32 windows keep the one-tile step.
//
// Plain C interface, loaded with ctypes from streamz_tpu_torch/nn/
// train_kernels.py, which builds this file with nvcc at first use.

#include <cooperative_groups.h>
#include <cuda_runtime.h>

namespace cg = cooperative_groups;

namespace {

// CTAs per cluster: 16 beat 8 at the main-path file (PERF.md).
constexpr int kCluster = 16;
constexpr int kThreads = 512;
constexpr int kMaxSmem = 232448;    // 227 KB, the most a Hopper block may have
constexpr int kPartFloats = 4096;   // the products' split-reduction scratch
constexpr int kMaxParts = 16;
constexpr int kTileRows = 32;       // rows of the widest instance; wider chunks tile
constexpr float kMaskLogit = -1e30f;  // streamz_tpu/nn/model.py:MASK_LOGIT

enum Route { kResident = 0, kW3Global = 1, kGlobal = 2 };
// How a step's weight gradient is applied: the SGD step itself (one tile per
// chunk), or, over a chunk's row tiles, written, added, then added and
// applied.
enum Update { kSgd = 0, kAccWrite = 1, kAccAdd = 2, kSgdAcc = 3 };

__host__ __device__ inline long long round4(long long n) { return (n + 3) / 4 * 4; }
// A CTA's share of n units, a multiple of 4.
__host__ __device__ inline int slice_of(int n) {
  return static_cast<int>(round4((n + kCluster - 1) / kCluster));
}
// A row stride of 4 (mod 32) floats: the float4 reads of one column by the
// lanes of a warp, each on its own row, fall on distinct banks.
__host__ __device__ inline int padded(int n) { return n + (36 - n % 32) % 32; }

// The shared-memory carve of one CTA (offsets in floats), the same in every
// CTA of the cluster, so a peer's buffer sits at the same offset.  -1: the
// buffer lives in device memory on this route.
struct Layout {
  int jn, kn, cn, ldw2, ldw3, ldl;
  long long x, m, w1, b1, w2, b2, w3, b3, tg, h1, dh1, p, h2, dh2, l, st, ms, rep,
      part, loss, floats;
};

__host__ __device__ inline long long take(long long& at, long long n) {
  const long long o = at;
  at += round4(n);
  return o;
}

__host__ __device__ inline Layout make_layout(int F, int H1, int H2, int cap, int T,
                                              int route) {
  Layout L;
  long long o = 0;
  const bool w3g = route != kResident, all = route == kGlobal;
  L.jn = slice_of(H1);
  L.kn = slice_of(H2);
  L.cn = slice_of(cap);
  L.ldw2 = all ? H2 : padded(H2);
  L.ldw3 = w3g ? cap : padded(L.cn);
  L.ldl = w3g ? cap : L.cn;
  L.x = take(o, 2LL * T * F);  // two chunk buffers: the step's and the prefetch
  L.m = take(o, 2LL * T);
  L.w1 = all ? -1 : take(o, 1LL * F * L.jn);
  L.b1 = take(o, L.jn);
  L.w2 = all ? -1 : take(o, 1LL * L.jn * L.ldw2);
  L.b2 = take(o, L.kn);
  L.w3 = w3g ? -1 : take(o, 1LL * H2 * L.ldw3);
  L.b3 = take(o, L.cn);
  L.tg = take(o, L.cn);
  L.h1 = all ? -1 : take(o, 1LL * T * L.jn);
  L.dh1 = all ? -1 : take(o, 1LL * T * L.jn);
  L.p = all ? -1 : take(o, 1LL * T * H2);   // partial products, read by every peer
  L.h2 = all ? -1 : take(o, 1LL * T * H2);  // written by every peer
  L.dh2 = all ? -1 : take(o, 1LL * T * H2);
  L.l = w3g ? -1 : take(o, 1LL * T * L.cn);
  L.st = take(o, 2LL * T);  // per-row (max, sum exp) of the CTA's columns
  L.ms = take(o, 2LL * T);  // the same over all columns
  L.rep = take(o, T);
  // the products' split reductions, and the exchanges' gathers (which the
  // device-memory route reads in place)
  const long long gather = all ? 0LL : 1LL * kCluster * T * L.kn;
  L.part = take(o, gather > kPartFloats ? gather : kPartFloats);
  L.loss = take(o, 4);  // the loss sum; [1]: the count of a chunk of several row tiles
  L.floats = o;
  return L;
}

// The device scratch of one launch (offsets in floats; -1: not needed): the
// logits [T, cap] (routes 1 and 2, a column slice per CTA), each CTA's
// activations (route 2: h1, dh1 [T, jn]; the partial, h2, dh2 [T, H2]) and
// each CTA's gradient accumulators (chunks of several row tiles: dw1 [F, jn],
// dw2 [jn, H2], dw3 [H2, cn], db1, db2, db3).
struct Scratch {
  long long logits, act, act_per, grads, grads_per, floats;
};

__host__ __device__ inline Scratch make_scratch(int F, int H1, int H2, int cap, int T,
                                                int route, int tiles) {
  Scratch s;
  long long o = 0;
  const int jn = slice_of(H1), kn = slice_of(H2), cn = slice_of(cap);
  s.logits = route != kResident ? take(o, 1LL * T * cap) : -1;
  s.act_per = 2 * round4(1LL * T * jn) + 3 * round4(1LL * T * H2);
  s.act = route == kGlobal ? take(o, kCluster * s.act_per) : -1;
  s.grads_per = round4(1LL * F * jn) + round4(1LL * jn * H2) + round4(1LL * H2 * cn) +
                round4(jn) + round4(kn) + round4(cn);
  s.grads = tiles > 1 ? take(o, kCluster * s.grads_per) : -1;
  s.floats = o;
  return s;
}

long long smem_bytes(int F, int H1, int H2, int cap, int T, int route) {
  return 4LL * make_layout(F, H1, H2, cap, T, route).floats;
}

int rows_for(int B) { return B <= 8 ? 8 : B <= 16 ? 16 : kTileRows; }

// The first route whose shared-memory carve fits; -1 only for a feature
// width far past the TPU kernel's 64.
int route_for(int F, int H1, int H2, int cap, int T) {
  for (int route = kResident; route <= kGlobal; ++route)
    if (smem_bytes(F, H1, H2, cap, T, route) <= kMaxSmem) return route;
  return -1;
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

__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void cluster_barrier() {
  cluster_arrive();
  cluster_wait();
}

// The cluster barrier of a route whose exchanges go through device memory:
// device-scope fences around it order the peers' L2 reads and writes.
template <bool GLOBAL>
__device__ __forceinline__ void exchange_barrier() {
  if constexpr (GLOBAL) __threadfence();
  cluster_barrier();
  if constexpr (GLOBAL) __threadfence();
}

__device__ __forceinline__ void cp_async16(float* dst, const float* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d), "l"(src));
}

__device__ __forceinline__ void cp_async4(float* dst, const float* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(d), "l"(src));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// How many parts a product's reduction is cut into: a power of two, so that
// about every thread has work, within the scratch.
__device__ __forceinline__ int parts_for(int N, int kq, int T) {
  int P = 1;
  while (P < kMaxParts && 2 * P * N <= kThreads && 2 * P * N * T <= kPartFloats &&
         2 * P <= kq)
    P *= 2;
  return P;
}

// epi(r, n, sum_k A[r, k] B(k, n)) for r < T, n < N, with B(k, n) =
// W[k * ldw + n] (TRANS false) or W[n * ldw + k] (TRANS true: the backward
// through a weight, float4 along its rows, whose stride is padded()).  The
// lanes of a warp take consecutive n, and each thread keeps the sums of all
// T rows (independent chains of FMAs).  The K reduction (a multiple of 4)
// is cut into P parts whose sums go through `part` and are added in part
// order.  The caller synchronises the block before reading what epi wrote.
template <int T, bool TRANS, typename Epi>
__device__ __forceinline__ void product(const float* A, int lda, int K, const float* W,
                                        int ldw, int N, float* part, Epi epi) {
  if (N <= 0) return;
  const int kq = K / 4;
  const int P = parts_for(N, kq, T);
  const int per = (kq + P - 1) / P;
  for (int it = threadIdx.x; it < N * P; it += blockDim.x) {
    const int n = it % N, p = it / N;
    float acc[T];
#pragma unroll
    for (int r = 0; r < T; ++r) acc[r] = 0.f;
    const int q1 = min(kq, (p + 1) * per);
    for (int q = p * per; q < q1; ++q) {
      const int k = 4 * q;
      float w0, w1, w2, w3;
      if (TRANS) {
        const float4 v = *reinterpret_cast<const float4*>(W + static_cast<size_t>(n) * ldw + k);
        w0 = v.x; w1 = v.y; w2 = v.z; w3 = v.w;
      } else {
        w0 = W[static_cast<size_t>(k) * ldw + n];
        w1 = W[static_cast<size_t>(k + 1) * ldw + n];
        w2 = W[static_cast<size_t>(k + 2) * ldw + n];
        w3 = W[static_cast<size_t>(k + 3) * ldw + n];
      }
#pragma unroll
      for (int r = 0; r < T; ++r) {
        const float4 a = *reinterpret_cast<const float4*>(A + r * lda + k);
        acc[r] = fmaf(a.x, w0, acc[r]);
        acc[r] = fmaf(a.y, w1, acc[r]);
        acc[r] = fmaf(a.z, w2, acc[r]);
        acc[r] = fmaf(a.w, w3, acc[r]);
      }
    }
    if (P == 1) {
#pragma unroll
      for (int r = 0; r < T; ++r) epi(r, n, acc[r]);
    } else {
#pragma unroll
      for (int r = 0; r < T; ++r) part[(p * T + r) * N + n] = acc[r];
    }
  }
  if (P > 1) {
    __syncthreads();
    for (int it = threadIdx.x; it < T * N; it += blockDim.x) {
      const int r = it / N, n = it % N;
      float v = 0.f;
      for (int p = 0; p < P; ++p) v += part[(p * T + r) * N + n];
      epi(r, n, v);
    }
  }
}

// g = sum_r A[r, k] D[r, n] for k < K, n < N (both multiples of 4), then by
// MODE: W[k * ldw + n] -= scale * g (one SGD step of a weight slice, in
// place), G[k * ldg + n] = g, G += g, or W -= scale * (G + g).  Each thread
// owns a 4 x 4 tile: 16 FMAs per two 16-byte loads.
template <int T, int MODE>
__device__ __forceinline__ void outer_update(const float* A, int lda, int K, const float* D,
                                             int ldd, int N, float* W, int ldw, float* G,
                                             int ldg, float scale) {
  const int nq = N / 4;
  for (int it = threadIdx.x; it < (K / 4) * nq; it += blockDim.x) {
    const int k0 = 4 * (it / nq), n0 = 4 * (it % nq);
    float acc[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
#pragma unroll
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
      float4* g = reinterpret_cast<float4*>(G + static_cast<size_t>(k0 + i) * ldg + n0);
      if constexpr (MODE == kAccWrite) {
        *g = make_float4(acc[i][0], acc[i][1], acc[i][2], acc[i][3]);
        continue;
      }
      if constexpr (MODE == kAccAdd || MODE == kSgdAcc) {
        const float4 s = *g;
        acc[i][0] += s.x; acc[i][1] += s.y; acc[i][2] += s.z; acc[i][3] += s.w;
      }
      if constexpr (MODE == kAccAdd) {
        *g = make_float4(acc[i][0], acc[i][1], acc[i][2], acc[i][3]);
        continue;
      }
      float4* w = reinterpret_cast<float4*>(W + static_cast<size_t>(k0 + i) * ldw + n0);
      float4 v = *w;
      v.x -= scale * acc[i][0];
      v.y -= scale * acc[i][1];
      v.z -= scale * acc[i][2];
      v.w -= scale * acc[i][3];
      *w = v;
    }
  }
}

// The bias of outer_update: g = sum_r D[r, n] for n < N, applied to b (or
// accumulated in G) by MODE.
template <int T, int MODE>
__device__ __forceinline__ void bias_update(const float* D, int ldd, int N, float* b,
                                            float* G, float scale) {
  for (int n = threadIdx.x; n < N; n += blockDim.x) {
    float acc = 0.f;
#pragma unroll
    for (int r = 0; r < T; ++r) acc += D[r * ldd + n];
    if constexpr (MODE == kAccWrite) {
      G[n] = acc;
    } else if constexpr (MODE == kAccAdd) {
      G[n] += acc;
    } else {
      if constexpr (MODE == kSgdAcc) acc += G[n];
      b[n] -= scale * acc;
    }
  }
}

// The reduce-scatter and all-gather of a [T, H2] partial that every CTA
// holds at `part`: for this CTA's columns [k0, k0 + kc), the sum over the
// ranks in order, passed through f(r, k, sum) (four columns at a time),
// is written to `out` in every CTA of the cluster.  Every thread takes part
// in each of the three stages, so each stage is one round trip over the
// cluster: gather every rank's columns into `stage` [kCluster, T, kc], sum
// them locally, push the sums to the peers.
template <int T, typename Fn>
__device__ __forceinline__ void reduce_push(cg::cluster_group& cl, int rank, float* part,
                                            float* out, float* stage, int H2, int k0,
                                            int kc, Fn f) {
  const int nq = kc / 4, items = T * nq;
  float4* stage4 = reinterpret_cast<float4*>(stage);
  for (int it = threadIdx.x; it < kCluster * items; it += blockDim.x) {
    const int q = it / items, i = it % items;
    const int off = (i / nq) * H2 + k0 + 4 * (i % nq);
    stage4[it] = *reinterpret_cast<const float4*>(cl.map_shared_rank(part, q) + off);
  }
  __syncthreads();
  for (int i = threadIdx.x; i < items; i += blockDim.x) {
    const int r = i / nq, k = k0 + 4 * (i % nq);
    float4 s = stage4[i];
    for (int q = 1; q < kCluster; ++q) {
      const float4 v = stage4[q * items + i];
      s.x += v.x; s.y += v.y; s.z += v.z; s.w += v.w;
    }
    *reinterpret_cast<float4*>(out + r * H2 + k) = f(r, k, s);
  }
  __syncthreads();
  for (int it = threadIdx.x; it < kCluster * items; it += blockDim.x) {
    const int q = it / items, i = it % items;
    if (q == rank) continue;
    const int off = (i / nq) * H2 + k0 + 4 * (i % nq);
    *reinterpret_cast<float4*>(cl.map_shared_rank(out, q) + off) =
        *reinterpret_cast<const float4*>(out + off);
  }
}

// reduce_push on the device-memory route: rank q's buffers sit `stride`
// floats after rank q - 1's, so the sum reads every rank's partial in place
// (through L2, rank order) and the result is written to every rank's `out`.
template <int T, typename Fn>
__device__ __forceinline__ void reduce_push_global(int rank, long long stride,
                                                   const float* part, float* out, int H2,
                                                   int k0, int kc, Fn f) {
  const int nq = kc / 4, items = T * nq;
  const float* part0 = part - rank * stride;
  float* out0 = out - rank * stride;
  for (int i = threadIdx.x; i < items; i += blockDim.x) {
    const int r = i / nq, k = k0 + 4 * (i % nq);
    const long long off = 1LL * r * H2 + k;
    float4 s = __ldcg(reinterpret_cast<const float4*>(part0 + off));
    for (int q = 1; q < kCluster; ++q) {
      const float4 v = __ldcg(reinterpret_cast<const float4*>(part0 + q * stride + off));
      s.x += v.x; s.y += v.y; s.z += v.z; s.w += v.w;
    }
    const float4 v = f(r, k, s);
    for (int q = 0; q < kCluster; ++q)
      __stcg(reinterpret_cast<float4*>(out0 + q * stride + off), v);
  }
}

struct Args {
  const float* chunks;
  const float* masks;
  int S, B, F;
  const float* tgt;
  const int* ns;
  float lr;
  float *w1, *b1, *w2, *b2, *w3, *b3;
  int H1, H2, cap;
  float* scratch;  // make_scratch's device scratch (routes 1, 2; row tiles)
  float* stats;
};

template <int MODE>
struct Mode {
  static constexpr int value = MODE;
};

template <int T, int ROUTE>
__global__ void __launch_bounds__(kThreads) file_train_kernel(const Args a) {
  constexpr bool W3G = ROUTE != kResident;
  constexpr bool ALLG = ROUTE == kGlobal;
  extern __shared__ float4 smem4[];
  float* sm = reinterpret_cast<float*>(smem4);
  cg::cluster_group cl = cg::this_cluster();
  const int rank = static_cast<int>(cl.block_rank());
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31, nwarps = blockDim.x >> 5;
  const int F = a.F, H1 = a.H1, H2 = a.H2, cap = a.cap, B = a.B, S = a.S;
  // Row tiles per chunk: more than one only in the widest instance.
  const int tiles = T == kTileRows ? (B + T - 1) / T : 1;
  const Layout lay = make_layout(F, H1, H2, cap, T, ROUTE);
  const Scratch sc = make_scratch(F, H1, H2, cap, T, ROUTE, tiles);
  const int jn = lay.jn, kn = lay.kn, cn = lay.cn, ldw2 = lay.ldw2, ldw3 = lay.ldw3,
            ldl = lay.ldl;
  const int ldw1 = ALLG ? H1 : jn;
  const int j0 = rank * jn, jc = max(0, min(jn, H1 - j0));
  const int k0 = rank * kn, kc = max(0, min(kn, H2 - k0));
  const int c0 = rank * cn, cc = max(0, min(cn, cap - c0));
  float* act = ALLG ? a.scratch + sc.act + rank * sc.act_per : nullptr;
  float* sx = sm + lay.x;
  float* smk = sm + lay.m;
  float* w1s = ALLG ? a.w1 + j0 : sm + lay.w1;
  float* b1s = sm + lay.b1;
  float* w2s = ALLG ? a.w2 + static_cast<size_t>(j0) * H2 : sm + lay.w2;
  float* b2s = sm + lay.b2;
  float* w3p = W3G ? a.w3 + c0 : sm + lay.w3;
  float* b3s = sm + lay.b3;
  float* tg = sm + lay.tg;
  const long long tjn = round4(1LL * T * jn), th2 = round4(1LL * T * H2);
  float* h1 = ALLG ? act : sm + lay.h1;
  float* dh1 = ALLG ? act + tjn : sm + lay.dh1;
  float* pp = ALLG ? act + 2 * tjn : sm + lay.p;
  float* h2 = ALLG ? act + 2 * tjn + th2 : sm + lay.h2;
  float* dh2 = ALLG ? act + 2 * tjn + 2 * th2 : sm + lay.dh2;
  float* lg = W3G ? a.scratch + sc.logits + c0 : sm + lay.l;
  float* st = sm + lay.st;
  float* ms = sm + lay.ms;
  float* rep = sm + lay.rep;
  float* part = sm + lay.part;
  float* lossbuf = sm + lay.loss;
  float* chunk_cnt = lossbuf + 1;
  // The gradient accumulators of this CTA's slices (several row tiles).
  float* g1 = tiles > 1 ? a.scratch + sc.grads + rank * sc.grads_per : nullptr;
  float* g2 = g1 + round4(1LL * F * jn);
  float* g3 = g2 + round4(1LL * jn * H2);
  float* gb1 = g3 + round4(1LL * H2 * cn);
  float* gb2 = gb1 + round4(jn);
  float* gb3 = gb2 + round4(kn);
  const int ns = *a.ns;

  // The slices, in once.  Rows past B of both chunk buffers stay 0.
  for (int i = tid; i < 2 * T * F; i += blockDim.x) sx[i] = 0.f;
  for (int i = tid; i < 2 * T; i += blockDim.x) smk[i] = 0.f;
  if (!ALLG) {
    for (int i = tid; i < F * (jc / 4); i += blockDim.x) {
      const int k = i / (jc / 4), n = 4 * (i % (jc / 4));
      *reinterpret_cast<float4*>(w1s + k * jn + n) =
          *reinterpret_cast<const float4*>(a.w1 + static_cast<size_t>(k) * H1 + j0 + n);
    }
    for (int i = tid; i < jc * (H2 / 4); i += blockDim.x) {
      const int k = i / (H2 / 4), n = 4 * (i % (H2 / 4));
      *reinterpret_cast<float4*>(w2s + k * ldw2 + n) =
          *reinterpret_cast<const float4*>(a.w2 + static_cast<size_t>(j0 + k) * H2 + n);
    }
  }
  if (!W3G) {
    for (int i = tid; i < H2 * (cc / 4); i += blockDim.x) {
      const int k = i / (cc / 4), n = 4 * (i % (cc / 4));
      *reinterpret_cast<float4*>(w3p + k * ldw3 + n) =
          *reinterpret_cast<const float4*>(a.w3 + static_cast<size_t>(k) * cap + c0 + n);
    }
  }
  for (int n = tid; n < jc; n += blockDim.x) b1s[n] = a.b1[j0 + n];
  for (int n = tid; n < kc; n += blockDim.x) b2s[n] = a.b2[k0 + n];
  for (int n = tid; n < cc; n += blockDim.x) {
    b3s[n] = a.b3[c0 + n];
    tg[n] = a.tgt[c0 + n];
  }
  __syncthreads();

  // Unit u is row tile u % tiles of chunk u / tiles.
  const int units = S * tiles;
  auto load_unit = [&](int u, int buf) {
    if (u < units) {
      const int s = u / tiles, r0 = (u % tiles) * T, nr = min(T, B - r0);
      const float* src = a.chunks + (static_cast<size_t>(s) * B + r0) * F;
      float* dst = sx + buf * T * F;
      for (int i = tid; i < nr * F / 4; i += blockDim.x) cp_async16(dst + 4 * i, src + 4 * i);
      for (int r = tid; r < nr; r += blockDim.x)
        cp_async4(smk + buf * T + r, a.masks + static_cast<size_t>(s) * B + r0 + r);
      if (tiles > 1) {  // a ragged last tile: rows an earlier tile left are cleared
        for (int i = nr * F + tid; i < T * F; i += blockDim.x) dst[i] = 0.f;
        for (int r = nr + tid; r < T; r += blockDim.x) smk[buf * T + r] = 0.f;
      }
    }
    cp_async_commit();
  };
  // fn(Mode<m>{}) with this unit's update mode: the SGD step for a one-tile
  // chunk; over several row tiles, accumulate, and apply at the last.
  auto with_mode = [&](int t, auto&& fn) {
    if constexpr (T == kTileRows) {
      if (tiles > 1) {
        if (t == 0) fn(Mode<kAccWrite>{});
        else if (t + 1 < tiles) fn(Mode<kAccAdd>{});
        else fn(Mode<kSgdAcc>{});
        return;
      }
    }
    fn(Mode<kSgd>{});
  };

  float loss_acc = 0.f, cnt_acc = 0.f;  // thread 0's
  load_unit(0, 0);
  for (int u = 0; u < units; ++u) {
    // The buffer unit u - 1 used is free: every unit ends in a barrier.
    load_unit(u + 1, (u + 1) & 1);
    const int s = u / tiles, t = u - s * tiles;
    if (tiles > 1 && t == 0 && warp == 0) {  // the count over the whole chunk
      float c = 0.f;
      for (int r = lane; r < B; r += 32) c += a.masks[static_cast<size_t>(s) * B + r];
      c = warp_sum(c);
      if (lane == 0) chunk_cnt[0] = c;
    }
    cp_async_wait<1>();
    __syncthreads();
    const float* x = sx + (u & 1) * T * F;
    const float* mk = smk + (u & 1) * T;
    float count = 0.f;
    if (tiles > 1) {
      count = chunk_cnt[0];
    } else {
#pragma unroll
      for (int r = 0; r < T; ++r) count += mk[r];
    }
    if (count == 0.f) {  // the same in every thread of every CTA
      __syncthreads();
      continue;
    }
    const float scale = a.lr / fmaxf(count, 1.f);

    // h1[:, J_c], then this CTA's partial of h1 w2.
    product<T, false>(x, F, F, w1s, ldw1, jc, part, [&](int r, int n, float v) {
      h1[r * jn + n] = fmaxf(v + b1s[n], 0.f);
    });
    __syncthreads();
    product<T, false>(h1, jn, jc, w2s, ldw2, H2, part,
                      [&](int r, int n, float v) { pp[r * H2 + n] = v; });
    exchange_barrier<ALLG>();  // A: every partial is written
    auto tanh_b2 = [&](int, int k, float4 v) {
      const float* b = b2s + (k - k0);
      return make_float4(tanhf(v.x + b[0]), tanhf(v.y + b[1]), tanhf(v.z + b[2]),
                         tanhf(v.w + b[3]));
    };
    if constexpr (ALLG) {
      reduce_push_global<T>(rank, sc.act_per, pp, h2, H2, k0, kc, tanh_b2);
    } else {
      reduce_push<T>(cl, rank, pp, h2, part, H2, k0, kc, tanh_b2);
    }
    exchange_barrier<ALLG>();  // B: h2 is whole in every CTA

    // logits[:, C_c] and their per-row (max, sum exp).
    product<T, false>(h2, H2, H2, w3p, ldw3, cc, part, [&](int r, int n, float v) {
      lg[r * ldl + n] = v + b3s[n];
    });
    __syncthreads();
    for (int r = warp; r < T; r += nwarps) {
      const float* lr_ = lg + r * ldl;
      float m = __int_as_float(0xff800000);  // -inf, also for an empty slice
      for (int c = lane; c < cc; c += 32) m = fmaxf(m, c0 + c < ns ? lr_[c] : kMaskLogit);
      m = warp_max(m);
      float se = 0.f;
      for (int c = lane; c < cc; c += 32) se += expf((c0 + c < ns ? lr_[c] : kMaskLogit) - m);
      se = warp_sum(se);
      if (lane == 0) {
        st[2 * r] = m;
        st[2 * r + 1] = se;
      }
    }
    cluster_barrier();  // C: every CTA's row statistics are written
    // Every rank's row statistics, gathered in one round trip, then combined
    // in rank order.
    for (int it = tid; it < kCluster * T; it += blockDim.x)
      reinterpret_cast<float2*>(part)[it] =
          reinterpret_cast<const float2*>(cl.map_shared_rank(st, it / T))[it % T];
    __syncthreads();
    if (tid < T) {
      const float2* sq = reinterpret_cast<const float2*>(part) + tid;
      float M = __int_as_float(0xff800000);
      for (int q = 0; q < kCluster; ++q) M = fmaxf(M, sq[q * T].x);
      float Ssum = 0.f;
      for (int q = 0; q < kCluster; ++q) Ssum += sq[q * T].y * expf(sq[q * T].x - M);
      ms[2 * tid] = M;
      ms[2 * tid + 1] = Ssum;
    }
    __syncthreads();
    // p, the report and delta = (p - t) * mask * (col < ns), in place.
    for (int r = warp; r < T; r += nwarps) {
      float* lr_ = lg + r * ldl;
      const float w = mk[r], M = ms[2 * r], Ssum = ms[2 * r + 1];
      float report = 0.f;
      for (int c = lane; c < cc; c += 32) {
        const bool live = c0 + c < ns;
        const float l = live ? lr_[c] : kMaskLogit;
        const float p = expf(l - M) / Ssum;
        const float t = tg[c];
        report = fmaf(t, logf(fmaxf(p, 1e-12f)), report);
        lr_[c] = live ? (p - t) * w : 0.f;
      }
      report = warp_sum(report);
      if (lane == 0) rep[r] = -report * w;
    }
    __syncthreads();
    // This CTA's partial of delta w3^T, from w3 before its update.
    product<T, true>(lg, ldl, cc, w3p, ldw3, H2, part,
                     [&](int r, int n, float v) { pp[r * H2 + n] = v; });
    __syncthreads();
    if constexpr (ALLG) __threadfence();
    cluster_arrive();  // D, arrive: the partial is written
    with_mode(t, [&](auto m) {
      constexpr int M = decltype(m)::value;
      outer_update<T, M>(h2, H2, H2, lg, ldl, cc, w3p, ldw3, g3, cn, scale);
      bias_update<T, M>(lg, ldl, cc, b3s, gb3, scale);
    });
    if (tid == 0) {
      float loss = 0.f;
      for (int r = 0; r < T; ++r) loss += rep[r];
      loss_acc += loss;
      if (t == 0) cnt_acc += count;
    }
    cluster_wait();  // D, wait
    if constexpr (ALLG) __threadfence();
    auto tanh_deriv = [&](int r, int k, float4 v) {
      const float* h = h2 + r * H2 + k;
      return make_float4(v.x * (1.f - h[0] * h[0]), v.y * (1.f - h[1] * h[1]),
                         v.z * (1.f - h[2] * h[2]), v.w * (1.f - h[3] * h[3]));
    };
    if constexpr (ALLG) {
      reduce_push_global<T>(rank, sc.act_per, pp, dh2, H2, k0, kc, tanh_deriv);
    } else {
      reduce_push<T>(cl, rank, pp, dh2, part, H2, k0, kc, tanh_deriv);
    }
    exchange_barrier<ALLG>();  // E: dh2 is whole in every CTA

    // dh1[:, J_c] from w2 before its update, then the local updates.
    product<T, true>(dh2, H2, H2, w2s, ldw2, jc, part, [&](int r, int n, float v) {
      dh1[r * jn + n] = v * (h1[r * jn + n] > 0.f ? 1.f : 0.f);
    });
    __syncthreads();
    with_mode(t, [&](auto m) {
      constexpr int M = decltype(m)::value;
      outer_update<T, M>(h1, jn, jc, dh2, H2, H2, w2s, ldw2, g2, H2, scale);
      bias_update<T, M>(dh2 + k0, H2, kc, b2s, gb2, scale);
      outer_update<T, M>(x, F, F, dh1, jn, jc, w1s, ldw1, g1, jn, scale);
      bias_update<T, M>(dh1, jn, jc, b1s, gb1, scale);
    });
    __syncthreads();
  }
  cp_async_wait<0>();

  // The slices, out once; then the stats, summed in rank order.
  if (!ALLG) {
    for (int i = tid; i < F * (jc / 4); i += blockDim.x) {
      const int k = i / (jc / 4), n = 4 * (i % (jc / 4));
      *reinterpret_cast<float4*>(a.w1 + static_cast<size_t>(k) * H1 + j0 + n) =
          *reinterpret_cast<const float4*>(w1s + k * jn + n);
    }
    for (int i = tid; i < jc * (H2 / 4); i += blockDim.x) {
      const int k = i / (H2 / 4), n = 4 * (i % (H2 / 4));
      *reinterpret_cast<float4*>(a.w2 + static_cast<size_t>(j0 + k) * H2 + n) =
          *reinterpret_cast<const float4*>(w2s + k * ldw2 + n);
    }
  }
  if (!W3G) {
    for (int i = tid; i < H2 * (cc / 4); i += blockDim.x) {
      const int k = i / (cc / 4), n = 4 * (i % (cc / 4));
      *reinterpret_cast<float4*>(a.w3 + static_cast<size_t>(k) * cap + c0 + n) =
          *reinterpret_cast<const float4*>(w3p + k * ldw3 + n);
    }
  }
  for (int n = tid; n < jc; n += blockDim.x) a.b1[j0 + n] = b1s[n];
  for (int n = tid; n < kc; n += blockDim.x) a.b2[k0 + n] = b2s[n];
  for (int n = tid; n < cc; n += blockDim.x) a.b3[c0 + n] = b3s[n];
  if (tid == 0) lossbuf[0] = loss_acc;
  cluster_barrier();
  if (rank == 0 && tid == 0) {
    float loss = 0.f;
    for (int q = 0; q < kCluster; ++q) loss += cl.map_shared_rank(lossbuf, q)[0];
    a.stats[0] = loss;
    a.stats[1] = cnt_acc;
  }
  cluster_barrier();  // no CTA leaves while rank 0 reads its shared memory
}

template <int T, int ROUTE>
cudaError_t launch(const Args& args, cudaStream_t stream) {
  const auto kernel = file_train_kernel<T, ROUTE>;
  const int smem = static_cast<int>(smem_bytes(args.F, args.H1, args.H2, args.cap, T, ROUTE));
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  // More than 8 CTAs is a non-portable cluster size.
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  if (err != cudaSuccess) return err;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = kCluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(kCluster);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  int clusters = 0;
  err = cudaOccupancyMaxActiveClusters(&clusters, kernel, &cfg);
  if (err != cudaSuccess) return err;
  if (clusters < 1) return cudaErrorLaunchOutOfResources;
  err = cudaLaunchKernelEx(&cfg, kernel, args);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

template <int T>
cudaError_t launch_rows(const Args& args, int route, cudaStream_t stream) {
  switch (route) {
    case kResident: return launch<T, kResident>(args, stream);
    case kW3Global: return launch<T, kW3Global>(args, stream);
    default: return launch<T, kGlobal>(args, stream);
  }
}

}  // namespace

extern "C" {

// Rows one step (one row tile of a step, past 32 windows) computes for
// chunks of B windows.
int streamz_file_train_rows(int B) { return rows_for(B); }

// CTAs in the cluster of one launch.
int streamz_file_train_cluster() { return kCluster; }

// The route at these widths and chunks of B windows: 0 every slice in the
// CTAs' shared memory, 1 w3 in device memory, 2 w1, w2, w3 and the
// activations in device memory; -1 for a feature width no route takes.
int streamz_file_train_route(int F, int H1, int H2, int cap, int B) {
  return route_for(F, H1, H2, cap, rows_for(B));
}

// Floats of device scratch a launch takes (0: none).
long long streamz_file_train_scratch(int F, int H1, int H2, int cap, int B) {
  const int T = rows_for(B);
  const int route = route_for(F, H1, H2, cap, T);
  return route < 0 ? 0 : make_scratch(F, H1, H2, cap, T, route, (B + T - 1) / T).floats;
}

// Launch K6 on `stream`: one cluster.  The parameters are updated in place;
// stats gets (loss sum, count).  scratch: streamz_file_train_scratch floats
// (null when that is 0).  chunks must be 16-byte aligned.  The wrapper
// handles S == 0 without launching.  Returns the CUDA error of the launch
// (0 on success, and an error when the cluster cannot be placed); it does
// not synchronise.
int streamz_file_train(const float* chunks, const float* masks, int S, int B, int F,
                       const float* tgt, const int* ns, float lr, float* w1,
                       float* b1, float* w2, float* b2, float* w3, float* b3, int H1,
                       int H2, int cap, float* scratch, float* stats, void* stream) {
  if (S <= 0 || B <= 0 || F <= 0 || H1 <= 0 || H2 <= 0 || cap <= 0 || F % 4 ||
      H1 % 4 || H2 % 4 || cap % 4 || reinterpret_cast<size_t>(chunks) % 16)
    return static_cast<int>(cudaErrorInvalidValue);
  const int T = rows_for(B);
  const int route = route_for(F, H1, H2, cap, T);
  const long long need =
      route < 0 ? 0 : make_scratch(F, H1, H2, cap, T, route, (B + T - 1) / T).floats;
  if (route < 0 || (need > 0) != (scratch != nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  const Args args{chunks, masks, S, B, F, tgt, ns, lr, w1, b1, w2, b2, w3, b3,
                  H1, H2, cap, scratch, stats};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  switch (T) {
    case 8: err = launch_rows<8>(args, route, s); break;
    case 16: err = launch_rows<16>(args, route, s); break;
    default: err = launch_rows<kTileRows>(args, route, s); break;
  }
  return static_cast<int>(err);
}

}  // extern "C"
