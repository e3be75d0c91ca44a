// K7 on Hopper: the fused classifier forward, hand-written for sm_90a.
//
// Replaces the TPU kernel streamz_tpu/nn/pallas_forward.py:_fwd_kernel
// (reached through forward_probs_pallas).  It computes what that kernel
// computes, whose three products run at DEFAULT precision (one bf16 pass,
// f32 sums): for window features x [R, F] f32 and the MLP's parameters
//
//   h1 = relu(bf16(x) bf16(w1) + b1), h2 = tanh(bf16(h1) bf16(w2) + b2),
//   logits = bf16(h2) bf16(w3) + b3,
//   columns >= ns masked to -1e30, probs = softmax(logits),
//
// each bf16(.) rounded to nearest even; every sum, the biases, relu, tanh,
// the mask and the softmax in f32.  It writes probs [R, cap] with the
// inactive columns exactly 0.0, also when ns == 0, where the all-masked
// softmax would be a uniform row (the TPU kernel writes zeros there too).
//
// What bounds it on this card: 2 (F H1 + H1 H2 + H2 cap) bf16 operations a
// row, 0.39 MFLOP at 60 -> 512 -> 256 -> 128, against 240 bytes in and 512
// out: far above the bf16 ridge (about 295 operations a byte), so the
// tensor cores.  The design:
//
// - A pack kernel rounds w1, w2 and w3 to bf16 once per call into a scratch
//   buffer, in the order the main kernel streams them and in the layout that
//   wgmma reads as B: per layer, its output columns in chunks of kN = 128,
//   each chunk's k16 steps in order, each step [128 n, 16 k] K-major in the
//   32-byte swizzle (hopper.cuh's make_desc), zero past the layer's widths
//   (K padded to whole ring stages, N to whole chunks).  Nothing is cached
//   across calls: K5 and K6 update the parameters in place.
// - Persistent clusters of kCluster CTAs, each with kGroups consumer
//   warpgroups and one producer warp.  Each consumer warpgroup owns a tile of
//   kRows = 64 rows (one wgmma M).  Every warpgroup of a cluster walks the
//   same weight stream, which the producer warps feed through a ring of
//   kStages shared-memory stages (kStageSteps k16 steps of one chunk, 16
//   KB) by multicast bulk copies (cp.async.bulk, mbarrier complete_tx): one
//   L2 read of a stage serves kCluster x kGroups x 64 = 256 rows.
// - The hidden layers stay on chip.  Each warpgroup keeps its tile's x (then
//   h2) and h1 in shared memory as bf16, in the 64-row core-matrix layout
//   (8-k column c at c KB, row r at 16 r bytes: wgmma's unswizzled K-major
//   A).  Each product is wgmma m64n128k16 with A and B from shared memory,
//   one [64, 128] f32 accumulator per chunk, four a stage, finished before
//   the stage is handed back; the chunk's bias and activation run in
//   registers and its bf16 values go back to shared memory as the next
//   layer's A.  A stage costs a few hundred cycles beyond its products
//   (the barrier round trips), so the stages are as large as the shared
//   memory beside the two tiles allows: two of 16 KB.  Widths whose
//   activations do not fit (N1 + max(K1, N2) past 768 columns) keep them in
//   a device-memory scratch, one tile per warpgroup ("device memory"
//   route), where each warp loads its A fragments into registers (wgmma
//   with A from registers).
// - The softmax in registers: each row's max and sum from a quad shuffle
//   of layer 3's accumulator (exp as the card's ex2, __expf, a relative
//   error near 1e-6 on a probability); past one chunk (capacity > 128) a
//   first pass keeps a running max and sum and a second recomputes each
//   chunk and writes it.  The probabilities are written once, in 16-byte
//   stores.
//
// Every sum runs in a fixed order, so two launches give the same bits.
//
// Plain C interface, loaded with ctypes from streamz_tpu_torch/nn/
// forward_kernel.py, which builds this file with nvcc at first use.

#include <climits>
#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "hopper.cuh"

namespace {

using namespace streamz_hopper;

constexpr int kRows = 64;                              // rows per tile: one wgmma M
constexpr int kGroups = 2;                             // consumer warpgroups per CTA
constexpr int kWgThreads = 128;
constexpr int kConsumers = kGroups * kWgThreads;
constexpr int kThreads = kConsumers + 32;              // and one producer warp
constexpr int kN = 128;                                // output columns per chunk: one wgmma N
constexpr int kStepElems = kN * 16;                    // one k16 step of a chunk: 4 KB
constexpr int kStageSteps = 4;                         // k16 steps a ring stage holds
constexpr int kStageElems = kStageSteps * kStepElems;  // 16 KB
constexpr int kStages = 2;                             // ring stages
constexpr int kCluster = 2;                            // CTAs sharing each stage (multicast)
constexpr int kKAlign = 16 * kStageSteps;              // a layer's K, padded to whole stages
constexpr int kCoreElems = kRows * 8;                  // one 8-k column of a tile: 1 KB
constexpr float kMaskLogit = -1e30f;                   // streamz_tpu/nn/model.py:MASK_LOGIT
constexpr int kMaxSmem = 232448;                       // 227 KB, the most a Hopper block may have

static_assert(kStageElems % (8 * kCluster) == 0, "a stage splits into 16-byte parts, one a CTA");

// The MLP's widths and their padded forms: layer 1 is [K1, N1], layer 2
// [N1, N2], layer 3 [N2, N3].  A tile keeps A = N1 + max(K1, N2) columns of
// activations: h1, then x (layer 1's input) and later h2 in the same place.
struct Dims {
  int F, H1, H2, cap;
  int K1, N1, N2, N3, A;
};

__host__ __device__ inline int round_up(int v, int m) { return (v + m - 1) / m * m; }

inline Dims make_dims(int F, int H1, int H2, int cap) {
  Dims d;
  d.F = F;
  d.H1 = H1;
  d.H2 = H2;
  d.cap = cap;
  d.K1 = round_up(F, kKAlign);
  d.N1 = round_up(H1, kN);
  d.N2 = round_up(H2, kN);
  d.N3 = round_up(cap, kN);
  d.A = d.N1 + (d.K1 > d.N2 ? d.K1 : d.N2);
  return d;
}

__host__ __device__ inline long long packed_elems(const Dims& d) {
  return static_cast<long long>(d.K1) * d.N1 + static_cast<long long>(d.N1) * d.N2 +
         static_cast<long long>(d.N2) * d.N3;
}

// The ring, first in shared memory (the swizzle needs 256-byte aligned
// stages); the on-chip route's kGroups activation tiles follow it.
struct __align__(1024) Smem {
  bf16 ring[kStages][kStageElems];
  unsigned long long full[kStages];   // a stage's bytes have landed
  unsigned long long empty[kStages];  // every consumer warp of the cluster is done with it
};

inline long long tile_bytes(const Dims& d) { return 2LL * d.A * kRows; }

inline long long on_chip_smem(const Dims& d) {
  return static_cast<long long>(sizeof(Smem)) + kGroups * tile_bytes(d);
}

struct Params {
  const float* x;
  long long R;
  int ns;
  int aligned16;        // x's rows start 16-byte aligned
  int groups;           // tile groups: kCluster x kGroups tiles each
  const float* b1;
  const float* b2;
  const float* b3;
  const bf16* packed;   // the pack kernel's output
  bf16* act;            // device-memory route: one tile's activations per warpgroup
  float* out;
  Dims d;
};

// The pack kernel: one thread per 16 bytes of the packed weights (8 k of
// one column n of one k16 step).
__global__ void pack_weights_kernel(const float* __restrict__ w1, const float* __restrict__ w2,
                                    const float* __restrict__ w3, Dims d,
                                    bf16* __restrict__ packed) {
  const long long u = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  const long long e1 = static_cast<long long>(d.K1) * d.N1;
  const long long e2 = static_cast<long long>(d.N1) * d.N2;
  long long e = u * 8;
  if (e >= packed_elems(d)) return;
  const float* w;
  int K, Kin, Nout;
  if (e < e1) {
    w = w1, K = d.K1, Kin = d.F, Nout = d.H1;
  } else if (e < e1 + e2) {
    e -= e1;
    w = w2, K = d.N1, Kin = d.H1, Nout = d.H2;
  } else {
    e -= e1 + e2;
    w = w3, K = d.N2, Kin = d.H2, Nout = d.cap;
  }
  const long long step = e / kStepElems;  // (chunk, k16 step) in stream order
  const int within = static_cast<int>(e % kStepElems);
  const int nn = within / 16;                          // the column in the chunk
  const int half = ((within / 8) & 1) ^ ((nn >> 2) & 1);  // its 8 k, unswizzled
  const int n = static_cast<int>(step / (K / 16)) * kN + nn;
  const int k0 = static_cast<int>(step % (K / 16)) * 16 + 8 * half;
  uint32_t v[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int k = k0 + 2 * i;
    const float a = n < Nout && k < Kin ? w[static_cast<size_t>(k) * Nout + n] : 0.f;
    const float b = n < Nout && k + 1 < Kin ? w[static_cast<size_t>(k + 1) * Nout + n] : 0.f;
    v[i] = pack_bf16_rn(a, b);
  }
  *reinterpret_cast<uint4*>(packed + u * 8) = make_uint4(v[0], v[1], v[2], v[3]);
}

// The warpgroup's own barrier (the other warpgroup and the producer keep
// running).
__device__ __forceinline__ void group_sync(int wg) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(1 + wg), "n"(kWgThreads) : "memory");
}

__device__ __forceinline__ uint32_t ld32(const bf16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// x's rows row0 .. row0 + 63 into the K1 columns of `tile` as bf16; columns
// past F and rows past R are zero.  Each thread loads 8 values of a row for
// up to kXBatch units before it stores any, so the loads overlap.
constexpr int kXBatch = 4;

__device__ __forceinline__ void load_x(const Params& p, long long row0, int t, bf16* tile) {
  const int F = p.d.F, units = kRows * (p.d.K1 / 8);
  for (int u0 = t; u0 < units; u0 += kXBatch * kWgThreads) {
    float v[kXBatch][8];
#pragma unroll
    for (int b = 0; b < kXBatch; ++b) {
      const int u = u0 + b * kWgThreads;
      const int r = u & (kRows - 1), k0 = 8 * (u / kRows);
      const long long row = row0 + r;
      const float* src = p.x + row * F + k0;
      if (u < units && row < p.R && k0 + 8 <= F && p.aligned16) {
        const float4 a = __ldg(reinterpret_cast<const float4*>(src));
        const float4 c = __ldg(reinterpret_cast<const float4*>(src + 4));
        v[b][0] = a.x, v[b][1] = a.y, v[b][2] = a.z, v[b][3] = a.w;
        v[b][4] = c.x, v[b][5] = c.y, v[b][6] = c.z, v[b][7] = c.w;
      } else {
#pragma unroll
        for (int i = 0; i < 8; ++i)
          v[b][i] = u < units && row < p.R && k0 + i < F ? __ldg(src + i) : 0.f;
      }
    }
#pragma unroll
    for (int b = 0; b < kXBatch; ++b) {
      const int u = u0 + b * kWgThreads;
      if (u >= units) break;
      const int r = u & (kRows - 1), k0 = 8 * (u / kRows);
      *reinterpret_cast<uint4*>(tile + (k0 / 8) * kCoreElems + r * 8) =
          make_uint4(pack_bf16_rn(v[b][0], v[b][1]), pack_bf16_rn(v[b][2], v[b][3]),
                     pack_bf16_rn(v[b][4], v[b][5]), pack_bf16_rn(v[b][6], v[b][7]));
    }
  }
}

// acc = A[64, K] B[K, 128] for one chunk: A, the tile's activations in the
// core-matrix layout; B, the chunk's K / 16 k16 steps, kStageSteps a ring
// stage, in stream order from stage n.  On chip, A is read by the tensor
// cores from shared memory (no swizzle: the two 8-k halves of a step 1 KB
// apart, 8-row groups 128 bytes apart); from device memory, each warp loads
// its A fragments into registers.  Each stage's products finish before the
// stage is handed back (the other warpgroup's keep the tensor cores busy
// meanwhile), so no product is in flight when the accumulator is fenced
// around them (with a stage in flight, a fence makes the compiler serialize
// every wgmma; without the fences the stage takes longer).
template <bool kOnChip>
__device__ __forceinline__ void chunk_product(float (&acc)[64], const bf16* tile, int K,
                                              Smem& s, uint32_t& n, int lane) {
  const int warp = (threadIdx.x % kWgThreads) >> 5;
  // Row 16 warp + g at k 2q of each 8-k column; + 64 elements is row + 8.
  const bf16* a_base = tile + (16 * warp + (lane >> 2)) * 8 + 2 * (lane & 3);
  for (int k0 = 0; k0 < K; k0 += kKAlign, ++n) {
    uint32_t a[kStageSteps][4];
    if constexpr (!kOnChip) {
#pragma unroll
      for (int j = 0; j < kStageSteps; ++j) {
        const bf16* c = a_base + static_cast<size_t>(k0 / 8 + 2 * j) * kCoreElems;
        a[j][0] = ld32(c);
        a[j][1] = ld32(c + 64);
        a[j][2] = ld32(c + kCoreElems);
        a[j][3] = ld32(c + kCoreElems + 64);
      }
    }
    const int st = n % kStages;
    mbar_wait(&s.full[st], (n / kStages) & 1);
    fence_regs<64>(acc);
    wgmma_fence();
#pragma unroll
    for (int j = 0; j < kStageSteps; ++j) {
      const uint64_t db = make_desc(s.ring[st] + j * kStepElems);
      if constexpr (kOnChip) {
        wgmma_m64n128k16_ss(acc, make_desc_plain(tile + (k0 / 8 + 2 * j) * kCoreElems, 1024),
                            db, k0 + j > 0);
      } else {
        wgmma_m64n128k16_rs(acc, a[j], db, k0 + j > 0);
      }
    }
    wgmma_commit();
    fence_regs<64>(acc);
    wgmma_wait<0>();
    fence_regs<64>(acc);
    // Lane c of each warp hands the stage back to CTA c of the cluster.
    if (lane < kCluster) mbar_arrive_cluster(&s.empty[st], lane);
  }
}

enum Act { kRelu, kTanh };

// Chunk c's bias and activation, its bf16 values into columns c * 128 ..
// of `tile` (the next layer's A).  Columns past `width` are zero: their
// weights and bias are.
template <Act ACT>
__device__ __forceinline__ void chunk_to_tile(const float (&acc)[64], const float* bias,
                                              int width, int c, bf16* tile, int warp,
                                              int lane) {
  const int g = lane >> 2, q = lane & 3;
#pragma unroll
  for (int j = 0; j < 16; ++j) {
    const int col = c * kN + 8 * j + 2 * q;  // even, and width % 4 == 0: col + 1 < width too
    const float b0 = col < width ? __ldg(bias + col) : 0.f;
    const float b1 = col < width ? __ldg(bias + col + 1) : 0.f;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      float v0 = acc[4 * j + 2 * h] + b0;
      float v1 = acc[4 * j + 2 * h + 1] + b1;
      if (ACT == kRelu) {
        v0 = fmaxf(v0, 0.f);
        v1 = fmaxf(v1, 0.f);
      } else {
        v0 = tanhf(v0);
        v1 = tanhf(v1);
      }
      const int r = 16 * warp + g + 8 * h;
      *reinterpret_cast<uint32_t*>(tile + (col / 8) * kCoreElems + r * 8 + (col & 7)) =
          pack_bf16_rn(v0, v1);
    }
  }
}

__device__ __forceinline__ float quad_max(float v) {
  v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 1));
  return fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 2));
}

__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  return v + __shfl_xor_sync(0xffffffffu, v, 2);
}

// Layer 3's chunk c into masked logits, in place.
__device__ __forceinline__ void mask_logits(float (&acc)[64], const float* b3, int ns, int c,
                                            int q) {
#pragma unroll
  for (int i = 0; i < 64; ++i) {
    const int col = c * kN + 8 * (i / 4) + 2 * q + (i & 1);
    acc[i] = col < ns ? acc[i] + __ldg(b3 + col) : kMaskLogit;
  }
}

// The running max m and sum se of exp(l - m) of this thread's two rows,
// over one more chunk of masked logits.
__device__ __forceinline__ void softmax_update(const float (&l)[64], float (&m)[2],
                                               float (&se)[2]) {
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    float mx = __int_as_float(0xff800000);  // -inf
#pragma unroll
    for (int j = 0; j < 16; ++j) mx = fmaxf(mx, fmaxf(l[4 * j + 2 * h], l[4 * j + 2 * h + 1]));
    const float mn = fmaxf(m[h], quad_max(mx));
    float sum = 0.f;
#pragma unroll
    for (int j = 0; j < 16; ++j)
      sum += __expf(l[4 * j + 2 * h] - mn) + __expf(l[4 * j + 2 * h + 1] - mn);
    se[h] = se[h] * __expf(m[h] - mn) + quad_sum(sum);
    m[h] = mn;
  }
}

// The whole softmax of a capacity of one chunk, in place: the rows' max,
// e = exp(l - max) and their sum.  Leaves e in l, the sum in se.
__device__ __forceinline__ void softmax_one_chunk(float (&l)[64], float (&se)[2]) {
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    float mx = __int_as_float(0xff800000);  // -inf
#pragma unroll
    for (int j = 0; j < 16; ++j) mx = fmaxf(mx, fmaxf(l[4 * j + 2 * h], l[4 * j + 2 * h + 1]));
    mx = quad_max(mx);
    float sum = 0.f;
#pragma unroll
    for (int j = 0; j < 16; ++j) {
      l[4 * j + 2 * h] = __expf(l[4 * j + 2 * h] - mx);
      l[4 * j + 2 * h + 1] = __expf(l[4 * j + 2 * h + 1] - mx);
      sum += l[4 * j + 2 * h] + l[4 * j + 2 * h + 1];
    }
    se[h] = quad_sum(sum);
  }
}

// Chunk c's probabilities, 0.0 at or past ns, into rows row0 + 16 warp + g
// (+ 8) of the output: e / se, where e is exp(l - m) (computed here from
// the logits l when `from_logits`, else already in l).  Lanes q and q ^ 1
// swap pairs so that each writes four consecutive columns in one 16-byte
// store.
__device__ __forceinline__ void write_probs(float (&l)[64], bool from_logits,
                                            const float (&m)[2], const float (&se)[2],
                                            const Params& p, long long row0, int c, int warp,
                                            int lane) {
  const int g = lane >> 2, q = lane & 3;
  const bool odd = q & 1;
  const float inv[2] = {1.f / se[0], 1.f / se[1]};
#pragma unroll
  for (int i = 0; i < 64; ++i) {
    const int col = c * kN + 8 * (i / 4) + 2 * q + (i & 1);
    const float e = from_logits ? __expf(l[i] - m[(i >> 1) & 1]) : l[i];
    l[i] = col < p.ns ? e * inv[(i >> 1) & 1] : 0.f;
  }
#pragma unroll
  for (int jj = 0; jj < 8; ++jj) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int i0 = 4 * (2 * jj) + 2 * h, i1 = i0 + 4;
      const float r0 = __shfl_xor_sync(0xffffffffu, odd ? l[i0] : l[i1], 1);
      const float r1 = __shfl_xor_sync(0xffffffffu, odd ? l[i0 + 1] : l[i1 + 1], 1);
      const float4 v = odd ? make_float4(r0, r1, l[i1], l[i1 + 1])
                           : make_float4(l[i0], l[i0 + 1], r0, r1);
      const int col = c * kN + 16 * jj + (odd ? 8 + 2 * (q - 1) : 2 * q);
      const long long row = row0 + 16 * warp + g + 8 * h;
      if (row < p.R && col < p.d.cap)
        __stcs(reinterpret_cast<float4*>(p.out + row * p.d.cap + col), v);
    }
  }
}

template <bool kOnChip>
__global__ void __launch_bounds__(kThreads, 1) forward_probs_kernel(Params p) {
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  Smem& s = *reinterpret_cast<Smem*>(smem_raw);
  const Dims& d = p.d;
  const int tid = threadIdx.x;
  const uint32_t rank = kCluster > 1 ? cluster_rank() : 0;
  const int cluster = blockIdx.x / kCluster;
  const int clusters = gridDim.x / kCluster;
  const int passes = d.N3 > kN ? 2 : 1;  // layer 3 twice past one chunk

  if (tid == 0) {
    if (smem_addr(&s) & 255) __trap();  // the swizzle repeats every 256 bytes
    for (int i = 0; i < kStages; ++i) {
      mbar_init(&s.full[i], 1);
      mbar_init(&s.empty[i], (kConsumers / 32) * kCluster);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  // No CTA copies into a peer before the peer's barriers exist.
  cluster_sync();

  if (tid >= kConsumers) {
    // The producer warp: lane 0 streams the packed weights, layer by layer,
    // chunk by chunk, a stage at a time, once per tile group (layer 3
    // `passes` times).  Each CTA copies its part of a stage to all of them.
    if (tid == kConsumers) {
      const bf16* w[3] = {p.packed, p.packed + static_cast<size_t>(d.K1) * d.N1,
                          p.packed + static_cast<size_t>(d.K1) * d.N1 +
                              static_cast<size_t>(d.N1) * d.N2};
      const int K[3] = {d.K1, d.N1, d.N2}, N[3] = {d.N1, d.N2, d.N3};
      constexpr int part = kStageElems / kCluster;
      uint32_t n = 0;
      for (int grp = cluster; grp < p.groups; grp += clusters) {
        for (int L = 0; L < 3; ++L) {
          for (int rep = 0; rep < (L == 2 ? passes : 1); ++rep) {
            const bf16* src = w[L];
            for (int it = 0; it < (N[L] / kN) * (K[L] / kKAlign); ++it, ++n, src += kStageElems) {
              const int st = n % kStages;
              mbar_wait(&s.empty[st], ((n / kStages) & 1) ^ 1);
              mbar_expect_tx(&s.full[st], kStageElems * sizeof(bf16));
              bulk_copy<kCluster>(s.ring[st] + rank * part, src + rank * part,
                                  part * sizeof(bf16), &s.full[st]);
            }
          }
        }
      }
    }
    __syncwarp();
  } else {
    // The consumer warpgroups: each its own tile of every group.
    const int wg = tid / kWgThreads, t = tid % kWgThreads;
    const int warp = t >> 5, lane = t & 31, q = lane & 3;
    bf16* h1;
    if constexpr (kOnChip) {
      h1 = reinterpret_cast<bf16*>(smem_raw + sizeof(Smem)) + static_cast<size_t>(wg) * d.A * kRows;
    } else {
      h1 = p.act + (static_cast<size_t>(blockIdx.x) * kGroups + wg) * d.A * kRows;
    }
    bf16* xh2 = h1 + static_cast<size_t>(d.N1) * kRows;  // x, then h2
    uint32_t n = 0;
    float acc[64];
    for (int grp = cluster; grp < p.groups; grp += clusters) {
      const long long row0 =
          ((static_cast<long long>(grp) * kCluster + rank) * kGroups + wg) * kRows;
      // Each tile written as A is fenced for the tensor cores' reads (on
      // chip) and handed over by the warpgroup's barrier.
      group_sync(wg);  // the previous tile's last reads of h2 are done
      load_x(p, row0, t, xh2);
      fence_proxy_async_shared();
      group_sync(wg);
      for (int c = 0; c < d.N1 / kN; ++c) {
        chunk_product<kOnChip>(acc, xh2, d.K1, s, n, lane);
        chunk_to_tile<kRelu>(acc, p.b1, d.H1, c, h1, warp, lane);
      }
      fence_proxy_async_shared();
      group_sync(wg);  // h1 is written; x is read
      for (int c = 0; c < d.N2 / kN; ++c) {
        chunk_product<kOnChip>(acc, h1, d.N1, s, n, lane);
        chunk_to_tile<kTanh>(acc, p.b2, d.H2, c, xh2, warp, lane);
      }
      fence_proxy_async_shared();
      group_sync(wg);  // h2 is written
      float m[2] = {__int_as_float(0xff800000), __int_as_float(0xff800000)};
      float se[2] = {0.f, 0.f};
      for (int pass = 0; pass < passes; ++pass) {
        for (int c = 0; c < d.N3 / kN; ++c) {
          chunk_product<kOnChip>(acc, xh2, d.N2, s, n, lane);
          mask_logits(acc, p.b3, p.ns, c, q);
          if (passes == 1) {
            softmax_one_chunk(acc, se);
            write_probs(acc, false, m, se, p, row0, c, warp, lane);
          } else if (pass == 0) {
            softmax_update(acc, m, se);
          } else {
            write_probs(acc, true, m, se, p, row0, c, warp, lane);
          }
        }
      }
    }
  }
  // No CTA leaves while a peer may still copy into it or arrive on its
  // barriers.
  cluster_sync();
}

int sm_count() {
  int dev = 0, sms = 0;
  if (cudaGetDevice(&dev) != cudaSuccess) return 0;
  if (cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) != cudaSuccess) return 0;
  return sms;
}

bool valid(int F, int H1, int H2, int cap) {
  return F > 0 && H1 > 0 && H2 > 0 && cap > 0 && F % 4 == 0 && H1 % 4 == 0 && H2 % 4 == 0 &&
         cap % 4 == 0 && F <= (1 << 20) && H1 <= (1 << 20) && H2 <= (1 << 20) &&
         cap <= (1 << 20);
}

// The device-memory route's clusters: one CTA per SM at most.
int device_route_clusters() { return sm_count() / kCluster; }

long long workspace_bytes(const Dims& d) {
  const long long packed = (2 * packed_elems(d) + 1023) / 1024 * 1024;
  if (on_chip_smem(d) <= kMaxSmem) return packed;
  return packed + static_cast<long long>(device_route_clusters()) * kCluster * kGroups *
                      tile_bytes(d);
}

// The clusters of `kernel` that fit on the card at once, by device and
// shared memory (queried once each).
cudaError_t clusters_that_fit(void (*kernel)(Params), cudaLaunchConfig_t cfg, int* fit) {
  struct Entry {
    int dev, smem, fit;
  };
  static Entry cache[32];
  static int used = 0;
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  const int smem = static_cast<int>(cfg.dynamicSmemBytes);
  for (int i = 0; i < used; ++i) {
    if (cache[i].dev == dev && cache[i].smem == smem) {
      *fit = cache[i].fit;
      return cudaSuccess;
    }
  }
  err = cudaOccupancyMaxActiveClusters(fit, kernel, &cfg);
  if (err != cudaSuccess) return err;
  if (*fit < 1) return cudaErrorLaunchOutOfResources;
  if (used < 32) cache[used++] = {dev, smem, *fit};
  return cudaSuccess;
}

}  // namespace

extern "C" {

// Bytes of the scratch that a launch at these widths needs: the packed
// weights, and on the device-memory route the activation tiles.  -1 when
// the widths are not taken (positive multiples of 4).
long long streamz_forward_probs_workspace(int F, int H1, int H2, int cap) {
  if (!valid(F, H1, H2, cap)) return -1;
  return workspace_bytes(make_dims(F, H1, H2, cap));
}

// The route at these widths: 0 "on chip" (the activations in shared
// memory), 1 "device memory"; -1 when the widths are not taken.
int streamz_forward_probs_route(int F, int H1, int H2, int cap) {
  if (!valid(F, H1, H2, cap)) return -1;
  return on_chip_smem(make_dims(F, H1, H2, cap)) <= kMaxSmem ? 0 : 1;
}

// Shared memory one block asks for at these widths, in bytes.
int streamz_forward_probs_smem(int F, int H1, int H2, int cap) {
  if (!valid(F, H1, H2, cap)) return -1;
  const Dims d = make_dims(F, H1, H2, cap);
  return static_cast<int>(on_chip_smem(d) <= kMaxSmem ? on_chip_smem(d) : sizeof(Smem));
}

// Elements (bf16) of the packed weights at these widths.
long long streamz_forward_probs_packed_elems(int F, int H1, int H2, int cap) {
  if (!valid(F, H1, H2, cap)) return -1;
  return packed_elems(make_dims(F, H1, H2, cap));
}

// The pack kernel alone on `stream`: w1 [F, H1], w2 [H1, H2], w3 [H2, cap]
// f32 into `packed` (packed_elems bf16).  Returns the CUDA error.
int streamz_forward_probs_pack(const float* w1, const float* w2, const float* w3, int F, int H1,
                               int H2, int cap, bf16* packed, void* stream) {
  if (!valid(F, H1, H2, cap)) return static_cast<int>(cudaErrorInvalidValue);
  const Dims d = make_dims(F, H1, H2, cap);
  const long long units = packed_elems(d) / 8;
  const long long blocks = (units + 255) / 256;
  if (blocks > INT_MAX) return static_cast<int>(cudaErrorInvalidValue);
  pack_weights_kernel<<<static_cast<unsigned>(blocks), 256, 0, static_cast<cudaStream_t>(stream)>>>(
      w1, w2, w3, d, packed);
  return static_cast<int>(cudaGetLastError());
}

// Launch K7 on `stream`: the pack kernel, then the forward.  x: [R, F] f32
// contiguous; w1 [F, H1], b1 [H1], w2 [H1, H2], b2 [H2], w3 [H2, cap], b3
// [cap] f32; work: workspace_bytes of scratch, 16-byte aligned; out: [R, cap]
// f32.  F, H1, H2 and cap are multiples of 4, 0 <= ns <= cap.  Returns the
// CUDA error of the launches (0 on success); it does not synchronise.
int streamz_forward_probs(const float* x, long long R, int F, int ns, const float* w1,
                          const float* b1, const float* w2, const float* b2, const float* w3,
                          const float* b3, int H1, int H2, int cap, void* work,
                          long long work_bytes, float* out, void* stream) {
  if (R <= 0 || !valid(F, H1, H2, cap) || ns < 0 || ns > cap ||
      (reinterpret_cast<std::uintptr_t>(work) & 15))
    return static_cast<int>(cudaErrorInvalidValue);
  const Dims d = make_dims(F, H1, H2, cap);
  if (work_bytes < workspace_bytes(d)) return static_cast<int>(cudaErrorInvalidValue);
  const long long tiles = (R + kRows - 1) / kRows;
  const long long groups = (tiles + kCluster * kGroups - 1) / (kCluster * kGroups);
  if (groups > INT_MAX / kCluster) return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  bf16* packed = static_cast<bf16*>(work);
  int err = streamz_forward_probs_pack(w1, w2, w3, F, H1, H2, cap, packed, stream);
  if (err != 0) return err;

  Params p = {};
  p.x = x;
  p.R = R;
  p.ns = ns;
  p.aligned16 = (reinterpret_cast<std::uintptr_t>(x) & 15) == 0;
  p.groups = static_cast<int>(groups);
  p.b1 = b1;
  p.b2 = b2;
  p.b3 = b3;
  p.packed = packed;
  p.out = out;
  p.d = d;
  const bool on_chip = on_chip_smem(d) <= kMaxSmem;
  void (*kernel)(Params) = on_chip ? forward_probs_kernel<true> : forward_probs_kernel<false>;
  const int smem = static_cast<int>(on_chip ? on_chip_smem(d) : sizeof(Smem));
  cudaError_t e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = kCluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(kCluster);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = st;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  int fit = 0;
  if (on_chip) {
    e = clusters_that_fit(kernel, cfg, &fit);
    if (e != cudaSuccess) return static_cast<int>(e);
  } else {
    fit = device_route_clusters();
    if (fit < 1) return static_cast<int>(cudaErrorInvalidDevice);
    p.act = reinterpret_cast<bf16*>(static_cast<char*>(work) +
                                    (2 * packed_elems(d) + 1023) / 1024 * 1024);
  }
  cfg.gridDim = dim3(static_cast<unsigned>(kCluster * (groups < fit ? groups : fit)));
  e = cudaLaunchKernelEx(&cfg, kernel, p);
  if (e != cudaSuccess) return static_cast<int>(e);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
