// The bf16x3 tensor-core MFCC base tile of every MFCC kernel, written for
// Hopper (sm_90a), in four forms (Form below): K3 (mfcc_v2.cu, mel in f32),
// K2 (mfcc_v3.cu, mel in bf16x3 too), K1 (mfcc_base.cu, K2 with the tail
// bins' squares split) and K4 (mfcc_frames.cu, the frame-major form).
//
// K1, K2 and K3 compute the block-parity form: each 400-sample block row r
// of the flattened [B * nb, 400] view is projected once onto the one-sided
// cos and -sin basis, and window t = block t || block t+1 is
//
//   re = proj_c[t] + (-1)^k proj_c[t+1]   (im likewise), power = re^2 + im^2,
//   mel = power @ fb^T, base = DCT-II_20( log(max(mel, 1e-12)) ).
//
// K4 computes each window as one 800-tap product, accumulated once over the
// taps of block t (basis rows 0..399) and of block t+1 (rows 400..799):
// re = sum_n frame[n] cos(2 pi k n / 800), im likewise with -sin, and the
// power, mel, log and DCT as above.
//
// The DFT runs on the tensor cores in bf16x3, which is what the TPU kernels
// compute: x = x_hi + x_lo and d = d_hi + d_lo in bf16 (lo = bf16(a - hi),
// both rounded to nearest even), and proj = x_hi d_hi + x_hi d_lo + x_lo d_hi,
// the three products accumulated in f32 into one register accumulator.  Two
// products (bf16x2) missed the 1e-3 feature gate on the TPU.
//
// What bounds it: 3 x 2 x 400 x 896 bf16 operations per block row (twice
// that per window for K4) against 1.6 KB of PCM, far above the card's bf16
// ridge, so the tensor cores; and the basis, 1.43 MB of hi/lo planes (2.87
// MB for K4) that every tile of rows reads through L2.  The design:
//
// - A tile is kRows = 64 block rows (63 windows; the last row is the halo),
//   one wgmma M.  Each CTA is persistent and walks the tiles of its cluster
//   with three roles.  A splitter warpgroup writes a tile's PCM once as
//   bf16 hi/lo planes into shared memory (read in place, no pad copy,
//   16-byte loads when every row is 16-byte aligned, else 4-byte ones), in
//   the layout that wgmma reads, each stage's k columns as soon as the
//   previous tile's last strip has read them; then it writes the previous
//   tile's windows (below).  The producer warp has each next tile's PCM
//   prefetched into L2 and keeps the ring below filled.  The consumer
//   warpgroup runs the products, the combine and the mel stage.
// - The basis streams through a ring of kStages shared-memory stages of
//   kStageSteps k16 steps of one strip (7 strips of 64 bins: cos | -sin, 128
//   columns), 8 KB of hi and lo planes a step that the host lays out once,
//   in the order and the swizzled layout that wgmma reads
//   (kernel_constants()'s "basis_tc", K4's "frame_basis_tc"), so one bulk
//   async copy (cp.async.bulk, mbarrier complete_tx) fills a stage.  A
//   cluster of kCluster CTAs on neighbouring row tiles shares each stage:
//   every CTA copies its share of the stage and multicasts it to all of
//   them, so one L2 read serves kCluster tiles (clusters of four were slower
//   for K2 and K4).
// - Per step the consumer warpgroup issues three wgmma m64n128k16 (hi hi,
//   hi lo, lo hi) into one accumulator of 64 f32 registers a thread, and
//   keeps one stage's products in flight while it issues the next stage's.
//   K4's A reuses each tile row for the two windows that hold it: steps
//   0..24 read the planes at rows 0..63, steps 25..49 the same planes one
//   row on (rows 1..64, row 64 zero), through a descriptor that starts 16
//   bytes later in K4's unswizzled layout, where the rows of an 8-k column
//   lie 16 bytes apart.
// - The combine and the power stay in registers: a thread holds rows g and
//   g + 8 of its warp's 16 (g = lane / 4); row t + 1 is four lanes on
//   (__shfl_sync), and each warp's last row reads the next warp's first row
//   through shared memory.  K4 has no combine: power = re^2 + im^2.
// - The mel stage, per strip:
//     bf16x3 on the tensor cores (K2, K1): wgmma m64n32k16 with the power's
//       hi and lo planes as A straight from the registers (the accumulator
//       layout is the A fragment's), and the strip's [64 bins, 32] mel
//       planes as B, streamed through the ring as one more stage; the
//       [64, 32] mel accumulator stays in registers across the strips.  K1
//       takes the TPU kernel's tail: in strip 6 (bins 384..447) A is
//       [re^2 planes | im^2 planes], K = 128, against the strip's mel rows
//       stacked twice, which are the same four k16 blocks of the stage read
//       twice; the squares are split into bf16 before they are summed.
//     f32 (K3, K4): sparse over each filter's bin range on the CUDA cores,
//       from the power in shared memory (the weights there too); each
//       (window, mel) pair has one owner thread for the whole tile, so no
//       atomics.
// - After the last strip the consumers write log(max(., 1e-12)) of the mel
//   energies to shared memory; the splitters run the [26 -> 20] DCT in f32
//   and write only the valid windows (the window that straddles two clips
//   is dropped) while the consumers start the next tile.
//
// Every sum runs in a fixed order, so two launches give the same bits.  The
// Hopper primitives (descriptors, mbarriers, bulk copies, wgmma) are
// hopper.cuh's.

#pragma once

#include <climits>
#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "hopper.cuh"

namespace streamz_tc {

using namespace streamz_hopper;
using bf16 = streamz_hopper::bf16;

constexpr int kBlock = 400;             // samples per block = the block DFT's K (25 x 16)
constexpr int kRows = 64;               // block rows per tile: one wgmma M
constexpr int kWins = kRows - 1;        // windows per tile; the last row is the halo
constexpr int kStrips = 7;              // 7 * 64 = 448 >= 401 bins
constexpr int kStripBins = 64;
constexpr int kStripCols = 2 * kStripBins;        // cos 64 | sin 64
constexpr int kSteps = kBlock / 16;     // k16 steps of one block row
constexpr int kMelCols = 32;            // 26 mels padded to a wgmma N of 32
constexpr int kMels = 26;
constexpr int kCoefs = 20;
constexpr int kStepElems = 2 * kStripCols * 16;  // one k16 step's hi and lo planes: 8 KB
constexpr int kStageSteps = 5;          // k16 steps a ring stage holds: 40 KB
constexpr int kStageElems = kStageSteps * kStepElems;
constexpr int kStages = 2;              // ring stages
constexpr int kSplitItems = kSteps / kStageSteps;  // stage-sized column groups of the planes
constexpr int kCluster = 2;             // CTAs sharing each basis stage (multicast)
constexpr int kConsumers = 128;         // one warpgroup: products, combine, mel
constexpr int kSplitters = 128;         // one warpgroup: PCM planes, DCT and stores
constexpr int kThreads = kConsumers + kSplitters + 32;  // and one producer warp
constexpr int kKCores = kBlock / 8;     // 50 core matrices of 8 k along a PCM row
constexpr int kPwld = kStripBins + 1;   // f32 row stride of the power (K3, K4)
constexpr int kMlld = kMelCols + 1;     // f32 row stride of the log mel energies
constexpr int kMaxMelWeights = 1024;    // the sparse mel weights held in shared memory

static_assert(kBlock % 16 == 0 && kSteps % kStageSteps == 0, "whole k16 steps, whole stages");
static_assert(2 * kMelCols * kStripBins == kStepElems, "a strip's mel planes fill one step");
static_assert(kConsumers == 2 * kRows && kMels % 2 == 0, "sparse mel: a row and every other mel a thread");
static_assert(kStepElems % (8 * kCluster) == 0, "a stage splits into 16-byte parts, one a CTA");

// The kernels of the tile.
enum class Form {
  kV2,      // K3: block parity, mel sparse in f32
  kV3,      // K2: block parity, mel in bf16x3 on the tensor cores
  kV4,      // K1: K2 with the tail bins' squares split before the mel
  kFrames,  // K4: 800-tap frames, no combine, mel sparse in f32
};

template <Form F>
struct Traits {
  static constexpr bool kMelTc = F == Form::kV3 || F == Form::kV4;
  static constexpr bool kTailFold = F == Form::kV4;
  static constexpr bool kFrames = F == Form::kFrames;
  static constexpr int kDftSteps = kFrames ? 2 * kSteps : kSteps;  // k16 steps a strip
  static constexpr int kDftItems = kDftSteps / kStageSteps;        // DFT stages a strip
  static constexpr int kItems = kDftItems + (kMelTc ? 1 : 0);      // ring stages a strip
  // The DFT stage after which the last strip has read a column group for
  // the last time is group + kAReuse (K4 reads each group twice).
  static constexpr int kAReuse = kDftItems - kSplitItems;
  static constexpr int kARows = kFrames ? kRows + 1 : kRows;  // plane rows (K4: a zero row 64)
};

// Shared memory, about 220 KB.  The PCM planes hold wgmma's A operand as
// K-major core matrices of 8 rows x 8 k (16 bytes a row).  K1-K3: blocks of
// 16 k in the 32-byte swizzle: row n of a block is 32 bytes at 32 n, its
// two 16-byte halves swapped when n / 4 is odd, and each block starts on 256
// bytes; k16 step j's 64 rows at j * 2 KB.  K4: no swizzle; core column c
// (k = 8 c .. 8 c + 7) holds its 65 rows at 16 bytes each from c * 1040 B.
// Each ring stage holds B in the 32-byte swizzle: step j of the stage at
// j * 8 KB, its plane p (hi, lo) at + p * 4 KB, the strip's 128 columns; or
// mel (K2, K1): k16 step i of the strip's 64 bins at i * 1 KB + p * 4 KB, 32
// mels each.
template <Form F>
struct __align__(256) Smem {
  static constexpr int kPlane = kKCores * Traits<F>::kARows * 8;  // bf16 a plane
  bf16 xhi[kPlane];
  bf16 xlo[kPlane];
  alignas(256) bf16 ring[kStages][kStageElems];
  float xrow[2][4][kStripCols];  // each warp's first projection row, by strip parity
  float pw[kRows][kPwld];        // one strip's power (K3, K4)
  float ml[kRows][kMlld];        // the tile's log mel energies
  float dct[kCoefs][kMels];
  unsigned long long full[kStages];   // a stage's bytes have landed
  unsigned long long empty[kStages];  // every CTA's consumers are done with it
  unsigned long long a_full;          // the splitters have written the tile's planes
  unsigned long long a_free[kSplitItems];  // the last strip's products have read a column group
  unsigned long long ml_full;         // the consumers have written the tile's log mel
  unsigned long long ml_free;         // the splitters have written its windows
  int mlo[kMels], mhi[kMels], moff[kMels];
  float fbw[kMaxMelWeights];  // the sparse mel weights (K3, K4)
};

struct Params {
  const float* pcm;
  long long rows, T, nb;  // rows = B * nb block rows
  int aligned16;          // every row starts 16-byte aligned
  int tiles;
  const bf16* basis;      // [7 strips][kDftSteps][kStepElems]: "basis_tc" or "frame_basis_tc"
  const bf16* melw;       // [7 strips][kStepElems]: "mel_tc" (K2, K1)
  const float* fbw;       // the sparse f32 mel weights (K3, K4)
  const int* mel_lo;
  const int* mel_hi;
  const int* mel_off;
  const float* dct;       // [20, 26]
  float* out;             // [B, nb - 1, 20]
};

// The consumer warpgroup's own barrier (the producer warp keeps running).
__device__ __forceinline__ void consumers_sync() {
  asm volatile("bar.sync 1, %0;\n" ::"n"(kConsumers) : "memory");
}

// The tile's PCM in L2 ahead of its split: one prefetch per 128-byte line
// of each valid row, by the 32 lanes of the producer warp.
__device__ __forceinline__ void prefetch_tile(const Params& p, long long tile, int lane) {
  for (int r = lane; r < kRows; r += 32) {
    const long long row = tile * kWins + r;
    if (row >= p.rows) break;
    const float* a = p.pcm + (row / p.nb) * p.T + (row % p.nb) * kBlock;
#pragma unroll
    for (int c = 0; c < kBlock; c += 32) asm volatile("prefetch.global.L2 [%0];\n" ::"l"(a + c));
    asm volatile("prefetch.global.L2 [%0];\n" ::"l"(a + kBlock - 1));
  }
}

// The splitters' share of a tile's PCM: splitter i owns row i % 64 and
// every other core column of 8 k, a ring stage's columns (steps
// it * kStageSteps ..) at a time; rows past the batch read as zero.
struct SplitRow {
  const float* src;  // the row's 400 samples, or null past the batch
  int r, k0;         // the row in the tile, the first core column

  __device__ __forceinline__ SplitRow(const Params& p, long long r0, int tid)
      : r(tid & (kRows - 1)), k0(tid / kRows) {
    static_assert(kSplitters == 2 * kRows, "two splitters a row");
    const long long row = r0 + r;
    src = row < p.rows ? p.pcm + (row / p.nb) * p.T + (row % p.nb) * kBlock : nullptr;
  }

  // Load stage it's kStageSteps core columns of the row into v.
  __device__ __forceinline__ void load(const Params& p, int it, float (&v)[kStageSteps][8]) const {
#pragma unroll
    for (int j = 0; j < kStageSteps; ++j) {
      if (src == nullptr) {
#pragma unroll
        for (int i = 0; i < 8; ++i) v[j][i] = 0.f;
        continue;
      }
      const float* a = src + 8 * (k0 + 2 * (it * kStageSteps + j));
      if (p.aligned16) {
        const float4 x = __ldg(reinterpret_cast<const float4*>(a));
        const float4 y = __ldg(reinterpret_cast<const float4*>(a + 4));
        v[j][0] = x.x; v[j][1] = x.y; v[j][2] = x.z; v[j][3] = x.w;
        v[j][4] = y.x; v[j][5] = y.y; v[j][6] = y.z; v[j][7] = y.w;
      } else {
#pragma unroll
        for (int i = 0; i < 8; ++i) v[j][i] = __ldg(a + i);
      }
    }
  }

  // Split v into the hi and lo planes: K1-K3 at k16 step k8 / 2, row r,
  // 16-byte half (k8 % 2) ^ (r / 4 % 2); K4 at core column k8, row r.
  template <Form F>
  __device__ __forceinline__ void store(int it, const float (&v)[kStageSteps][8],
                                        Smem<F>& s) const {
    uint4* hi = reinterpret_cast<uint4*>(s.xhi);
    uint4* lo = reinterpret_cast<uint4*>(s.xlo);
#pragma unroll
    for (int j = 0; j < kStageSteps; ++j) {
      uint32_t h[4], l[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) h[i] = pack_bf16(v[j][2 * i], v[j][2 * i + 1], &l[i]);
      const int k8 = k0 + 2 * (it * kStageSteps + j);
      const int at = Traits<F>::kFrames
                         ? k8 * Traits<F>::kARows + r
                         : (k8 >> 1) * 2 * kRows + 2 * r + ((k8 & 1) ^ ((r >> 2) & 1));
      hi[at] = make_uint4(h[0], h[1], h[2], h[3]);
      lo[at] = make_uint4(l[0], l[1], l[2], l[3]);
    }
  }
};

// The [26 -> 20] DCT of the tile's log mel energies (s.ml), written for its
// valid windows only: a window is valid when its block and the next are in
// the same clip (the window that straddles two clips is dropped) and inside
// the batch.
template <Form F>
__device__ __forceinline__ void write_windows(const Params& p, long long r0, int tid,
                                              int nthreads, const Smem<F>& s) {
  const long long nwin = p.nb - 1;
  const long long clip0 = r0 / p.nb, t0 = r0 - clip0 * p.nb;
  for (int o = tid; o < kWins * kCoefs; o += nthreads) {
    const int w = o / kCoefs;
    const int c = o - w * kCoefs;
    if (r0 + w >= p.rows) break;
    long long clip = clip0, t = t0 + w;  // block row r0 + w is block t of clip
    while (t >= p.nb) {
      t -= p.nb;
      ++clip;
    }
    if (t >= nwin) continue;
    float sum = 0.f;
#pragma unroll
    for (int m = 0; m < kMels; ++m) sum = fmaf(s.ml[w][m], s.dct[c][m], sum);
    p.out[(clip * nwin + t) * kCoefs + c] = sum;
  }
}

// Hand a ring stage back: every CTA of the cluster may refill it once all
// their consumer warps are done with it.  Lane c of each warp signals CTA c.
template <Form F>
__device__ __forceinline__ void release(Smem<F>& s, int stage, int lane) {
  if (lane < kCluster) mbar_arrive_cluster(&s.empty[stage], lane);
}

// The parity combine and the power of one strip's [64, 128] projection, in
// registers: pw = re^2 + im^2 (mode 0), re^2 (mode 1) or im^2 (mode 2).
// Bin parity is column parity (64 * strip is even).  Row t + 1 of row g is
// lane + 4's row g + 1, of g = 7 lane q's row 8; of row g + 8, lane + 4's
// row g + 9, of 15 the next warp's row 0, from `xrow` (zero past the tile:
// row 63 is the halo, its window is not written).
__device__ __forceinline__ void combine_power(const float (&acc)[64],
                                              const float (*xrow)[kStripCols], int warp,
                                              int lane, int mode, float (&pw)[32]) {
  const int g = lane >> 2, q = lane & 3;
  const int src_lane = (lane + 4) & 31;
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    float cu[4], su[4];
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      cu[e] = __shfl_sync(0xffffffffu, acc[4 * j + e], src_lane);
      su[e] = __shfl_sync(0xffffffffu, acc[4 * (j + 8) + e], src_lane);
    }
    const int col = 8 * j + 2 * q;
    float xc[2] = {0.f, 0.f}, xs[2] = {0.f, 0.f};
    if (g == 7 && warp < 3) {
      xc[0] = xrow[warp + 1][col];
      xc[1] = xrow[warp + 1][col + 1];
      xs[0] = xrow[warp + 1][kStripBins + col];
      xs[1] = xrow[warp + 1][kStripBins + col + 1];
    }
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float cn = g < 7 ? cu[e] : (e < 2 ? cu[e + 2] : xc[e - 2]);
      const float sn = g < 7 ? su[e] : (e < 2 ? su[e + 2] : xs[e - 2]);
      const float sg = (e & 1) ? -1.f : 1.f;
      const float re = acc[4 * j + e] + sg * cn;
      const float im = acc[4 * (j + 8) + e] + sg * sn;
      pw[4 * j + e] = mode == 0 ? re * re + im * im : mode == 1 ? re * re : im * im;
    }
  }
}

// One strip's share of the mel energies in bf16x3 (K2, K1): the power p's
// hi and lo planes as A fragments (k16 block i is columns j = 2i, 2i + 1),
// the strip's mel planes in ring stage `stage` as B.  Waits for the products.
template <Form F>
__device__ __forceinline__ void mel_products(float* mel, const float (&pw)[32],
                                             const Smem<F>& s, int stage) {
  uint32_t ahi[4][4], alo[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int f = 0; f < 4; ++f) {
      const int j = 2 * i + (f >> 1), e = (f & 1) * 2;
      ahi[i][f] = pack_bf16(pw[4 * j + e], pw[4 * j + e + 1], &alo[i][f]);
    }
  fence_regs<16>(mel);
  wgmma_fence();
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const uint64_t mhi = make_desc(s.ring[stage] + i * 16 * kMelCols);
    const uint64_t mlo = make_desc(s.ring[stage] + kStepElems / 2 + i * 16 * kMelCols);
    wgmma_m64n32k16_rs(mel, ahi[i], mhi, 1);
    wgmma_m64n32k16_rs(mel, ahi[i], mlo, 1);
    wgmma_m64n32k16_rs(mel, alo[i], mhi, 1);
  }
  wgmma_commit();
  wgmma_wait<0>();
  fence_regs<16>(mel);
}

// The whole kernel: each source's __global__ calls it with its dynamic
// shared memory, kThreads threads a block, clusters of kCluster blocks.
template <Form F>
__device__ __forceinline__ void mfcc_tc_tile(const Params& p, Smem<F>& s) {
  using T = Traits<F>;
  const int tid = threadIdx.x;
  const uint32_t rank = kCluster > 1 ? cluster_rank() : 0;
  const int cluster = blockIdx.x / kCluster;
  const int clusters = gridDim.x / kCluster;
  const int groups = (p.tiles + kCluster - 1) / kCluster;  // tiles of a cluster, together

  if (tid == 0) {
    if (smem_addr(&s) & 255) __trap();  // the swizzle repeats every 256 bytes
    for (int i = 0; i < kStages; ++i) {
      mbar_init(&s.full[i], 1);
      mbar_init(&s.empty[i], 4 * kCluster);
    }
    mbar_init(&s.a_full, kSplitters);
    for (int i = 0; i < kSplitItems; ++i) mbar_init(&s.a_free[i], kConsumers);
    mbar_init(&s.ml_full, kConsumers);
    mbar_init(&s.ml_free, kSplitters);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  for (int i = tid; i < kCoefs * kMels; i += kThreads) (&s.dct[0][0])[i] = p.dct[i];
  if constexpr (!T::kMelTc) {
    if (tid < kMels) {
      s.mlo[tid] = p.mel_lo[tid];
      s.mhi[tid] = p.mel_hi[tid];
      s.moff[tid] = p.mel_off[tid];
    }
    const int nw = p.mel_off[kMels - 1] + p.mel_hi[kMels - 1] - p.mel_lo[kMels - 1];
    if (nw > kMaxMelWeights) __trap();  // the host's filterbank outgrew the kernel
    for (int i = tid; i < nw; i += kThreads) s.fbw[i] = p.fbw[i];
  }
  // No CTA copies into a peer before the peer's barriers exist.
  cluster_sync();

  if (tid >= kConsumers && tid < kConsumers + kSplitters) {
    // The splitter warpgroup: each tile's PCM planes, a stage's k columns
    // as soon as the previous tile's last strip has read them, so the split
    // overlaps that strip; then the previous tile's DCT and stores, which
    // overlap this tile's products.
    const int t = tid - kConsumers;
    if constexpr (T::kFrames) {
      // Row 64, which only the dropped window 63 reads, stays zero.
      if (t < kKCores) {
        reinterpret_cast<uint4*>(s.xhi)[t * T::kARows + kRows] = make_uint4(0, 0, 0, 0);
        reinterpret_cast<uint4*>(s.xlo)[t * T::kARows + kRows] = make_uint4(0, 0, 0, 0);
      }
    }
    uint32_t k = 0;  // tiles split
    long long prev_r0 = 0;
    for (int grp = cluster; grp < groups; grp += clusters, ++k) {
      const long long r0 = (static_cast<long long>(grp) * kCluster + rank) * kWins;
      // Each stage's samples are loaded a stage ahead, before its columns
      // are free.
      const SplitRow row(p, r0, t);
      float v[2][kStageSteps][8];
      row.load(p, 0, v[0]);
#pragma unroll
      for (int it = 0; it < kSplitItems; ++it) {
        if (it + 1 < kSplitItems) row.load(p, it + 1, v[(it + 1) & 1]);
        if (k > 0) mbar_wait(&s.a_free[it], (k - 1) & 1);
        row.store(it, v[it & 1], s);
      }
      fence_proxy_async_shared();
      mbar_arrive(&s.a_full);
      if (k > 0) {
        mbar_wait(&s.ml_full, (k - 1) & 1);
        write_windows(p, prev_r0, t, kSplitters, s);
        mbar_arrive(&s.ml_free);
      }
      prev_r0 = r0;
    }
    if (k > 0) {
      mbar_wait(&s.ml_full, (k - 1) & 1);
      write_windows(p, prev_r0, t, kSplitters, s);
    }
  } else if (tid >= kConsumers) {
    // The producer warp: the L2 prefetch of each next tile by all lanes,
    // the ring by lane 0.  Every CTA of the cluster walks the same stages.
    const int lane = tid - kConsumers - kSplitters;
    if (cluster < groups) prefetch_tile(p, static_cast<long long>(cluster) * kCluster + rank, lane);
    uint32_t n = 0;
    for (int grp = cluster; grp < groups; grp += clusters) {
      const long long next = static_cast<long long>(grp + clusters) * kCluster + rank;
      if (next < p.tiles) prefetch_tile(p, next, lane);
      if (lane == 0) {
        for (int strip = 0; strip < kStrips; ++strip) {
          for (int it = 0; it < T::kItems; ++it, ++n) {
            const int st = n % kStages;
            mbar_wait(&s.empty[st], ((n / kStages) & 1) ^ 1);
            // kStageSteps k16 steps of the strip, or its mel planes.
            const bool dft = it < T::kDftItems;
            const int elems = dft ? kStageElems : kStepElems;
            mbar_expect_tx(&s.full[st], elems * sizeof(bf16));
            const bf16* src =
                dft ? p.basis +
                          (static_cast<size_t>(strip) * T::kDftSteps + it * kStageSteps) *
                              kStepElems
                    : p.melw + static_cast<size_t>(strip) * kStepElems;
            const int part = elems / kCluster;
            bulk_copy<kCluster>(s.ring[st] + rank * part, src + rank * part, part * sizeof(bf16),
                      &s.full[st]);
          }
        }
      }
      __syncwarp();
    }
  } else {
    // The consumer warpgroup.  Thread (warp, g = lane / 4, q = lane % 4)
    // holds, of a [64, N] accumulator, rows 16 warp + g and + 8 at columns
    // 8 j + 2 q and + 1: element 4 j + e is row + 8 (e / 2), column + e % 2.
    const int warp = tid >> 5, lane = tid & 31, g = lane >> 2, q = lane & 3;
    uint32_t n = 0;
    uint32_t k = 0;  // tiles done
    int parity = 0;  // the xrow buffer, by strip
    float acc[64];   // one strip's [64, 128] projection
#pragma unroll
    for (int i = 0; i < 64; ++i) acc[i] = 0.f;
    for (int grp = cluster; grp < groups; grp += clusters, ++k) {
      mbar_wait(&s.a_full, k & 1);  // the tile's planes are written
      float mel[16];                         // K2, K1: the tile's [64, 32] mel energies
      float ml3[kRows * kMels / kConsumers];  // K3, K4: this thread's (window, mel) sums
#pragma unroll
      for (int i = 0; i < 16; ++i) mel[i] = 0.f;
#pragma unroll
      for (int i = 0; i < kRows * kMels / kConsumers; ++i) ml3[i] = 0.f;

      for (int strip = 0; strip < kStrips; ++strip) {
        const bool last = strip == kStrips - 1;
        // The strip's [64, 128] projection: kDftSteps k16 steps of three
        // bf16 products, kStageSteps from each ring stage, the previous
        // stage's products in flight while the next stage's are issued.
        // After the last strip's final read of a column group, its planes
        // may take the next tile's samples.
        int prev = 0;
        for (int it = 0; it < T::kDftItems; ++it, ++n) {
          const int st = n % kStages;
          mbar_wait(&s.full[st], (n / kStages) & 1);
          fence_regs<64>(acc);
          wgmma_fence();
#pragma unroll
          for (int j = 0; j < kStageSteps; ++j) {
            const int ks = it * kStageSteps + j;
            const uint64_t bhi = make_desc(s.ring[st] + j * kStepElems);
            const uint64_t blo = make_desc(s.ring[st] + j * kStepElems + kStepElems / 2);
            uint64_t ahi, alo;
            if constexpr (T::kFrames) {
              // Taps 400..799 (steps 25..49) are block t + 1's: rows 1..64.
              const int half = ks >= kSteps;
              const int at = (ks - half * kSteps) * 2 * T::kARows * 8 + half * 8;
              ahi = make_desc_plain(s.xhi + at, T::kARows * 16);
              alo = make_desc_plain(s.xlo + at, T::kARows * 16);
            } else {
              ahi = make_desc(s.xhi + ks * 16 * kRows);
              alo = make_desc(s.xlo + ks * 16 * kRows);
            }
            wgmma_m64n128k16_ss(acc, ahi, bhi, ks > 0);
            wgmma_m64n128k16_ss(acc, ahi, blo, 1);
            wgmma_m64n128k16_ss(acc, alo, bhi, 1);
          }
          wgmma_commit();
          fence_regs<64>(acc);
          if (it > 0) {
            wgmma_wait<1>();
            release(s, prev, lane);
            if (last && it - 1 >= T::kAReuse) mbar_arrive(&s.a_free[it - 1 - T::kAReuse]);
          }
          prev = st;
        }
        wgmma_wait<0>();
        fence_regs<64>(acc);
        release(s, prev, lane);
        if (last) mbar_arrive(&s.a_free[kSplitItems - 1]);

        // The power in registers; for the block-parity forms after the
        // parity combine, each warp's first row published for the warp above
        // it.  K1's strip 6 takes re^2 first and im^2 after (below).
        float pw[32];
        const float(*xrow)[kStripCols] = s.xrow[parity];
        if constexpr (T::kFrames) {
#pragma unroll
          for (int i = 0; i < 32; ++i) pw[i] = acc[i] * acc[i] + acc[32 + i] * acc[32 + i];
        } else {
          float(*row0)[kStripCols] = s.xrow[parity];
          parity ^= 1;
          if (g == 0) {
#pragma unroll
            for (int j = 0; j < 16; ++j) {
              row0[warp][8 * j + 2 * q] = acc[4 * j];
              row0[warp][8 * j + 2 * q + 1] = acc[4 * j + 1];
            }
          }
          consumers_sync();
          combine_power(acc, xrow, warp, lane, T::kTailFold && last ? 1 : 0, pw);
        }

        if constexpr (T::kMelTc) {
          // The strip's mel planes arrive as one more ring stage; K1's strip
          // 6 reads them twice, under the re^2 and the im^2 planes.
          const int st = n % kStages;
          mbar_wait(&s.full[st], (n / kStages) & 1);
          ++n;
          mel_products(mel, pw, s, st);
          if constexpr (T::kTailFold) {
            if (last) {
              combine_power(acc, xrow, warp, lane, 2, pw);
              mel_products(mel, pw, s, st);
            }
          }
          release(s, st, lane);
        } else {
          // Sparse f32 mel over each filter's bin range, from shared memory:
          // thread t owns row t % 64 and the mels of parity t / 64, so a
          // warp's lanes walk one filter's bins together.
#pragma unroll
          for (int j = 0; j < 8; ++j)
#pragma unroll
            for (int e = 0; e < 4; ++e)
              s.pw[16 * warp + g + 8 * (e >> 1)][8 * j + 2 * q + (e & 1)] = pw[4 * j + e];
          consumers_sync();
          const int gb0 = strip * kStripBins;
#pragma unroll
          for (int i = 0; i < kRows * kMels / kConsumers; ++i) {
            const int w = tid & (kRows - 1);  // a warp: one mel, 32 rows
            const int m = 2 * i + tid / kRows;
            const int lo = max(s.mlo[m], gb0);
            const int hi = min(s.mhi[m], gb0 + kStripBins);
            const float* wt = s.fbw + s.moff[m] - s.mlo[m];
            float sum = 0.f;
            for (int bin = lo; bin < hi; ++bin) sum = fmaf(s.pw[w][bin - gb0], wt[bin], sum);
            ml3[i] += sum;
          }
          consumers_sync();  // the next strip overwrites the power
        }
      }

      // The log mel energies in f32, handed to the splitters for the DCT and
      // the stores once they are done with the previous tile's.
      if (k > 0) mbar_wait(&s.ml_free, (k - 1) & 1);
      if constexpr (T::kMelTc) {
#pragma unroll
        for (int j = 0; j < 4; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e)
            s.ml[16 * warp + g + 8 * (e >> 1)][8 * j + 2 * q + (e & 1)] =
                logf(fmaxf(mel[4 * j + e], 1e-12f));
      } else {
#pragma unroll
        for (int i = 0; i < kRows * kMels / kConsumers; ++i)
          s.ml[tid & (kRows - 1)][2 * i + tid / kRows] = logf(fmaxf(ml3[i], 1e-12f));
      }
      mbar_arrive(&s.ml_full);
    }
  }
  // No CTA leaves while a peer may still copy into it or arrive on its
  // barriers.
  cluster_sync();
}

// Tiles for B * nb block rows; 0 when there is no window.
inline long long tiles_for(long long rows) {
  return rows > 1 ? (rows - 1 + kWins - 1) / kWins : 0;
}

// Whether every tile row starts 16-byte aligned, so the split may load 16
// bytes at a time.
inline bool rows_aligned16(const float* pcm, long long T) {
  return T % 4 == 0 && (reinterpret_cast<std::uintptr_t>(pcm) & 15) == 0;
}

// Launch `kernel` (a source's __global__ around mfcc_tc_tile<F>) on
// `stream`: persistent clusters, as many as fit on the card at once, no
// more than the tiles need.  Returns the CUDA error of the launch; it does
// not synchronise.
template <Form F>
inline cudaError_t launch(void (*kernel)(Params), Params p, long long B, cudaStream_t stream) {
  if (B <= 0 || p.nb < 2) return cudaErrorInvalidValue;
  p.rows = B * p.nb;
  const long long tiles = tiles_for(p.rows);
  if (tiles > INT_MAX - kCluster) return cudaErrorInvalidValue;
  p.tiles = static_cast<int>(tiles);
  p.aligned16 = rows_aligned16(p.pcm, p.T);
  const int smem = static_cast<int>(sizeof(Smem<F>));
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
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
  // The clusters that fit at once, per device (queried once per source).
  static int fit[64] = {};
  int dev = 0;
  err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev >= 64) return cudaErrorInvalidDevice;
  if (fit[dev] == 0) {
    err = cudaOccupancyMaxActiveClusters(&fit[dev], kernel, &cfg);
    if (err != cudaSuccess) return err;
    if (fit[dev] < 1) return cudaErrorLaunchOutOfResources;
  }
  const long long groups = (tiles + kCluster - 1) / kCluster;
  cfg.gridDim = dim3(static_cast<unsigned>(kCluster * (groups < fit[dev] ? groups : fit[dev])));
  err = cudaLaunchKernelEx(&cfg, kernel, p);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

}  // namespace streamz_tc
