// The FP32 MFCC base tile on the CUDA cores, shared by K1 (mfcc_base.cu,
// the block-parity form) and K4 (mfcc_frames.cu, the frame-major form).
//
// A block owns kRows = 128 tile rows.  For each of 7 groups of 64 one-sided
// bins it runs a register-blocked FP32 FMA GEMM of the rows against the
// group's [taps, 64 cos | 64 sin] basis columns (each thread an 8x8 tile
// whose cos and sin columns are the same bins), turns the projections into
// the group's power spectrum, and adds the group's share of the 26 mel
// energies (sparse: each filter touches only its own contiguous bin range).
// After the last group: log(max(., 1e-12)) and the [26 -> 20] DCT-II, and
// only the valid windows are written.  The projection, the power spectrum
// and the mel energies never reach device memory.
//
//   FRAMES = false (K1): tile rows are 400-sample blocks r0 .. r0+127 of the
//     flattened [B * nb, 400] view; window t = block t || block t+1, so
//     re = proj_c[t] + (-1)^k proj_c[t+1] (im likewise); the last row is the
//     halo, recomputed by the next tile: 127 windows per tile.
//   FRAMES = true (K4): tile rows are whole windows w0 .. w0+127 of the
//     flattened [B * (nb - 1)] window list, each read in place as the 800
//     contiguous samples pcm[b, 400 t : 400 t + 800]; an 800-tap DFT of each,
//     twice K1's DFT work, and power = re^2 + im^2 with no combine.

#pragma once

#include <climits>
#include <cuda_runtime.h>

namespace streamz_simt {

constexpr int kBlock = 400;                  // samples per block (= hop)
constexpr int kRows = 128;                   // tile rows (GEMM M)
constexpr int kGroupBins = 64;               // one-sided bins per group
constexpr int kCols = 2 * kGroupBins;        // cos|sin columns per group (GEMM N)
constexpr int kGroups = 7;                   // 7 * 64 = 448 >= 401 bins
constexpr int kBasisCols = kGroups * kCols;  // 896
constexpr int kK = 16;                       // K chunk staged in shared memory
constexpr int kThreads = 256;                // 16 x 16 threads, 8x8 outputs each
constexpr int kMels = 26;
constexpr int kCoefs = 20;
constexpr int kXsStride = kRows + 4;         // padded: fewer bank conflicts on the transpose
constexpr int kPowStride = kGroupBins + 1;
constexpr int kMlStride = kMels + 1;
constexpr int kPairs = kRows * kMels / kThreads;    // (window, mel) pairs per thread
constexpr int kOuts = kRows * kCoefs / kThreads;    // (window, coef) outputs per thread

static_assert(kBlock % kK == 0, "K chunks must tile the block");
static_assert(kRows * kMels % kThreads == 0, "mel pairs must split evenly");
static_assert(kRows * kCoefs % kThreads == 0, "outputs must split evenly");
static_assert(kRows == 16 * 8 && kCols == 16 * 8, "16x16 threads of 8x8");

// Taps per tile row and windows per tile of each form.
template <bool FRAMES>
__host__ __device__ constexpr int taps() { return FRAMES ? 2 * kBlock : kBlock; }
template <bool FRAMES>
__host__ __device__ constexpr int wins_per_tile() { return FRAMES ? kRows : kRows - 1; }

struct __align__(16) Smem {
  float xs[2][kK][kXsStride];   // PCM chunk, transposed: [k][row]
  float ds[2][kK][kCols];       // basis chunk: [k][cos 0..63 | sin 0..63]
  float halo[16][kCols];        // each thread row's first projection row (K1)
  float pw[kRows][kPowStride];  // one group's power spectrum
  float ml[kRows][kMlStride];   // mel energies, then their logs
  float dct[kCoefs][kMels];
  long long rowoff[kRows];      // PCM offset of each tile row, -1 past the end
  int mlo[kMels], mhi[kMels], moff[kMels];
};

// One tile of the MFCC base; `rows` counts tile rows of the whole batch
// (block rows B * nb for K1, windows B * (nb - 1) for K4).
template <bool FRAMES>
__device__ __forceinline__ void mfcc_tile(
    const float* __restrict__ pcm, long long rows, long long T, long long nb,
    const float* __restrict__ basis, const float* __restrict__ fbw,
    const int* __restrict__ mel_lo, const int* __restrict__ mel_hi,
    const int* __restrict__ mel_off, const float* __restrict__ dct,
    float* __restrict__ out, Smem& s) {
  constexpr int kChunks = taps<FRAMES>() / kK;  // 25 (K1) or 50 (K4)
  constexpr int kWins = wins_per_tile<FRAMES>();
  const int tid = threadIdx.x;
  const int ty = tid >> 4;  // owns tile rows ty*8 .. ty*8+7
  const int tx = tid & 15;  // owns bins tx*4 .. tx*4+3 of each group (cos and sin)
  const long long r0 = static_cast<long long>(blockIdx.x) * kWins;
  const long long nwin = nb - 1;

  // K1: block row r is clip r / nb, block r % nb (the [B, nb, 400] reshape
  // view).  K4: window r is clip r / nwin, starting at sample 400 (r % nwin).
  // Both read the PCM in place, without a pad or frame copy.
  for (int i = tid; i < kRows; i += kThreads) {
    const long long r = r0 + i;
    const long long per = FRAMES ? nwin : nb;
    s.rowoff[i] = r < rows ? (r / per) * T + (r % per) * kBlock : -1;
  }
  for (int i = tid; i < kCoefs * kMels; i += kThreads) (&s.dct[0][0])[i] = dct[i];
  for (int i = tid; i < kRows * kMlStride; i += kThreads) (&s.ml[0][0])[i] = 0.f;
  if (tid < kMels) {
    s.mlo[tid] = mel_lo[tid];
    s.mhi[tid] = mel_hi[tid];
    s.moff[tid] = mel_off[tid];
  }
  __syncthreads();

  for (int g = 0; g < kGroups; ++g) {
    const float* bg = basis + g * kCols;
    float acc[8][8];
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;

    // Register-staged double buffer: the next chunk's global loads are in
    // flight while the current chunk's FMAs run.
    float xr[8];
    float4 dr[2];
#define STREAMZ_LOAD_CHUNK(c)                                                  \
  do {                                                                         \
    const int k0 = (c) * kK;                                                   \
    _Pragma("unroll") for (int i = 0; i < 8; ++i) {                            \
      const long long off = s.rowoff[ty + 16 * i];                             \
      xr[i] = off >= 0 ? __ldg(pcm + off + k0 + tx) : 0.f;                     \
    }                                                                          \
    _Pragma("unroll") for (int i = 0; i < 2; ++i) {                            \
      const int idx = tid + kThreads * i;                                      \
      dr[i] = __ldg(reinterpret_cast<const float4*>(                           \
                        bg + static_cast<long long>(k0 + (idx >> 5)) * kBasisCols) + \
                    (idx & 31));                                               \
    }                                                                          \
  } while (0)
#define STREAMZ_STORE_CHUNK(buf)                                               \
  do {                                                                         \
    _Pragma("unroll") for (int i = 0; i < 8; ++i) s.xs[buf][tx][ty + 16 * i] = xr[i]; \
    _Pragma("unroll") for (int i = 0; i < 2; ++i) {                            \
      const int idx = tid + kThreads * i;                                      \
      *reinterpret_cast<float4*>(&s.ds[buf][idx >> 5][(idx & 31) * 4]) = dr[i]; \
    }                                                                          \
  } while (0)

    STREAMZ_LOAD_CHUNK(0);
    STREAMZ_STORE_CHUNK(0);
    __syncthreads();
    for (int c = 0; c < kChunks; ++c) {
      const int cur = c & 1;
      if (c + 1 < kChunks) STREAMZ_LOAD_CHUNK(c + 1);
#pragma unroll
      for (int kk = 0; kk < kK; ++kk) {
        const float4 a0 = *reinterpret_cast<const float4*>(&s.xs[cur][kk][ty * 8]);
        const float4 a1 = *reinterpret_cast<const float4*>(&s.xs[cur][kk][ty * 8 + 4]);
        const float4 b0 = *reinterpret_cast<const float4*>(&s.ds[cur][kk][tx * 4]);
        const float4 b1 =
            *reinterpret_cast<const float4*>(&s.ds[cur][kk][kGroupBins + tx * 4]);
        const float a[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
        const float b[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
        for (int i = 0; i < 8; ++i)
#pragma unroll
          for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
      }
      // The other buffer was last read before the previous barrier.
      if (c + 1 < kChunks) STREAMZ_STORE_CHUNK(cur ^ 1);
      __syncthreads();
    }
#undef STREAMZ_LOAD_CHUNK
#undef STREAMZ_STORE_CHUNK

    if constexpr (FRAMES) {
      // acc[i][0..3] is re and acc[i][4..7] im of window ty*8+i.
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j)
          s.pw[ty * 8 + i][tx * 4 + j] =
              acc[i][j] * acc[i][j] + acc[i][4 + j] * acc[i][4 + j];
    } else {
      // Halo combine.  acc[i][0..3] is cos and acc[i][4..7] sin of tile row
      // ty*8+i for bins gb0 + tx*4 + j; window ty*8+i needs row ty*8+i+1,
      // which for i = 7 lives in the next thread row.  Bin parity is j's
      // parity because gb0 and tx*4 are even.
      *reinterpret_cast<float4*>(&s.halo[ty][tx * 8]) =
          make_float4(acc[0][0], acc[0][1], acc[0][2], acc[0][3]);
      *reinterpret_cast<float4*>(&s.halo[ty][tx * 8 + 4]) =
          make_float4(acc[0][4], acc[0][5], acc[0][6], acc[0][7]);
      __syncthreads();
      float nxt[8];
#pragma unroll
      for (int j = 0; j < 8; ++j) nxt[j] = ty + 1 < 16 ? s.halo[ty + 1][tx * 8 + j] : 0.f;
#pragma unroll
      for (int i = 0; i < 8; ++i) {
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const float sg = (j & 1) ? -1.f : 1.f;
          const float cn = i < 7 ? acc[i + 1][j] : nxt[j];
          const float sn = i < 7 ? acc[i + 1][4 + j] : nxt[4 + j];
          const float re = acc[i][j] + sg * cn;
          const float im = acc[i][4 + j] + sg * sn;
          s.pw[ty * 8 + i][tx * 4 + j] = re * re + im * im;
        }
      }
    }
    __syncthreads();

    // Sparse mel: filter m covers bins [mlo, mhi); each (window, mel) pair
    // has one owner thread for the whole tile, so the sums need no atomics.
    const int gb0 = g * kGroupBins;
#pragma unroll
    for (int q = 0; q < kPairs; ++q) {
      const int p = tid + q * kThreads;
      const int w = p / kMels;
      const int m = p - w * kMels;
      const int lo = max(s.mlo[m], gb0);
      const int hi = min(s.mhi[m], gb0 + kGroupBins);
      const float* wt = fbw + s.moff[m] - s.mlo[m];
      float sum = 0.f;
      for (int bin = lo; bin < hi; ++bin)
        sum = fmaf(s.pw[w][bin - gb0], __ldg(wt + bin), sum);
      s.ml[w][m] += sum;
    }
    __syncthreads();
  }

  // Epilogue: log, then the [26 -> 20] DCT; write valid windows only.  For
  // K1 a window is valid when its block and the next are in the same clip
  // (the window that straddles two clips is dropped) and inside the batch;
  // for K4 every tile row inside the batch is a window.
#pragma unroll
  for (int q = 0; q < kPairs; ++q) {
    const int p = tid + q * kThreads;
    const int w = p / kMels;
    const int m = p - w * kMels;
    s.ml[w][m] = logf(fmaxf(s.ml[w][m], 1e-12f));
  }
  __syncthreads();
#pragma unroll
  for (int q = 0; q < kOuts; ++q) {
    const int o = tid + q * kThreads;
    const int w = o / kCoefs;
    const int c = o - w * kCoefs;
    const long long r = r0 + w;
    if (w >= kWins || r >= rows) continue;
    float sum = 0.f;
#pragma unroll
    for (int m = 0; m < kMels; ++m) sum = fmaf(s.ml[w][m], s.dct[c][m], sum);
    if constexpr (FRAMES) {
      out[r * kCoefs + c] = sum;
    } else {
      const long long t = r % nb;
      if (t >= nwin) continue;
      out[((r / nb) * nwin + t) * kCoefs + c] = sum;
    }
  }
}

// Grid size for a batch of `rows` tile rows; 0 when there is no window.
template <bool FRAMES>
long long tiles_for(long long rows) {
  constexpr int kWins = wins_per_tile<FRAMES>();
  const long long need = FRAMES ? rows : rows - 1;
  return need > 0 ? (need + kWins - 1) / kWins : 0;
}

}  // namespace streamz_simt
