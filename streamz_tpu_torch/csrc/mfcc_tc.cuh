// The bf16x3 tensor-core MFCC base tile, shared by K3 (mfcc_v2.cu, mel in
// f32) and K2 (mfcc_v3.cu, mel in bf16x3 too).
//
// Both compute the block-parity form: each 400-sample block row r of the
// flattened [B * nb, 400] view is projected once onto the one-sided cos and
// -sin basis, and window t = block t || block t+1 is
//
//   re = proj_c[t] + (-1)^k proj_c[t+1]   (im likewise), power = re^2 + im^2,
//   mel = power @ fb^T, base = DCT-II_20( log(max(mel, 1e-12)) ).
//
// The DFT runs on the tensor cores in bf16x3, which is what the TPU kernels
// compute: x = x_hi + x_lo and d = d_hi + d_lo in bf16 (lo = bf16(a - hi)),
// and proj = x_hi d_hi + x_hi d_lo + x_lo d_hi with f32 accumulation
// (nvcuda::wmma, 16x16x16 bf16 fragments).  Each bf16 product is exact in
// f32, so the three products agree with an f32 DFT to about 1e-5 relative;
// two products (bf16x2) missed the 1e-3 feature gate on the TPU.
//
// A block owns kRows = 64 block rows and emits 63 windows: the tile's rows
// plus its +1 halo row are staged in shared memory with cp.async (the
// counterpart of the TPU kernel's make_async_copy), 16 rows per stage, two
// stages in flight, and split once into bf16 hi/lo planes there.  The bins
// are walked in 7 strips of 64 (448 >= 401): per strip each of the 8 warps
// runs a 32 x 32 share of the [64, 128] (cos | sin) projection, reading
// the basis fragments from device memory (the 1.4 MB of hi/lo planes stay
// in L2), and stores it to shared memory, since a fragment's layout is
// opaque and rows t and t+1 sit in different fragments and warps.  Then the
// parity combine and the power, and the strip's share of the mel energies:
//
//   MEL_TC = false (K3): f32, sparse over each filter's bin range;
//   MEL_TC = true  (K2): bf16x3 on the tensor cores, p_hi mel_hi + p_hi
//     mel_lo + p_lo mel_hi, one [16, 16] fragment of the [64, 32] mel tile
//     per warp, carried in registers across the strips.
//
// After the last strip: log(max(., 1e-12)) and the [26 -> 20] DCT in f32 on
// the CUDA cores, and only the valid windows are written.

#pragma once

#include <climits>
#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>

namespace streamz_tc {

using namespace nvcuda;
using bf16 = __nv_bfloat16;

constexpr int kBlock = 400;             // samples per block = the DFT's K (25 x 16)
constexpr int kRows = 64;               // block rows per tile (4 fragments of 16)
constexpr int kWins = kRows - 1;        // windows per tile; the last row is the halo
constexpr int kStrips = 7;              // 7 * 64 = 448 >= 401 bins
constexpr int kStripBins = 64;
constexpr int kStripCols = 2 * kStripBins;        // cos 64 | sin 64
constexpr int kBasisCols = kStrips * kStripCols;  // 896
constexpr int kMelCols = 32;            // 26 mels padded to two fragments
constexpr int kThreads = 256;           // 8 warps
constexpr int kMels = 26;
constexpr int kCoefs = 20;
constexpr int kStageRows = 16;          // PCM rows per cp.async stage
constexpr int kStages = kRows / kStageRows;
constexpr int kXld = kBlock + 8;        // bf16 row stride of the PCM planes
constexpr int kCld = kStripCols + 4;    // f32 row stride of the projection
constexpr int kPwld = kStripBins + 1;   // f32 row stride of the power (K3)
constexpr int kPld = kStripBins + 8;    // bf16 row stride of the power planes (K2)
constexpr int kMlld = kMelCols + 4;     // f32 row stride of the mel energies

static_assert(kBlock % 16 == 0 && kRows % 16 == 0, "whole fragments");
static_assert(kRows % kStageRows == 0, "whole stages");
static_assert(kXld % 8 == 0 && kPld % 8 == 0 && kCld % 4 == 0 && kMlld % 4 == 0,
              "wmma leading dimensions");

struct __align__(128) Smem {
  bf16 xhi[kRows][kXld];  // the tile's PCM, split once: hi and lo planes
  bf16 xlo[kRows][kXld];
  union {
    float stage[2][kStageRows][kBlock];  // f32 PCM rows in flight (cp.async)
    struct {
      float proj[kRows][kCld];  // one strip's [cos | sin] projection
      float pw[kRows][kPwld];   // its power spectrum (K3)
      bf16 phi[kRows][kPld];    // its power spectrum, split (K2)
      bf16 plo[kRows][kPld];
    } s;
  } u;
  float ml[kRows][kMlld];  // mel energies, then their logs
  float dct[kCoefs][kMels];
  long long rowoff[kRows];  // PCM offset of each tile row, -1 past the end
  int mlo[kMels], mhi[kMels], moff[kMels];
};

__device__ __forceinline__ void cp_async4(void* smem, const void* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s), "l"(gmem));
}

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(gmem));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

__device__ __forceinline__ void split(float x, bf16& hi, bf16& lo) {
  hi = __float2bfloat16_rn(x);
  lo = __float2bfloat16_rn(x - __bfloat162float(hi));
}

// Copy tile rows stage*16 .. stage*16+15 into s.u.stage[stage & 1]; rows
// past the batch are not copied (the split reads them as zero).  16-byte
// copies when every row starts 16-byte aligned, else 4-byte ones.
__device__ __forceinline__ void stage_rows(const float* pcm, bool aligned16,
                                            int stage, Smem& s) {
  float(*dst)[kBlock] = s.u.stage[stage & 1];
  const int row0 = stage * kStageRows;
  if (aligned16) {
    for (int i = threadIdx.x; i < kStageRows * (kBlock / 4); i += kThreads) {
      const int r = i / (kBlock / 4);
      const int c = (i - r * (kBlock / 4)) * 4;
      const long long off = s.rowoff[row0 + r];
      if (off >= 0) cp_async16(&dst[r][c], pcm + off + c);
    }
  } else {
    for (int i = threadIdx.x; i < kStageRows * kBlock; i += kThreads) {
      const int r = i / kBlock;
      const int c = i - r * kBlock;
      const long long off = s.rowoff[row0 + r];
      if (off >= 0) cp_async4(&dst[r][c], pcm + off + c);
    }
  }
  cp_async_commit();
}

// One tile of the MFCC base.  rows = B * nb block rows of the batch.
// basis_hi/lo: [400, 896] bf16 (strip s: cos of bins 64s .. 64s+63, then
// their -sin).  K3 reads fbw/mel_lo/mel_hi/mel_off (the sparse f32 mel
// weights); K2 reads melw_hi/lo: [448, 32] bf16 (fb^T, zero padded).
template <bool MEL_TC>
__device__ __forceinline__ void mfcc_tc_tile(
    const float* __restrict__ pcm, long long rows, long long T, long long nb,
    bool aligned16, const bf16* __restrict__ basis_hi,
    const bf16* __restrict__ basis_lo, const float* __restrict__ fbw,
    const int* __restrict__ mel_lo, const int* __restrict__ mel_hi,
    const int* __restrict__ mel_off, const bf16* __restrict__ melw_hi,
    const bf16* __restrict__ melw_lo, const float* __restrict__ dct,
    float* __restrict__ out, Smem& s) {
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const long long r0 = static_cast<long long>(blockIdx.x) * kWins;
  const long long nwin = nb - 1;

  // Block row r is clip r / nb, block r % nb: the [B, nb, 400] reshape view
  // of the PCM, read in place without a pad copy.
  for (int i = tid; i < kRows; i += kThreads) {
    const long long r = r0 + i;
    s.rowoff[i] = r < rows ? (r / nb) * T + (r % nb) * kBlock : -1;
  }
  for (int i = tid; i < kCoefs * kMels; i += kThreads) (&s.dct[0][0])[i] = dct[i];
  for (int i = tid; i < kRows * kMlld; i += kThreads) (&s.ml[0][0])[i] = 0.f;
  if (!MEL_TC && tid < kMels) {
    s.mlo[tid] = mel_lo[tid];
    s.mhi[tid] = mel_hi[tid];
    s.moff[tid] = mel_off[tid];
  }
  __syncthreads();

  // Stage the tile's 64 rows (63 windows plus the halo row), 16 at a time
  // with the next 16 in flight, and split each stage into bf16 hi/lo.
  stage_rows(pcm, aligned16, 0, s);
  for (int st = 0; st < kStages; ++st) {
    if (st + 1 < kStages) {
      stage_rows(pcm, aligned16, st + 1, s);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const float(*src)[kBlock] = s.u.stage[st & 1];
    for (int i = tid; i < kStageRows * kBlock; i += kThreads) {
      const int r = i / kBlock;
      const int c = i - r * kBlock;
      const int row = st * kStageRows + r;
      const float x = s.rowoff[row] >= 0 ? src[r][c] : 0.f;
      split(x, s.xhi[row][c], s.xlo[row][c]);
    }
    __syncthreads();  // the buffer is refilled two stages on
  }

  // Warp w computes projection rows 32 (w / 4) .. +32 and columns
  // 32 (w % 4) .. +32 of each strip: 2 x 2 fragments.
  const int prow = 32 * (warp >> 2);
  const int pcol = 32 * (warp & 3);
  // K2: warp w owns the mel fragment at rows 16 (w / 2), columns 16 (w % 2).
  const int mrow = 16 * (warp >> 1);
  const int mcol = 16 * (warp & 1);
  wmma::fragment<wmma::accumulator, 16, 16, 16, float> mel_acc;
  wmma::fill_fragment(mel_acc, 0.f);

  for (int strip = 0; strip < kStrips; ++strip) {
    wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[2][2];
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int j = 0; j < 2; ++j) wmma::fill_fragment(acc[i][j], 0.f);
    const int col0 = strip * kStripCols + pcol;
    for (int k0 = 0; k0 < kBlock; k0 += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> ahi[2], alo[2];
      wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> bhi[2], blo[2];
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        wmma::load_matrix_sync(ahi[i], &s.xhi[prow + 16 * i][k0], kXld);
        wmma::load_matrix_sync(alo[i], &s.xlo[prow + 16 * i][k0], kXld);
      }
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const size_t off = static_cast<size_t>(k0) * kBasisCols + col0 + 16 * j;
        wmma::load_matrix_sync(bhi[j], basis_hi + off, kBasisCols);
        wmma::load_matrix_sync(blo[j], basis_lo + off, kBasisCols);
      }
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          wmma::mma_sync(acc[i][j], ahi[i], bhi[j], acc[i][j]);
          wmma::mma_sync(acc[i][j], ahi[i], blo[j], acc[i][j]);
          wmma::mma_sync(acc[i][j], alo[i], bhi[j], acc[i][j]);
        }
    }
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int j = 0; j < 2; ++j)
        wmma::store_matrix_sync(&s.u.s.proj[prow + 16 * i][pcol + 16 * j], acc[i][j],
                                kCld, wmma::mem_row_major);
    __syncthreads();

    // Parity combine and power; bin parity is k's parity (64 * strip is even).
    for (int i = tid; i < kRows * kStripBins; i += kThreads) {
      const int t = i / kStripBins;
      const int k = i - t * kStripBins;
      const float sg = (k & 1) ? -1.f : 1.f;
      const float cn = t + 1 < kRows ? s.u.s.proj[t + 1][k] : 0.f;
      const float sn = t + 1 < kRows ? s.u.s.proj[t + 1][kStripBins + k] : 0.f;
      const float re = s.u.s.proj[t][k] + sg * cn;
      const float im = s.u.s.proj[t][kStripBins + k] + sg * sn;
      const float p = re * re + im * im;
      if constexpr (MEL_TC) {
        split(p, s.u.s.phi[t][k], s.u.s.plo[t][k]);
      } else {
        s.u.s.pw[t][k] = p;
      }
    }
    __syncthreads();

    const int gb0 = strip * kStripBins;
    if constexpr (MEL_TC) {
      // The strip's share of the mel energies in bf16x3 on the tensor cores.
#pragma unroll
      for (int k0 = 0; k0 < kStripBins; k0 += 16) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> phi, plo;
        wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> mhi, mlo;
        wmma::load_matrix_sync(phi, &s.u.s.phi[mrow][k0], kPld);
        wmma::load_matrix_sync(plo, &s.u.s.plo[mrow][k0], kPld);
        const size_t off = static_cast<size_t>(gb0 + k0) * kMelCols + mcol;
        wmma::load_matrix_sync(mhi, melw_hi + off, kMelCols);
        wmma::load_matrix_sync(mlo, melw_lo + off, kMelCols);
        wmma::mma_sync(mel_acc, phi, mhi, mel_acc);
        wmma::mma_sync(mel_acc, phi, mlo, mel_acc);
        wmma::mma_sync(mel_acc, plo, mhi, mel_acc);
      }
    } else {
      // Sparse f32 mel: filter m covers bins [mlo, mhi); each (window, mel)
      // pair has one owner thread for the whole tile, so no atomics.
      for (int p = tid; p < kRows * kMels; p += kThreads) {
        const int w = p / kMels;
        const int m = p - w * kMels;
        const int lo = max(s.mlo[m], gb0);
        const int hi = min(s.mhi[m], gb0 + kStripBins);
        const float* wt = fbw + s.moff[m] - s.mlo[m];
        float sum = 0.f;
        for (int bin = lo; bin < hi; ++bin)
          sum = fmaf(s.u.s.pw[w][bin - gb0], __ldg(wt + bin), sum);
        s.ml[w][m] += sum;
      }
    }
    __syncthreads();  // the next strip overwrites the projection and power
  }

  if constexpr (MEL_TC) {
    wmma::store_matrix_sync(&s.ml[mrow][mcol], mel_acc, kMlld, wmma::mem_row_major);
    __syncthreads();
  }

  // Epilogue in f32: log, then the [26 -> 20] DCT; write valid windows only.
  // A window is valid when its block and the next are in the same clip (the
  // window that straddles two clips is dropped) and inside the batch.
  for (int p = tid; p < kRows * kMels; p += kThreads) {
    const int w = p / kMels;
    const int m = p - w * kMels;
    s.ml[w][m] = logf(fmaxf(s.ml[w][m], 1e-12f));
  }
  __syncthreads();
  for (int o = tid; o < kRows * kCoefs; o += kThreads) {
    const int w = o / kCoefs;
    const int c = o - w * kCoefs;
    const long long r = r0 + w;
    if (w >= kWins || r >= rows) continue;
    const long long t = r % nb;
    if (t >= nwin) continue;
    float sum = 0.f;
#pragma unroll
    for (int m = 0; m < kMels; ++m) sum = fmaf(s.ml[w][m], s.dct[c][m], sum);
    out[((r / nb) * nwin + t) * kCoefs + c] = sum;
  }
}

// Grid size for B * nb block rows; 0 when there is no window.
inline long long tiles_for(long long rows) {
  return rows > 1 ? (rows - 1 + kWins - 1) / kWins : 0;
}

// Whether every tile row starts 16-byte aligned, so cp.async may copy 16
// bytes at a time.
inline bool rows_aligned16(const float* pcm, long long T) {
  return T % 4 == 0 && (reinterpret_cast<std::uintptr_t>(pcm) & 15) == 0;
}

}  // namespace streamz_tc
