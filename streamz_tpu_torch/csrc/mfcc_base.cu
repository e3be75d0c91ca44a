// K1 on Hopper: the fused MFCC base, hand-written for sm_90a.
//
// Replaces the TPU kernel streamz_tpu/dsp/pallas_mfcc.py:_mfcc_kernel_v4
// (reached through _v4_call and mfcc_base_pallas_v4).  It computes the same
// function, not the same blocks: for the 400-sample block rows r of a
// [B, T] f32 PCM batch (nb = T / 400 blocks per clip), window t of clip b is
// block t || block t+1 and
//
//   proj[r, k]   = sum_j x[r, j] * C[j, k]   (and the same with S), k < 401
//   re           = projc[t] + (-1)^k projc[t+1]        (im likewise)
//   power        = re^2 + im^2
//   mel          = power @ fb^T                        (26 Slaney filters)
//   base[b,t,:]  = DCT-II_20( log(max(mel, 1e-12)) )
//
// What bounds it on this card: per block row the DFT alone is
// 2*400*802 = 0.64 MFLOP (about 0.66 MFLOP with power, mel and DCT) against
// 1.6 KB of PCM read, about 400 FLOP per byte, far above the H100's
// FP32 ridge of about 20 FLOP per byte (67 TFLOP/s over 3.35 TB/s).  So it is
// bound by operations, not bytes.  The design does three things about it:
//   * the DFT is a register-blocked FP32 FMA GEMM on the CUDA cores: each
//     thread owns an 8x8 outer-product tile, 64 FMAs per four 16-byte
//     shared-memory loads, with f32 accumulation (no bf16 split: the TPU
//     kernel used bf16x3 only because Mosaic lacked an f32 matmul mode);
//   * everything after the GEMM is fused: the [rows, 802] projection, the
//     power spectrum and the mel energies never reach device memory; only
//     the PCM is read and [B, nb-1, 20] written;
//   * a tile of 128 block rows yields 127 windows, so the halo row is
//     recomputed (1/128 extra work) instead of exchanged between blocks.
// The basis is padded from 401 to 448 bins (7 groups of 64), 12% extra DFT
// work that keeps every group the same shape.  The mel stage runs sparse:
// each of the 26 filters touches only its own contiguous bin range.
// Faster routes (3xTF32 or bf16x3 on wgmma, TMA) are later work.
//
// Plain C interface, loaded with ctypes from streamz_tpu_torch/dsp/
// mfcc_kernel.py, which builds this file with nvcc at first use.

#include <climits>
#include <cuda_runtime.h>

namespace {

constexpr int kBlock = 400;                  // samples per block (= hop)
constexpr int kRows = 128;                   // block rows per tile (GEMM M)
constexpr int kWins = kRows - 1;             // windows per tile; last row is the halo
constexpr int kGroupBins = 64;               // one-sided bins per group
constexpr int kCols = 2 * kGroupBins;        // cos|sin columns per group (GEMM N)
constexpr int kGroups = 7;                   // 7 * 64 = 448 >= 401 bins
constexpr int kBasisCols = kGroups * kCols;  // 896
constexpr int kK = 16;                       // K chunk staged in shared memory
constexpr int kChunks = kBlock / kK;         // 25
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

struct __align__(16) Smem {
  float xs[2][kK][kXsStride];   // PCM chunk, transposed: [k][row]
  float ds[2][kK][kCols];       // basis chunk: [k][cos 0..63 | sin 0..63]
  float halo[16][kCols];        // each thread row's first projection row
  float pw[kRows][kPowStride];  // one group's power spectrum
  float ml[kRows][kMlStride];   // mel energies, then their logs
  float dct[kCoefs][kMels];
  long long rowoff[kRows];      // PCM offset of each tile row, -1 past the end
  int mlo[kMels], mhi[kMels], moff[kMels];
};

__global__ void __launch_bounds__(kThreads, 2)
mfcc_base_kernel(const float* __restrict__ pcm, long long rows, long long T,
                 long long nb, const float* __restrict__ basis,
                 const float* __restrict__ fbw, const int* __restrict__ mel_lo,
                 const int* __restrict__ mel_hi, const int* __restrict__ mel_off,
                 const float* __restrict__ dct, float* __restrict__ out) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  Smem& s = *reinterpret_cast<Smem*>(smem_raw);
  const int tid = threadIdx.x;
  const int ty = tid >> 4;  // owns tile rows ty*8 .. ty*8+7
  const int tx = tid & 15;  // owns bins tx*4 .. tx*4+3 of each group (cos and sin)
  const long long r0 = static_cast<long long>(blockIdx.x) * kWins;

  // Block row r of the flattened batch is clip r / nb, block r % nb: the
  // [B, nb, 400] reshape view of the PCM, read in place without a pad copy.
  for (int i = tid; i < kRows; i += kThreads) {
    const long long r = r0 + i;
    s.rowoff[i] = r < rows ? (r / nb) * T + (r % nb) * kBlock : -1;
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

  // Epilogue: log, then the [26 -> 20] DCT; write valid windows only.  A
  // window is valid when its block and the next are in the same clip (the
  // window that straddles two clips is dropped) and inside the batch.
#pragma unroll
  for (int q = 0; q < kPairs; ++q) {
    const int p = tid + q * kThreads;
    const int w = p / kMels;
    const int m = p - w * kMels;
    s.ml[w][m] = logf(fmaxf(s.ml[w][m], 1e-12f));
  }
  __syncthreads();
  const long long nwin = nb - 1;
#pragma unroll
  for (int q = 0; q < kOuts; ++q) {
    const int o = tid + q * kThreads;
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

}  // namespace

extern "C" {

// Shared memory one block asks for, in bytes (for reports and checks).
int streamz_mfcc_base_v4_smem_bytes() { return static_cast<int>(sizeof(Smem)); }

// Launch K1 on `stream`.  pcm: [B, T] f32 contiguous; out: [B, T/400 - 1, 20]
// f32.  The wrapper handles T/400 < 2 without launching.  Returns the CUDA
// error of the launch (0 on success); it does not synchronise.
int streamz_mfcc_base_v4(const float* pcm, long long B, long long T,
                         const float* basis, const float* fbw, const int* mel_lo,
                         const int* mel_hi, const int* mel_off, const float* dct,
                         float* out, void* stream) {
  const long long nb = T / kBlock;
  if (B <= 0 || nb < 2) return static_cast<int>(cudaErrorInvalidValue);
  const long long rows = B * nb;
  const long long tiles = (rows - 1 + kWins - 1) / kWins;
  if (tiles > INT_MAX) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaFuncSetAttribute(
      mfcc_base_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(sizeof(Smem)));
  if (err != cudaSuccess) return static_cast<int>(err);
  mfcc_base_kernel<<<static_cast<unsigned>(tiles), kThreads, sizeof(Smem),
                     static_cast<cudaStream_t>(stream)>>>(
      pcm, rows, T, nb, basis, fbw, mel_lo, mel_hi, mel_off, dct, out);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
