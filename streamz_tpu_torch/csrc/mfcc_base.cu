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
// The tile itself lives in mfcc_simt.cuh, which K4 (mfcc_frames.cu, the
// frame-major form) shares.  Plain C interface, loaded with ctypes from
// streamz_tpu_torch/dsp/mfcc_kernel.py, which builds this file with nvcc at
// first use.

#include "mfcc_simt.cuh"

namespace {

using namespace streamz_simt;

__global__ void __launch_bounds__(kThreads, 2)
mfcc_base_kernel(const float* __restrict__ pcm, long long rows, long long T,
                 long long nb, const float* __restrict__ basis,
                 const float* __restrict__ fbw, const int* __restrict__ mel_lo,
                 const int* __restrict__ mel_hi, const int* __restrict__ mel_off,
                 const float* __restrict__ dct, float* __restrict__ out) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  mfcc_tile<false>(pcm, rows, T, nb, basis, fbw, mel_lo, mel_hi, mel_off, dct, out,
                   *reinterpret_cast<Smem*>(smem_raw));
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
  const long long tiles = tiles_for<false>(rows);
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
