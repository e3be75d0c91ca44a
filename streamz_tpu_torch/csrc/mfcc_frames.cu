// K4 on Hopper: the frame-major MFCC base, hand-written for sm_90a.
//
// Replaces the TPU kernel streamz_tpu/dsp/pallas_mfcc.py:_mfcc_kernel
// (reached through mfcc_base_pallas and mfcc_features_pallas, the 'pallas'
// frontend backend).  For the windows of a [B, T] f32 PCM batch (nb = T / 400
// blocks per clip, nb - 1 windows of 800 samples at hop 400) it computes
//
//   X[w, k]      = sum_n frame_w[n] * (cos | -sin)(2 pi k n / 800), k < 401
//   power        = Re^2 + Im^2
//   mel          = power @ fb^T                        (26 Slaney filters)
//   base[b,t,:]  = DCT-II_20( log(max(mel, 1e-12)) )
//
// with the full 800-tap basis: no block-parity identity, so the DFT is
// 2 * 800 * 802 = 1.28 MFLOP per window, twice K1's.
//
// What bounds it on this card: about 1.3 MFLOP per window against 3.2 KB of
// PCM read (once per window, as each sample belongs to two windows) and 80
// bytes written, about 400 FLOP per byte, far above the FP32 ridge of about
// 20 FLOP per byte: operations bound it.  The design does three things:
//   * frames need no copy: window t of clip b is the contiguous slice
//     pcm[b, 400 t : 400 t + 800], read in place (the TPU kernel built a
//     frame matrix with a concatenate and a roll first);
//   * the DFT is K1's register-blocked FP32 FMA GEMM (mfcc_simt.cuh) with
//     K = 800: 128 windows per 256-thread block, each thread an 8x8 tile
//     whose cos and sin columns are the same bins, so the power stays in
//     registers (FP32, where the TPU kernel split into bf16x3);
//   * power, the sparse mel stage, log and DCT are fused as in K1: only the
//     PCM is read and [B, nb-1, 20] written.
// Tensor cores and a shared frame tile (each block row feeds two windows)
// are later work.
//
// Plain C interface, loaded with ctypes from streamz_tpu_torch/dsp/
// mfcc_kernel.py, which builds this file with nvcc at first use.

#include "mfcc_simt.cuh"

namespace {

using namespace streamz_simt;

__global__ void __launch_bounds__(kThreads, 2)
mfcc_frames_kernel(const float* __restrict__ pcm, long long wins, long long T,
                   long long nb, const float* __restrict__ basis,
                   const float* __restrict__ fbw, const int* __restrict__ mel_lo,
                   const int* __restrict__ mel_hi, const int* __restrict__ mel_off,
                   const float* __restrict__ dct, float* __restrict__ out) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  mfcc_tile<true>(pcm, wins, T, nb, basis, fbw, mel_lo, mel_hi, mel_off, dct, out,
                  *reinterpret_cast<Smem*>(smem_raw));
}

}  // namespace

extern "C" {

// Shared memory one block asks for, in bytes (for reports and checks).
int streamz_mfcc_frames_smem_bytes() { return static_cast<int>(sizeof(Smem)); }

// Launch K4 on `stream`.  pcm: [B, T] f32 contiguous; basis: [800, 896] f32
// (7 groups of 64 bins, cos then -sin); out: [B, T/400 - 1, 20] f32.  The
// wrapper handles T/400 < 2 without launching.  Returns the CUDA error of the
// launch (0 on success); it does not synchronise.
int streamz_mfcc_base_frames(const float* pcm, long long B, long long T,
                             const float* basis, const float* fbw,
                             const int* mel_lo, const int* mel_hi,
                             const int* mel_off, const float* dct, float* out,
                             void* stream) {
  const long long nb = T / kBlock;
  if (B <= 0 || nb < 2) return static_cast<int>(cudaErrorInvalidValue);
  const long long wins = B * (nb - 1);
  const long long tiles = tiles_for<true>(wins);
  if (tiles > INT_MAX) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaFuncSetAttribute(
      mfcc_frames_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(sizeof(Smem)));
  if (err != cudaSuccess) return static_cast<int>(err);
  mfcc_frames_kernel<<<static_cast<unsigned>(tiles), kThreads, sizeof(Smem),
                       static_cast<cudaStream_t>(stream)>>>(
      pcm, wins, T, nb, basis, fbw, mel_lo, mel_hi, mel_off, dct, out);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
