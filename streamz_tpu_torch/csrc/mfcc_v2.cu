// K3 on Hopper: the block-parity MFCC base with a bf16x3 tensor-core DFT and
// an f32 mel stage, hand-written for sm_90a.
//
// Replaces the TPU kernel streamz_tpu/dsp/pallas_mfcc.py:_mfcc_kernel_v2
// (reached through mfcc_base_pallas_v2 and mfcc_features_pallas_v2, the
// 'pallas_v2' frontend backend).  It computes what that kernel computes:
// each 400-sample block projected once in bf16x3 (x_hi d_hi + x_hi d_lo +
// x_lo d_hi, f32 accumulation), window t = block t || block t+1 combined with
// the parity sign, power, the mel energies in f32, log and DCT in f32.
//
// What bounds it on this card: per block row 3 x 2 x 400 x 802 bf16 operations
// (1.9 MFLOP, 0.64 MFLOP of it useful) against 1.6 KB of PCM read, far above
// the bf16 ridge of about 295 FLOP per byte: operations, on the tensor cores.
// The design (mfcc_tc.cuh): 64-row tiles (63 windows plus the halo row),
// staged with cp.async and split into bf16 hi/lo planes once per tile;
// nvcuda::wmma 16x16x16 bf16 fragments in 7 strips of 64 bins, each strip's
// projection stored to shared memory for the parity combine; the mel stage
// sparse and f32 on the CUDA cores; only the PCM is read and [B, nb-1, 20]
// written.  wgmma, TMA and a basis tile shared through shared memory are
// later work.
//
// Plain C interface, loaded with ctypes from streamz_tpu_torch/dsp/
// mfcc_kernel.py, which builds this file with nvcc at first use.

#include "mfcc_tc.cuh"

namespace {

using namespace streamz_tc;

__global__ void __launch_bounds__(kThreads)
mfcc_v2_kernel(const float* __restrict__ pcm, long long rows, long long T,
               long long nb, bool aligned16, const bf16* __restrict__ basis_hi,
               const bf16* __restrict__ basis_lo, const float* __restrict__ fbw,
               const int* __restrict__ mel_lo, const int* __restrict__ mel_hi,
               const int* __restrict__ mel_off, const float* __restrict__ dct,
               float* __restrict__ out) {
  extern __shared__ __align__(128) unsigned char smem_raw[];
  mfcc_tc_tile<false>(pcm, rows, T, nb, aligned16, basis_hi, basis_lo, fbw, mel_lo,
                      mel_hi, mel_off, nullptr, nullptr, dct, out,
                      *reinterpret_cast<Smem*>(smem_raw));
}

}  // namespace

extern "C" {

// Shared memory one block asks for, in bytes (for reports and checks).
int streamz_mfcc_v2_smem_bytes() { return static_cast<int>(sizeof(Smem)); }

// Launch K3 on `stream`.  pcm: [B, T] f32 contiguous; basis_hi/lo: [400, 896]
// bf16; fbw, mel_lo, mel_hi, mel_off: the sparse f32 mel weights; dct:
// [20, 26] f32; out: [B, T/400 - 1, 20] f32.  The wrapper handles T/400 < 2
// without launching.  Returns the CUDA error of the launch (0 on success);
// it does not synchronise.
int streamz_mfcc_base_v2(const float* pcm, long long B, long long T,
                         const bf16* basis_hi, const bf16* basis_lo,
                         const float* fbw, const int* mel_lo, const int* mel_hi,
                         const int* mel_off, const float* dct, float* out,
                         void* stream) {
  const long long nb = T / kBlock;
  if (B <= 0 || nb < 2) return static_cast<int>(cudaErrorInvalidValue);
  const long long rows = B * nb;
  const long long tiles = tiles_for(rows);
  if (tiles > INT_MAX) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaFuncSetAttribute(
      mfcc_v2_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(sizeof(Smem)));
  if (err != cudaSuccess) return static_cast<int>(err);
  mfcc_v2_kernel<<<static_cast<unsigned>(tiles), kThreads, sizeof(Smem),
                   static_cast<cudaStream_t>(stream)>>>(
      pcm, rows, T, nb, rows_aligned16(pcm, T), basis_hi, basis_lo, fbw, mel_lo,
      mel_hi, mel_off, dct, out);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
