// K2 on Hopper: the block-parity MFCC base with bf16x3 on the tensor cores
// for both the DFT and the mel stage, hand-written for sm_90a.
//
// Replaces the TPU kernel streamz_tpu/dsp/pallas_mfcc.py:_mfcc_kernel_v3
// (reached through _v3_call, _pipelined_base, mfcc_base_pallas_v3 and
// mfcc_features_pallas_v3, the 'pallas_v3' frontend backend and the
// candidate that the measured 'auto' choice holds against K1).  It computes
// what that kernel computes: each 400-sample block projected once in bf16x3,
// the parity combine and power per strip of bins, the strip's mel partial
// sums in bf16x3 (p_hi mel_hi + p_hi mel_lo + p_lo mel_hi, f32 accumulation),
// then log and DCT in f32.
//
// What bounds it on this card: as K3 (mfcc_v2.cu), operations on the tensor
// cores: 3 x 2 x 400 x 802 bf16 operations per block row against 1.6 KB of
// PCM.  The design is K3's tile (mfcc_tc.cuh) with the mel stage moved onto
// the tensor cores: each of the 8 warps owns one [16, 16] fragment of the
// tile's [64, 32] mel energies and carries it in registers across the 7 bin
// strips, as the TPU kernel carries its mel partial sums across _STRIPS3
// strips.  K1 keeps FP32 on the CUDA cores, so 'auto' measures two designs.
//
// Plain C interface, loaded with ctypes from streamz_tpu_torch/dsp/
// mfcc_kernel.py, which builds this file with nvcc at first use.

#include "mfcc_tc.cuh"

namespace {

using namespace streamz_tc;

__global__ void __launch_bounds__(kThreads)
mfcc_v3_kernel(const float* __restrict__ pcm, long long rows, long long T,
               long long nb, bool aligned16, const bf16* __restrict__ basis_hi,
               const bf16* __restrict__ basis_lo, const bf16* __restrict__ melw_hi,
               const bf16* __restrict__ melw_lo, const float* __restrict__ dct,
               float* __restrict__ out) {
  extern __shared__ __align__(128) unsigned char smem_raw[];
  mfcc_tc_tile<true>(pcm, rows, T, nb, aligned16, basis_hi, basis_lo, nullptr,
                     nullptr, nullptr, nullptr, melw_hi, melw_lo, dct, out,
                     *reinterpret_cast<Smem*>(smem_raw));
}

}  // namespace

extern "C" {

// Shared memory one block asks for, in bytes (for reports and checks).
int streamz_mfcc_v3_smem_bytes() { return static_cast<int>(sizeof(Smem)); }

// Launch K2 on `stream`.  pcm: [B, T] f32 contiguous; basis_hi/lo: [400, 896]
// bf16; melw_hi/lo: [448, 32] bf16; dct: [20, 26] f32; out: [B, T/400 - 1,
// 20] f32.  The wrapper handles T/400 < 2 without launching.  Returns the
// CUDA error of the launch (0 on success); it does not synchronise.
int streamz_mfcc_base_v3(const float* pcm, long long B, long long T,
                         const bf16* basis_hi, const bf16* basis_lo,
                         const bf16* melw_hi, const bf16* melw_lo,
                         const float* dct, float* out, void* stream) {
  const long long nb = T / kBlock;
  if (B <= 0 || nb < 2) return static_cast<int>(cudaErrorInvalidValue);
  const long long rows = B * nb;
  const long long tiles = tiles_for(rows);
  if (tiles > INT_MAX) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaFuncSetAttribute(
      mfcc_v3_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(sizeof(Smem)));
  if (err != cudaSuccess) return static_cast<int>(err);
  mfcc_v3_kernel<<<static_cast<unsigned>(tiles), kThreads, sizeof(Smem),
                   static_cast<cudaStream_t>(stream)>>>(
      pcm, rows, T, nb, rows_aligned16(pcm, T), basis_hi, basis_lo, melw_hi,
      melw_lo, dct, out);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
