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
// What bounds it on this card: operations on the tensor cores, 3 x 2 x 400 x
// 802 bf16 operations per block row against 1.6 KB of PCM; and the basis
// that every row tile reads through L2.  The design is mfcc_tc.cuh's tile
// (persistent clusters, the basis streamed once per tile pair through a
// ring of shared-memory stages by multicast bulk copies, wgmma from shared
// memory, the combine in registers) with the mel stage as a second wgmma
// whose A is the power straight from the registers and whose B, the strip's
// mel planes, arrives through the same ring; the [64, 32] mel accumulator
// stays in registers across the 7 strips, as the TPU kernel carries its mel
// partial sums across _STRIPS3 strips.  K1 (mfcc_base.cu) is this form with
// the TPU kernel v4's tail, the other candidate that 'auto' measures.
//
// Plain C interface, loaded with ctypes from streamz_tpu_torch/dsp/
// mfcc_kernel.py, which builds this file with nvcc at first use.

#include "mfcc_tc.cuh"

namespace {

constexpr streamz_tc::Form kForm = streamz_tc::Form::kV3;
using Smem = streamz_tc::Smem<kForm>;

__global__ void __launch_bounds__(streamz_tc::kThreads, 1) mfcc_v3_kernel(streamz_tc::Params p) {
  extern __shared__ __align__(128) unsigned char smem_raw[];
  streamz_tc::mfcc_tc_tile(p, *reinterpret_cast<Smem*>(smem_raw));
}

}  // namespace

extern "C" {

// Shared memory one block asks for, in bytes (for reports and checks).
int streamz_mfcc_v3_smem_bytes() { return static_cast<int>(sizeof(Smem)); }

// Launch K2 on `stream`.  pcm: [B, T] f32 contiguous; basis: the
// [7, 25, 4096] bf16 stages of kernel_constants()["basis_tc"]; melw: the
// [7, 4096] bf16 stages of ["mel_tc"]; dct: [20, 26] f32; out: [B, T/400 - 1,
// 20] f32.  The wrapper handles T/400 < 2 without launching.  Returns the
// CUDA error of the launch (0 on success); it does not synchronise.
int streamz_mfcc_base_v3(const float* pcm, long long B, long long T,
                         const streamz_tc::bf16* basis, const streamz_tc::bf16* melw,
                         const float* dct, float* out, void* stream) {
  streamz_tc::Params p = {};
  p.pcm = pcm;
  p.T = T;
  p.nb = T / streamz_tc::kBlock;
  p.basis = basis;
  p.melw = melw;
  p.dct = dct;
  p.out = out;
  return static_cast<int>(
      streamz_tc::launch<kForm>(mfcc_v3_kernel, p, B, static_cast<cudaStream_t>(stream)));
}

}  // extern "C"
