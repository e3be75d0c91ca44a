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
// The design is K2's tile (mfcc_tc.cuh: persistent clusters, the basis
// streamed through a ring of shared-memory stages by multicast bulk copies,
// wgmma m64n128k16 from shared memory, the parity combine and the power in
// registers) with the mel stage sparse and f32 on the CUDA cores, from the
// strip's power in shared memory; only the PCM is read and [B, nb-1, 20]
// written.
//
// Plain C interface, loaded with ctypes from streamz_tpu_torch/dsp/
// mfcc_kernel.py, which builds this file with nvcc at first use.

#include "mfcc_tc.cuh"

namespace {

constexpr streamz_tc::Form kForm = streamz_tc::Form::kV2;
using Smem = streamz_tc::Smem<kForm>;

__global__ void __launch_bounds__(streamz_tc::kThreads, 1) mfcc_v2_kernel(streamz_tc::Params p) {
  extern __shared__ __align__(128) unsigned char smem_raw[];
  streamz_tc::mfcc_tc_tile(p, *reinterpret_cast<Smem*>(smem_raw));
}

}  // namespace

extern "C" {

// Shared memory one block asks for, in bytes (for reports and checks).
int streamz_mfcc_v2_smem_bytes() { return static_cast<int>(sizeof(Smem)); }

// Launch K3 on `stream`.  pcm: [B, T] f32 contiguous; basis: the
// [7, 25, 4096] bf16 stages of kernel_constants()["basis_tc"]; fbw, mel_lo,
// mel_hi, mel_off: the sparse f32 mel weights; dct: [20, 26] f32; out:
// [B, T/400 - 1, 20] f32.  The wrapper handles T/400 < 2 without launching.
// Returns the CUDA error of the launch (0 on success); it does not
// synchronise.
int streamz_mfcc_base_v2(const float* pcm, long long B, long long T,
                         const streamz_tc::bf16* basis, const float* fbw,
                         const int* mel_lo, const int* mel_hi, const int* mel_off,
                         const float* dct, float* out, void* stream) {
  streamz_tc::Params p = {};
  p.pcm = pcm;
  p.T = T;
  p.nb = T / streamz_tc::kBlock;
  p.basis = basis;
  p.fbw = fbw;
  p.mel_lo = mel_lo;
  p.mel_hi = mel_hi;
  p.mel_off = mel_off;
  p.dct = dct;
  p.out = out;
  return static_cast<int>(
      streamz_tc::launch<kForm>(mfcc_v2_kernel, p, B, static_cast<cudaStream_t>(stream)));
}

}  // extern "C"
