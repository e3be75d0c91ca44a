// K4 on Hopper: the frame-major MFCC base with a bf16x3 tensor-core DFT over
// the full 800-tap window, hand-written for sm_90a.
//
// Replaces the TPU kernel streamz_tpu/dsp/pallas_mfcc.py:_mfcc_kernel
// (reached through mfcc_base_pallas and mfcc_features_pallas, the 'pallas'
// frontend backend).  It computes what that kernel computes: for each
// window of 800 samples at hop 400 (nb = T / 400 blocks per clip, nb - 1
// windows),
//
//   X[w, k]      = sum_n frame_w[n] (cos | -sin)(2 pi k n / 800), k < 401,
//                  in bf16x3 (x_hi d_hi + x_hi d_lo + x_lo d_hi), one f32
//                  accumulation over all 800 taps
//   power        = Re^2 + Im^2                            (f32)
//   mel          = power @ fb^T                           (f32, 26 filters)
//   base[b,t,:]  = DCT-II_20( log(max(mel, 1e-12)) )      (f32)
//
// with no block-parity identity: 3 x 2 x 800 x 802 bf16 operations per
// window, twice K1's.  (The second half of the bf16 frame basis is (-1)^k
// times the first, so the parity form would give K3's sums; this backend
// exists for the TPU kernel's own formulation.)
//
// What bounds it on this card: those operations on the tensor cores against
// 1.6 KB of PCM per window, and the 2.87 MB of basis planes that every tile
// pair reads through L2.  The design is mfcc_tc.cuh's tile in its frame
// form: a tile's 64 block rows are split once into bf16 planes, and each
// row serves both windows that hold it, window w reading rows w (taps
// 0..399) and w + 1 (taps 400..799) of the same planes through a second
// wgmma descriptor one row on; the basis streams through the ring by
// multicast bulk copies from kernel_constants()["frame_basis_tc"]; the
// power in registers; the mel stage sparse in f32 on the CUDA cores, as
// K3's; the splitters run the DCT and the stores.  Only the PCM is read and
// [B, nb-1, 20] written.
//
// Plain C interface, loaded with ctypes from streamz_tpu_torch/dsp/
// mfcc_kernel.py, which builds this file with nvcc at first use.

#include "mfcc_tc.cuh"

namespace {

constexpr streamz_tc::Form kForm = streamz_tc::Form::kFrames;
using Smem = streamz_tc::Smem<kForm>;

__global__ void __launch_bounds__(streamz_tc::kThreads, 1) mfcc_frames_kernel(streamz_tc::Params p) {
  extern __shared__ __align__(128) unsigned char smem_raw[];
  streamz_tc::mfcc_tc_tile(p, *reinterpret_cast<Smem*>(smem_raw));
}

}  // namespace

extern "C" {

// Shared memory one block asks for, in bytes (for reports and checks).
int streamz_mfcc_frames_smem_bytes() { return static_cast<int>(sizeof(Smem)); }

// Launch K4 on `stream`.  pcm: [B, T] f32 contiguous; basis: the
// [7, 50, 4096] bf16 stages of kernel_constants()["frame_basis_tc"]; fbw,
// mel_lo, mel_hi, mel_off: the sparse f32 mel weights; dct: [20, 26] f32;
// out: [B, T/400 - 1, 20] f32.  The wrapper handles T/400 < 2 without
// launching.  Returns the CUDA error of the launch (0 on success); it does
// not synchronise.
int streamz_mfcc_base_frames(const float* pcm, long long B, long long T,
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
      streamz_tc::launch<kForm>(mfcc_frames_kernel, p, B, static_cast<cudaStream_t>(stream)));
}

}  // extern "C"
