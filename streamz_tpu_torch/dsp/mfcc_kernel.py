"""K1, the fused MFCC base, as a hand-written CUDA kernel for Hopper.

Replaces ``streamz_tpu/dsp/pallas_mfcc.py:_mfcc_kernel_v4`` (through
``_v4_call`` / ``mfcc_base_pallas_v4``).  The kernel source is
``streamz_tpu_torch/csrc/mfcc_base.cu``; :mod:`streamz_tpu_torch._cuda_build`
builds it with ``nvcc`` for ``sm_90a`` at first use into
``streamz_tpu_torch/_build/`` and loads its plain C entry point with
``ctypes``; it is launched on PyTorch's current stream.

:func:`mfcc_base_v4` takes a [B, T] f32 PCM batch and returns the base
MFCCs [B, T//400 - 1, 20].  A CUDA tensor launches the kernel or raises; a
CPU tensor runs the plain formulation
(:func:`streamz_tpu_torch.dsp.mfcc.mfcc_base`) instead, because there is no
kernel to run there.  ``mfcc_base_v4.launches`` counts kernel launches.
"""

from __future__ import annotations

import ctypes
from functools import lru_cache
from pathlib import Path

import numpy as np
import torch

from streamz_tpu_torch import _cuda_build, config
from streamz_tpu_torch.dsp import mel as melmod
from streamz_tpu_torch.dsp import mfcc

SOURCE = _cuda_build.source("mfcc_base")
BUILD_DIR = _cuda_build.BUILD_DIR
NVCC_FLAGS = _cuda_build.NVCC_FLAGS

_GROUP_BINS = 64  # must match kGroupBins in the .cu source
_GROUPS = 7       # must match kGroups

build_log = ""


def build() -> Path:
    """Compile ``csrc/mfcc_base.cu`` unless the library built from this
    source, these flags and this ``nvcc`` exists.  The compiler's report
    (registers, shared memory, spills) is kept in :data:`build_log`."""
    global build_log
    lib = _cuda_build.build("mfcc_base")
    build_log = _cuda_build.build_logs.get("mfcc_base", build_log)
    return lib


def _declare(lib: ctypes.CDLL) -> None:
    p, i64 = ctypes.c_void_p, ctypes.c_longlong
    lib.streamz_mfcc_base_v4.argtypes = [p, i64, i64, p, p, p, p, p, p, p, p]
    lib.streamz_mfcc_base_v4.restype = ctypes.c_int
    lib.streamz_mfcc_base_v4_smem_bytes.argtypes = []
    lib.streamz_mfcc_base_v4_smem_bytes.restype = ctypes.c_int


def _library() -> ctypes.CDLL:
    return _cuda_build.load("mfcc_base", _declare)


def smem_bytes() -> int:
    """Shared memory one K1 block uses (builds the kernel if needed)."""
    return int(_library().streamz_mfcc_base_v4_smem_bytes())


def kernel_constants() -> dict:
    """Host (numpy) constants of the kernel's layout.

    - ``basis`` [400, 896]: 7 groups of 64 bins, each group's 64 cos columns
      then its 64 (negated) sin columns; bins 401..447 are zero.
    - ``fbw``: the mel weights, each filter's contiguous nonzero bin range
      [``mel_lo[m]``, ``mel_hi[m]``) stored from offset ``mel_off[m]``.
    - ``dct`` [20, 26]: the unnormalized DCT-II.
    """
    ct, st = melmod.dft_block_matrices()
    nbins = ct.shape[1]
    padded = _GROUPS * _GROUP_BINS
    basis = np.zeros((config.HOP_SIZE, _GROUPS, 2, _GROUP_BINS), np.float32)
    for part, src in enumerate((ct, st)):
        full = np.zeros((config.HOP_SIZE, padded))
        full[:, :nbins] = src
        basis[:, :, part, :] = full.reshape(config.HOP_SIZE, _GROUPS, _GROUP_BINS)
    fb = melmod.mel_filterbank()  # [26, 401]
    lo, hi, off, weights = [], [], [], []
    for row in fb:
        nz = np.flatnonzero(row > 0)
        a, b = (int(nz[0]), int(nz[-1]) + 1) if nz.size else (0, 0)
        lo.append(a)
        hi.append(b)
        off.append(len(weights))
        weights.extend(row[a:b])
    return {
        "basis": basis.reshape(config.HOP_SIZE, -1),
        "fbw": np.asarray(weights, np.float32),
        "mel_lo": np.asarray(lo, np.int32),
        "mel_hi": np.asarray(hi, np.int32),
        "mel_off": np.asarray(off, np.int32),
        "dct": np.asarray(melmod.dct2_matrix(), np.float32),
    }


@lru_cache(maxsize=8)
def _device_constants(device: torch.device):
    c = kernel_constants()
    return tuple(
        torch.from_numpy(np.ascontiguousarray(c[k])).to(device)
        for k in ("basis", "fbw", "mel_lo", "mel_hi", "mel_off", "dct")
    )


def mfcc_base_v4(pcm: torch.Tensor) -> torch.Tensor:
    """K1: [B, T] f32 PCM → [B, max(T//400 - 1, 0), 20] base MFCCs.

    A CUDA tensor launches the kernel (or raises); a CPU tensor runs the
    plain formulation.  Clips shorter than two blocks give an empty
    [B, 0, 20] without a launch.
    """
    if pcm.device.type == "cpu":
        return mfcc.mfcc_base(pcm)
    if pcm.device.type != "cuda":
        raise ValueError(f"K1 runs on CUDA or CPU tensors, got {pcm.device}")
    if pcm.dtype != torch.float32 or pcm.dim() != 2:
        raise ValueError(
            f"K1 takes a [B, T] float32 tensor, got {pcm.dtype} {tuple(pcm.shape)}"
        )
    if not pcm.is_contiguous():
        raise ValueError("K1 takes a contiguous [B, T] tensor")
    B, T = pcm.shape
    nb = T // config.HOP_SIZE
    if B == 0 or nb < 2:
        return torch.empty(
            (B, max(nb - 1, 0), config.MFCC_SIZE), dtype=torch.float32,
            device=pcm.device,
        )
    out = torch.empty(
        (B, nb - 1, config.MFCC_SIZE), dtype=torch.float32, device=pcm.device
    )
    consts = _device_constants(pcm.device)
    lib = _library()
    with torch.cuda.device(pcm.device):
        stream = torch.cuda.current_stream(pcm.device).cuda_stream
        rc = lib.streamz_mfcc_base_v4(
            pcm.data_ptr(), B, T, *(c.data_ptr() for c in consts),
            out.data_ptr(), stream,
        )
    if rc != 0:
        raise RuntimeError(f"K1 (mfcc_base_v4) launch failed: CUDA error {rc}")
    mfcc_base_v4.launches += 1
    return out


mfcc_base_v4.launches = 0


def mfcc_features_v4(pcm: torch.Tensor, n_samples: torch.Tensor) -> torch.Tensor:
    """Full frontend through K1: [B, T] + [B] lengths → [B, W, 60]."""
    return mfcc.deltas_and_norm(mfcc_base_v4(pcm), mfcc.window_count(n_samples))
