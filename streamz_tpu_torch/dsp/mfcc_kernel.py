"""The fused MFCC base kernels K1–K4, hand-written in CUDA for Hopper.

Each replaces one TPU kernel of ``streamz_tpu/dsp/pallas_mfcc.py`` and is the
frontend backend of the same name in :mod:`streamz_tpu_torch.dsp.features`:

==========  ===================  ======================  =====================
Backend     Wrapper              Source (``csrc/``)      Replaces
==========  ===================  ======================  =====================
pallas_v4   ``mfcc_base_v4``     ``mfcc_base.cu`` (K1)   ``_mfcc_kernel_v4``
pallas_v3   ``mfcc_base_v3``     ``mfcc_v3.cu`` (K2)     ``_mfcc_kernel_v3``
pallas_v2   ``mfcc_base_v2``     ``mfcc_v2.cu`` (K3)     ``_mfcc_kernel_v2``
pallas      ``mfcc_base_frames`` ``mfcc_frames.cu`` (K4) ``_mfcc_kernel``
==========  ===================  ======================  =====================

All four run the DFT in bf16x3 on the tensor cores, as the TPU kernels
compute, on one tile design (``wgmma``, ``csrc/mfcc_tc.cuh``) in four forms:
K3 the block-parity DFT with the mel stage in f32, K2 with the mel stage in
bf16x3 too, K1 K2's with the tail bins' squares split before the mel (the
TPU kernel v4's doubled mel rows), and K4 the frame-major 800-tap DFT with
the mel stage in f32.  They stream the DFT basis (and K1 and K2 their mel
weights) through shared memory in the stage order and layout that the host
lays out once: ``kernel_constants()``'s ``"basis_tc"``,
``"frame_basis_tc"`` and ``"mel_tc"``.  :mod:`streamz_tpu_torch._cuda_build`
builds each source with ``nvcc`` for ``sm_90a`` at first use into
``streamz_tpu_torch/_build/`` and loads its plain C entry point with
``ctypes``; kernels launch on PyTorch's current stream.

Every wrapper takes a [B, T] f32 PCM batch and returns the base MFCCs
[B, max(T//400 - 1, 0), 20].  A CUDA tensor launches the kernel or raises;
a CPU tensor runs the kernel's plain PyTorch version instead, because there
is no kernel to run there: :func:`mfcc_base_bf16x3_plain` (K1, K2, K3) and
:func:`mfcc_base_frames_plain` (K4).  Clips shorter than two blocks give an
empty [B, 0, 20] without a launch.  Each wrapper counts its kernel launches
in ``.launches``.
"""

from __future__ import annotations

import ctypes
from functools import lru_cache
from typing import Callable

import numpy as np
import torch

from streamz_tpu_torch import _cuda_build, config
from streamz_tpu_torch.dsp import mel as melmod
from streamz_tpu_torch.dsp import mfcc

SOURCE = _cuda_build.source("mfcc_base")
SOURCES = {"K1": "mfcc_base", "K2": "mfcc_v3", "K3": "mfcc_v2", "K4": "mfcc_frames"}
BUILD_DIR = _cuda_build.BUILD_DIR
NVCC_FLAGS = _cuda_build.NVCC_FLAGS

_GROUP_BINS = 64  # must match kStripBins (mfcc_tc.cuh)
_GROUPS = 7       # must match kStrips
_MEL_COLS = 32    # must match kMelCols
_TAIL = 384       # K1's tail bins 384..400: the TPU kernel v4's _T0
_WIN = config.WINDOW_SIZE
_BLOCK = config.HOP_SIZE

# Argument types of each source's launch entry after (pcm, B, T): the
# constants' pointers, then out and the stream.
_ENTRIES = {
    "mfcc_base": ("streamz_mfcc_base_v4", 3),
    "mfcc_frames": ("streamz_mfcc_base_frames", 6),
    "mfcc_v2": ("streamz_mfcc_base_v2", 6),
    "mfcc_v3": ("streamz_mfcc_base_v3", 3),
}
_SMEM = {
    "mfcc_base": "streamz_mfcc_base_v4_smem_bytes",
    "mfcc_frames": "streamz_mfcc_frames_smem_bytes",
    "mfcc_v2": "streamz_mfcc_v2_smem_bytes",
    "mfcc_v3": "streamz_mfcc_v3_smem_bytes",
}


def _library(name: str = "mfcc_base") -> ctypes.CDLL:
    def declare(lib: ctypes.CDLL) -> None:
        p, i64 = ctypes.c_void_p, ctypes.c_longlong
        entry, n_consts = _ENTRIES[name]
        fn = getattr(lib, entry)
        fn.argtypes = [p, i64, i64, *([p] * n_consts), p, p]
        fn.restype = ctypes.c_int
        smem = getattr(lib, _SMEM[name])
        smem.argtypes = []
        smem.restype = ctypes.c_int

    return _cuda_build.load(name, declare)


def smem_bytes(name: str = "mfcc_base") -> int:
    """Shared memory one block of ``csrc/<name>.cu`` uses (builds it if
    needed)."""
    return int(getattr(_library(name), _SMEM[name])())


# ---------------------------------------------------------------------------
# Host constants of the kernels' layouts.
# ---------------------------------------------------------------------------


def _grouped(cos: np.ndarray, sin: np.ndarray) -> np.ndarray:
    """[taps, 401] cos and -sin bases → [taps, 896] f32 in 7 groups of 64
    bins, each group's 64 cos columns then its 64 -sin columns; bins
    401..447 are zero."""
    taps, nbins = cos.shape
    padded = _GROUPS * _GROUP_BINS
    basis = np.zeros((taps, _GROUPS, 2, _GROUP_BINS), np.float32)
    for part, src in enumerate((cos, sin)):
        full = np.zeros((taps, padded))
        full[:, :nbins] = src
        basis[:, :, part, :] = full.reshape(taps, _GROUPS, _GROUP_BINS)
    return basis.reshape(taps, -1)


def _frame_dft() -> tuple:
    """Full-window real-DFT basis, cos and -sin, [800, 401] float64
    (``pallas_mfcc.py:82-87``)."""
    n = np.arange(_WIN)[:, None]
    k = np.arange(config.N_FFT_BINS)[None, :]
    ang = 2.0 * np.pi * k * n / _WIN
    return np.cos(ang), -np.sin(ang)


def _bf16_bits(a: np.ndarray) -> tuple:
    """:func:`bf16_split` of a host array as two uint16 arrays of bf16 bits."""
    return tuple(p.view(torch.int16).numpy().view(np.uint16)
                 for p in bf16_split(torch.from_numpy(np.asarray(a, np.float32))))


def _swizzle32(blocks: np.ndarray) -> np.ndarray:
    """[..., rows, 2, 8] K-major blocks of 16 k in wgmma's 32-byte swizzle:
    the two 16-byte halves of row n swapped when n // 4 is odd."""
    rows = blocks.shape[-3]
    odd = (np.arange(rows) >> 2) & 1 == 1
    out = blocks.copy()
    out[..., odd, :, :] = blocks[..., odd, ::-1, :]
    return out


def tc_basis_stages(basis: np.ndarray) -> np.ndarray:
    """A [taps, 896] grouped basis as the tile's ring stages: uint16 bf16
    bits [7 strips, taps / 16 k16 steps, 4096] (the [400, 896] block basis
    for K1-K3, the [800, 896] frame basis for K4).  A stage is the hi plane
    then the lo plane of one strip's 128 columns (cos | -sin) at 16 k, each a
    K-major block: column n's 16 k in 32 bytes at 32 n, in wgmma's 32-byte
    swizzle (:func:`_swizzle32`)."""
    steps = basis.shape[0] // 16
    planes = []
    for plane in _bf16_bits(basis):
        # [k = (step, k8, kk), col = (strip, n)] -> [strip, step, n, k8, kk]
        p = plane.reshape(steps, 2, 8, _GROUPS, 128).transpose(3, 0, 4, 1, 2)
        planes.append(_swizzle32(p).reshape(_GROUPS, steps, -1))
    return np.ascontiguousarray(np.concatenate(planes, axis=2))


def tc_mel_stages(mel_dense: np.ndarray) -> np.ndarray:
    """The [448, 32] dense filterbank as K2's and K1's mel stages: uint16
    bf16 bits [7 strips, 4096], the hi plane then the lo plane of the
    strip's 64 bins x 32 mels as four K-major blocks of 16 bins (1 KB each):
    mel n's 16 bins in 32 bytes at 32 n, in wgmma's 32-byte swizzle.  K1
    reads strip 6's four blocks twice, under its tail's re^2 and im^2
    planes: the TPU kernel v4's doubled mel rows 384..511."""
    planes = []
    for plane in _bf16_bits(mel_dense):
        # [bin = (strip, step, k8, kk), mel n] -> [strip, step, n, k8, kk]
        p = plane.reshape(_GROUPS, 4, 2, 8, _MEL_COLS).transpose(0, 1, 4, 2, 3)
        planes.append(_swizzle32(p).reshape(_GROUPS, -1))
    return np.ascontiguousarray(np.concatenate(planes, axis=1))


def kernel_constants() -> dict:
    """Host (numpy) constants of the kernels' layouts.

    - ``basis`` [400, 896]: the block basis in 7 groups of 64 bins, each
      group's 64 cos columns then its 64 -sin columns.
    - ``basis_tc`` [7, 25, 4096] uint16: its bf16 hi/lo split as K1's, K2's
      and K3's ring stages (:func:`tc_basis_stages`).
    - ``frame_basis`` [800, 896]: the full-window basis, same grouping.
    - ``frame_basis_tc`` [7, 50, 4096] uint16: its split as K4's stages.
    - ``fbw``: the mel weights, each filter's contiguous nonzero bin range
      [``mel_lo[m]``, ``mel_hi[m]``) stored from offset ``mel_off[m]``.
    - ``mel_dense`` [448, 32]: the filterbank transposed and zero padded.
    - ``mel_tc`` [7, 4096] uint16: its bf16 hi/lo split as K2's and K1's mel
      stages (:func:`tc_mel_stages`).
    - ``dct`` [20, 26]: the unnormalized DCT-II.
    """
    ct, st = melmod.dft_block_matrices()
    fb = melmod.mel_filterbank()  # [26, 401]
    lo, hi, off, weights = [], [], [], []
    for row in fb:
        nz = np.flatnonzero(row > 0)
        a, b = (int(nz[0]), int(nz[-1]) + 1) if nz.size else (0, 0)
        lo.append(a)
        hi.append(b)
        off.append(len(weights))
        weights.extend(row[a:b])
    mel_dense = np.zeros((_GROUPS * _GROUP_BINS, _MEL_COLS), np.float32)
    mel_dense[: fb.shape[1], : fb.shape[0]] = fb.T
    basis = _grouped(ct, st)
    frame_basis = _grouped(*_frame_dft())
    return {
        "basis": basis,
        "basis_tc": tc_basis_stages(basis),
        "frame_basis": frame_basis,
        "frame_basis_tc": tc_basis_stages(frame_basis),
        "fbw": np.asarray(weights, np.float32),
        "mel_lo": np.asarray(lo, np.int32),
        "mel_hi": np.asarray(hi, np.int32),
        "mel_off": np.asarray(off, np.int32),
        "mel_dense": mel_dense,
        "mel_tc": tc_mel_stages(mel_dense),
        "dct": np.asarray(melmod.dct2_matrix(), np.float32),
    }


def bf16_split(a: torch.Tensor):
    """hi/lo bf16 planes of an f32 tensor, hi = bf16(a), lo = bf16(a - hi),
    both rounded to nearest even (``pallas_mfcc.py:46-56``)."""
    a = a.to(torch.float32)
    hi = a.to(torch.bfloat16)
    return hi, (a - hi.to(torch.float32)).to(torch.bfloat16)


@lru_cache(maxsize=16)
def _device_constants(device: torch.device, name: str):
    """The constants each source's launch entry takes, in its order."""
    c = kernel_constants()

    def t(key):
        a = np.ascontiguousarray(c[key])
        if a.dtype == np.uint16:  # bf16 bits
            return torch.from_numpy(a.view(np.int16)).view(torch.bfloat16).to(device)
        return torch.from_numpy(a).to(device)

    sparse_mel = (t("fbw"), t("mel_lo"), t("mel_hi"), t("mel_off"))
    if name == "mfcc_frames":
        return (t("frame_basis_tc"), *sparse_mel, t("dct"))
    if name == "mfcc_v2":
        return (t("basis_tc"), *sparse_mel, t("dct"))
    return (t("basis_tc"), t("mel_tc"), t("dct"))


# ---------------------------------------------------------------------------
# The plain versions: K1, K2, K3 (block parity) and K4 (frame-major).
# ---------------------------------------------------------------------------


@lru_cache(maxsize=8)
def _frame_constants(device: torch.device) -> torch.Tensor:
    cos, sin = _frame_dft()
    return torch.as_tensor(np.concatenate([cos, sin], axis=1), dtype=torch.float32,
                           device=device)


def _log_mel_dct(power: torch.Tensor, mel_e: torch.Tensor = None) -> torch.Tensor:
    _, _, fb_t, dct_t = mfcc._constants(power.device)
    if mel_e is None:
        mel_e = power @ fb_t
    return torch.log(torch.clamp(mel_e, min=1e-12)) @ dct_t


def _planes(a: torch.Tensor):
    """``bf16_split`` as f32 tensors, whose products are exact in f32."""
    hi, lo = bf16_split(a)
    return hi.to(torch.float32), lo.to(torch.float32)


def _bf16x3(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a @ b in bf16x3: a_hi b_hi + a_hi b_lo + a_lo b_hi as f32 matmuls of
    bf16 values, the TPU kernels' three products."""
    ah, al = _planes(a)
    bh, bl = _planes(b)
    return ah @ bh + ah @ bl + al @ bh


def mfcc_base_frames_plain(pcm: torch.Tensor) -> torch.Tensor:
    """K4's function in plain PyTorch: each 800-sample window (hop 400) times
    the full-window [800, 802] cos | -sin basis in bf16x3, then power, mel,
    log and DCT in f32.  The same products as the kernel, summed in another
    order.  pcm: [B, T] f32 → [B, max(T//400 - 1, 0), 20]."""
    B, T = pcm.shape
    nb = T // _BLOCK
    if nb < 2:
        return pcm.new_zeros((B, 0, config.MFCC_SIZE))
    frames = pcm[:, : nb * _BLOCK].unfold(1, _WIN, _BLOCK)  # [B, nb-1, 800]
    parts = _bf16x3(frames, _frame_constants(pcm.device))
    nbins = config.N_FFT_BINS
    re, im = parts[..., :nbins], parts[..., nbins:]
    return _log_mel_dct(re * re + im * im)


def mfcc_base_bf16x3_plain(pcm: torch.Tensor, mel_bf16x3: bool,
                           tail_fold: bool = False) -> torch.Tensor:
    """K1's, K2's and K3's function in plain PyTorch: the block-parity DFT
    in bf16x3, the parity combine and power, then the mel product in bf16x3
    (``mel_bf16x3=True``: K2, and K1 with ``tail_fold``) or in f32 (K3), log
    and DCT in f32.  ``tail_fold`` takes the TPU kernel v4's tail: for bins
    384..400 re^2 and im^2 meet the filterbank each in bf16x3 instead of
    their f32 sum.  The same products as the kernels, summed in another
    order.  pcm: [B, T] f32 → [B, max(T//400 - 1, 0), 20]."""
    dft_top, sign, fb_t, _ = mfcc._constants(pcm.device)
    B, T = pcm.shape
    nb = T // _BLOCK
    nbins = config.N_FFT_BINS
    parts = _bf16x3(pcm[:, : nb * _BLOCK].reshape(B, nb, _BLOCK), dft_top)  # [B, nb, 802]
    cos_p, sin_p = parts[..., :nbins], parts[..., nbins:]
    re = cos_p[:, :-1] + sign * cos_p[:, 1:]
    im = sin_p[:, :-1] + sign * sin_p[:, 1:]
    power = re * re + im * im
    if not mel_bf16x3:
        return _log_mel_dct(power)
    if not tail_fold:
        return _log_mel_dct(power, _bf16x3(power, fb_t))
    re_t, im_t = re[..., _TAIL:], im[..., _TAIL:]
    mel_e = (_bf16x3(power[..., :_TAIL], fb_t[:_TAIL])
             + _bf16x3(re_t * re_t, fb_t[_TAIL:]) + _bf16x3(im_t * im_t, fb_t[_TAIL:]))
    return _log_mel_dct(power, mel_e)


# ---------------------------------------------------------------------------
# The wrappers.
# ---------------------------------------------------------------------------


def _launch(kid: str, name: str, pcm: torch.Tensor, wrapper) -> torch.Tensor:
    """Check a CUDA PCM batch, launch ``csrc/<name>.cu`` on it and count the
    launch on ``wrapper``; raises on anything it cannot take or a CUDA
    error."""
    if pcm.device.type != "cuda":
        raise ValueError(f"{kid} runs on CUDA or CPU tensors, got {pcm.device}")
    if pcm.dtype != torch.float32 or pcm.dim() != 2:
        raise ValueError(
            f"{kid} takes a [B, T] float32 tensor, got {pcm.dtype} {tuple(pcm.shape)}"
        )
    if not pcm.is_contiguous():
        raise ValueError(f"{kid} takes a contiguous [B, T] tensor")
    B, T = pcm.shape
    nb = T // _BLOCK
    shape = (B, max(nb - 1, 0), config.MFCC_SIZE)
    if B == 0 or nb < 2:
        return torch.empty(shape, dtype=torch.float32, device=pcm.device)
    out = torch.empty(shape, dtype=torch.float32, device=pcm.device)
    consts = _device_constants(pcm.device, name)
    lib = _library(name)
    with torch.cuda.device(pcm.device):
        stream = torch.cuda.current_stream(pcm.device).cuda_stream
        rc = getattr(lib, _ENTRIES[name][0])(
            pcm.data_ptr(), B, T, *(c.data_ptr() for c in consts), out.data_ptr(),
            stream,
        )
    if rc != 0:
        raise RuntimeError(f"{kid} ({wrapper.__name__}) launch failed: CUDA error {rc}")
    wrapper.launches += 1
    return out


def mfcc_base_v4(pcm: torch.Tensor) -> torch.Tensor:
    """K1 (backend ``'pallas_v4'``): K2 with the TPU kernel v4's tail."""
    if pcm.device.type == "cpu":
        return mfcc_base_bf16x3_plain(pcm, True, tail_fold=True)
    return _launch("K1", "mfcc_base", pcm, mfcc_base_v4)


def mfcc_base_v3(pcm: torch.Tensor) -> torch.Tensor:
    """K2 (backend ``'pallas_v3'``): bf16x3 DFT and mel on the tensor cores."""
    if pcm.device.type == "cpu":
        return mfcc_base_bf16x3_plain(pcm, True)
    return _launch("K2", "mfcc_v3", pcm, mfcc_base_v3)


def mfcc_base_v2(pcm: torch.Tensor) -> torch.Tensor:
    """K3 (backend ``'pallas_v2'``): bf16x3 DFT on the tensor cores, f32 mel."""
    if pcm.device.type == "cpu":
        return mfcc_base_bf16x3_plain(pcm, False)
    return _launch("K3", "mfcc_v2", pcm, mfcc_base_v2)


def mfcc_base_frames(pcm: torch.Tensor) -> torch.Tensor:
    """K4 (backend ``'pallas'``): bf16x3 frame-major 800-tap DFT, f32 mel."""
    if pcm.device.type == "cpu":
        return mfcc_base_frames_plain(pcm)
    return _launch("K4", "mfcc_frames", pcm, mfcc_base_frames)


WRAPPERS = {"K1": mfcc_base_v4, "K2": mfcc_base_v3, "K3": mfcc_base_v2,
            "K4": mfcc_base_frames}
for _w in WRAPPERS.values():
    _w.launches = 0


def _features(base: Callable[[torch.Tensor], torch.Tensor]):
    def core(pcm: torch.Tensor, n_samples: torch.Tensor) -> torch.Tensor:
        return mfcc.deltas_and_norm(base(pcm), mfcc.window_count(n_samples))

    core.__name__ = core.__qualname__ = base.__name__.replace("_base", "_features")
    core.__doc__ = (f"Full frontend through ``{base.__name__}``: [B, T] + [B] "
                    "lengths → [B, W, 60].")
    return core


mfcc_features_v4 = _features(mfcc_base_v4)
mfcc_features_v3 = _features(mfcc_base_v3)
mfcc_features_v2 = _features(mfcc_base_v2)
mfcc_features_frames = _features(mfcc_base_frames)
