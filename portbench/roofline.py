"""The least time an NVIDIA H100 could take for the work of a run.

Frozen from ``chip_smoke.py`` (``bound``, ``mlp_row_ops``,
``mfcc_tc_ops_and_bytes``, ``k5_ops_and_bytes``, ``k6_ops_and_bytes`` and
the ``PEAK_*`` constants) at commit 9a1a12a3fe3c, and recounted: the work
is the function's, counted from its shapes, not the formulation's.  The
copy counted three bf16 products for K1's bf16x3, three TF32 products for
K5's 3xTF32 and the frontend's DFT as dense products with a cosine and a
sine basis, so a kernel that kept the precision by another formulation
would have read a stale share.  Here:

- a product that the configuration states in FP32 (K5, K6, the MLP, the
  frontend's mel filterbank over its nonzero weights and its DCT) is
  counted once, at the TF32 peak over 3 (165 TFLOP/s): the fastest rate at
  which the card keeps FP32 accuracy on its tensor cores;
- the frontend's 800-point real DFT is counted as an FFT, 2.5 N log2 N
  operations a window, at the 67 TFLOP/s of FP32 on the CUDA cores, as is
  the rest (the power of the bins, the log, the SGD updates);
- bytes at 3.35 TB/s, each input read once and each output written once.

The least time is the larger of the operations' time and the bytes' time.
At the benchmark's shapes the frontend's bytes bound it: its PCM is read
once, whatever the formulation.  Peaks: NVIDIA's H100 SXM data sheet,
dense, at 700 W.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Iterable, Sequence, Tuple

import numpy as np

PEAK_FP32 = 67e12
PEAK_TF32 = 495e12
PEAK_BYTES = 3.35e12
PEAK_FP32_TC = PEAK_TF32 / 3      # FP32 accuracy on the tensor cores

WINDOW, HOP, N_BINS, N_MELS, N_MFCC = 800, 400, 401, 26, 20
MEL_NONZERO = 741                 # nonzero weights of the 26 x 401 filterbank
FFT_OPS = 2.5 * WINDOW * math.log2(WINDOW)   # one 800-point real FFT


@dataclass
class Work:
    """Operations by rate class and bytes."""

    fp32: float = 0.0       # on the CUDA cores
    fp32_tc: float = 0.0    # FP32-accurate products on the tensor cores
    nbytes: float = 0.0

    def __add__(self, o: "Work") -> "Work":
        return Work(self.fp32 + o.fp32, self.fp32_tc + o.fp32_tc, self.nbytes + o.nbytes)

    def seconds(self) -> float:
        """The least time: operations or bytes, whichever bounds."""
        t_ops = self.fp32 / PEAK_FP32 + self.fp32_tc / PEAK_FP32_TC
        return max(t_ops, self.nbytes / PEAK_BYTES)


def total(works: Iterable[Work]) -> Work:
    out = Work()
    for w in works:
        out = out + w
    return out


def n_params(dims: Tuple[int, int, int, int]) -> int:
    F, H1, H2, cap = dims
    return F * H1 + H1 + H1 * H2 + H2 + H2 * cap + cap


def mlp_row_ops(dims: Tuple[int, int, int, int]) -> int:
    """Operations (2 per multiply-add) of one row's forward, its data
    backward (dh2, dh1) and its weight gradients; the elementwise work,
    under 1% of it, is not counted."""
    F, H1, H2, cap = dims
    fwd = F * H1 + H1 * H2 + H2 * cap
    return 2 * (fwd + (cap * H2 + H2 * H1) + fwd)


def frontend(window_counts: Sequence[int], samples: int) -> Work:
    """The MFCC base (the function of K1 and K2) of clips with these window
    counts and ``samples`` PCM samples in all: per window an 800-point real
    FFT, the power of its 401 bins, the filterbank over its nonzero weights,
    log and the DCT; the PCM read once, 20 coefficients a window written,
    the filterbank's weights and the DCT's matrix read once."""
    wins = int(sum(window_counts))
    fft = wins * FFT_OPS
    power = wins * N_BINS * 3
    products = 2 * wins * (MEL_NONZERO + N_MELS * N_MFCC)
    nbytes = 4 * (samples + wins * N_MFCC + MEL_NONZERO + N_MELS * N_MFCC)
    return Work(fp32=fft + power + wins * N_MELS, fp32_tc=products, nbytes=nbytes)


def corpus_steps(rows_per_step: Sequence[int], batch: int,
                 dims: Tuple[int, int, int, int]) -> Work:
    """K5's function over steps: each step's forward, backward and
    gradients over the rows that carry weight, and its update; per step the
    batch (60 features, a label, a weight a row) and the parameters read
    once, the parameters written once."""
    rows = int(sum(rows_per_step))
    steps = len(rows_per_step)
    npar = n_params(dims)
    F = dims[0]
    return Work(fp32=2 * npar * steps, fp32_tc=rows * mlp_row_ops(dims),
                nbytes=4 * steps * (batch * (F + 2) + 2 * npar))


def file_train(masks: np.ndarray, dims: Tuple[int, int, int, int]) -> Work:
    """K6's function on one file: the rows that survive, and each
    surviving chunk's update; chunks, masks and the target read once, the
    parameters read and written once.  ``masks`` is [chunks, batch]."""
    masks = np.asarray(masks)
    F, cap = dims[0], dims[3]
    npar = n_params(dims)
    rows = int((masks > 0).sum())
    live = int((masks.sum(axis=1) > 0).sum())
    S, B = masks.shape
    return Work(fp32=live * 2 * npar, fp32_tc=rows * mlp_row_ops(dims),
                nbytes=4 * (S * B * (F + 1) + cap + 2 * npar))


def embed_windows(windows: int, dims: Tuple[int, int, int, int]) -> Work:
    """The ReLU-h2 embedding of ``windows`` windows: the first two layers'
    products; windows and both layers read once, the embeddings written."""
    F, H1, H2, _ = dims
    return Work(fp32_tc=2 * windows * (F * H1 + H1 * H2),
                nbytes=4 * (windows * (F + H2) + F * H1 + H1 + H1 * H2 + H2))
