"""Numpy golden-spec MFCC extractor.

Frozen copy of ``streamz_tpu_torch/dsp/mfcc_ref.py`` at commit 9a1a12a3fe3c, for the
benchmark's plain reference: it imports nothing of the port, and a later
change to the port does not change it.

The port's own copy of ``streamz_tpu/dsp/mfcc_ref.py``: a line-faithful
executable specification of the reference feature pipeline
(``streamz-rs/src/lib.rs:279-345``).  It is the ``'numpy'`` frontend backend
and the CPU baseline of the bench twin (:mod:`streamz_tpu_torch.bench`):

per 800-sample window, hop 400 (rectangular window, no pre-emphasis):
  forward complex FFT(800) → one-sided power spectrum (|X|^2, 401 bins)
  → mel filterbank dot (26 Slaney-normalized triangles)
  → ln(max(x, 1e-12)) → unnormalized DCT-II(26) → truncate to 20
  → Δ (central difference (next-prev)/2, edge-clamped, src/lib.rs:212-228)
  → ΔΔ → concat 60 → per-frame z-norm (mean/std over the 60 dims,
  population variance, std floor 1e-6).
"""

from __future__ import annotations

import numpy as np

from portbench.reference import config
from portbench.reference import mel as melmod


def _add_deltas(mfcc: np.ndarray) -> np.ndarray:
    """Edge-clamped central difference over the frame axis (src/lib.rs:212-228)."""
    if len(mfcc) == 0:
        return mfcc
    prev = np.vstack([mfcc[:1], mfcc[:-1]])
    nxt = np.vstack([mfcc[1:], mfcc[-1:]])
    return (nxt - prev) / 2.0


def extract_features_np(samples: np.ndarray) -> np.ndarray:
    """i16 (or f32 in [-1,1]) PCM → [n_windows, 60] float32 feature windows."""
    samples = np.asarray(samples)
    if samples.dtype == np.int16 or np.issubdtype(samples.dtype, np.integer):
        x = samples.astype(np.float32) / 32767.0
    else:
        x = samples.astype(np.float32)

    w, hop = config.WINDOW_SIZE, config.HOP_SIZE
    if len(x) < w:
        return np.zeros((0, config.FEATURE_SIZE), np.float32)
    n_win = (len(x) - w) // hop + 1
    idx = np.arange(n_win)[:, None] * hop + np.arange(w)[None, :]
    frames = x[idx]  # [n_win, 800]

    spec = np.fft.fft(frames, axis=-1)[:, : w // 2 + 1]
    power = (spec.real ** 2 + spec.imag ** 2).astype(np.float64)

    fb = melmod.mel_filterbank()  # [26, 401]
    mel_e = power @ fb.T
    mel_log = np.log(np.maximum(mel_e, 1e-12))

    dct = melmod.dct2_matrix()  # [20, 26]
    base = mel_log @ dct.T  # [n_win, 20]

    d1 = _add_deltas(base)
    d2 = _add_deltas(d1)
    feats = np.concatenate([base, d1, d2], axis=-1)

    mean = feats.mean(axis=-1, keepdims=True)
    var = ((feats - mean) ** 2).mean(axis=-1, keepdims=True)
    std = np.maximum(np.sqrt(var), 1e-6)
    return ((feats - mean) / std).astype(np.float32)
