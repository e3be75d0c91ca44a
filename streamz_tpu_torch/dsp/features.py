"""FeatureExtractor facade + the ``feature_cache/*.npy`` load-or-compute layer.

The port of ``streamz_tpu/dsp/features.py`` (reference
``streamz-rs/src/lib.rs:231-276``, ``:558-579``).  Backends:

- ``'auto'`` (default): the frontend through K1
  (:func:`streamz_tpu_torch.dsp.mfcc_kernel.mfcc_features_v4`).  On a CUDA
  device that runs the hand-written kernel, with no fallback; on the CPU the
  kernel's wrapper runs the plain formulation, since there is no kernel
  there.  Unlike the JAX package, ``'auto'`` is not a measured choice.
- ``'plain'``: the plain PyTorch formulation, the counterpart of the JAX
  package's ``'jax'`` backend; it runs on the card only when asked for by
  name.
- ``'numpy'``: the host golden spec, not yet ported.
"""

from __future__ import annotations

import os
import tempfile
from typing import List, Sequence

import numpy as np

from streamz_tpu_torch.device import resolve_device
from streamz_tpu_torch.dsp import mfcc, mfcc_kernel
from streamz_tpu_torch.io import audio

_BACKENDS = ("auto", "plain", "numpy")


class FeatureExtractor:
    """Stateless MFCC frontend facade bound to one device (``cuda`` unless
    ``'cpu'`` is asked for)."""

    def __init__(self, backend: str = "auto", device=None):
        if backend not in _BACKENDS:
            raise ValueError(f"unknown backend {backend!r}")
        if backend == "numpy":
            raise NotImplementedError(
                "the 'numpy' frontend backend is not yet ported to "
                "streamz_tpu_torch"
            )
        self.backend = backend
        self.device = resolve_device(device)

    def _core(self):
        if self.backend == "plain":
            return mfcc.mfcc_features
        return mfcc_kernel.mfcc_features_v4

    def extract(self, samples: np.ndarray) -> np.ndarray:
        """PCM (i16 or f32) → [n_windows, 60] float32."""
        return self.extract_batch([samples])[0]

    def extract_batch(self, clips: Sequence[np.ndarray]) -> List[np.ndarray]:
        """Batched extraction: one frontend call per padded-length bucket."""
        return mfcc.extract_features_batch(
            clips, core=self._core(), device=self.device
        )


def save_cached_features(path: str, feats: np.ndarray) -> None:
    """Publish ``feature_cache/<sanitized>.npy`` atomically (temp + rename
    in the cache dir): a concurrent reader must never observe a
    partially-written .npy."""
    cache = audio.feature_cache_path(path)
    fd, tmp = tempfile.mkstemp(
        prefix=cache.name + ".", suffix=".tmp", dir=str(cache.parent)
    )
    try:
        with os.fdopen(fd, "wb") as f:
            np.save(f, feats)
        os.replace(tmp, cache)
    except BaseException:
        try:
            os.unlink(tmp)
        except OSError:
            pass
        raise


def load_cached_features(path: str, extractor: FeatureExtractor) -> np.ndarray:
    """Load ``feature_cache/<sanitized>.npy`` or compute+store it
    (src/lib.rs:558-579).  Returns [n_windows, 60] float32."""
    cache = audio.feature_cache_path(path)
    if cache.exists():
        try:
            return np.load(cache).astype(np.float32)
        except (OSError, ValueError):
            # Torn cache file (a writer interrupted mid-save): recompute
            # and overwrite instead of failing every later run.
            pass
    feats = extractor.extract(audio.load_audio_samples(path))
    save_cached_features(path, feats)
    return feats
