"""Global configuration constants for the PyTorch/CUDA port of StreamZ.

The same numerology, model widths, file names and cache toggles as
``streamz_tpu/config.py`` so that feature windows, model shapes and file
formats stay interchangeable between the two packages.  Only what the
``--identify`` slice reads is here; training knobs arrive with the
training slice.

- sample rate / window / mel / MFCC numerology: reference
  ``streamz-rs/src/lib.rs:25-36`` (hop = WINDOW_SIZE/2 at ``src/lib.rs:288``)
- model widths: ``src/main.rs:640``, ``:649``
"""

from __future__ import annotations

import threading

# ---------------------------------------------------------------------------
# Audio / feature numerology (src/lib.rs:25-36)
# ---------------------------------------------------------------------------
DEFAULT_SAMPLE_RATE: int = 44_100
WINDOW_SIZE: int = 800
HOP_SIZE: int = WINDOW_SIZE // 2  # src/lib.rs:288
N_MELS: int = 26
MFCC_SIZE: int = 20
WITH_DELTAS: bool = True
FEATURE_SIZE: int = MFCC_SIZE * 3 if WITH_DELTAS else MFCC_SIZE  # 60
N_FFT_BINS: int = WINDOW_SIZE // 2 + 1  # 401 one-sided power bins

# ---------------------------------------------------------------------------
# Model architecture (src/main.rs:640, :649)
# ---------------------------------------------------------------------------
HIDDEN1: int = 512
HIDDEN2: int = 256  # == embedding size

# ---------------------------------------------------------------------------
# CLI defaults (src/main.rs:21-37)
# ---------------------------------------------------------------------------
MODEL_PATH: str = "model.npz"
DEFAULT_CONF_THRESHOLD: float = 0.8

# Cache directories (src/lib.rs:450, :551)
WAV_CACHE_DIR: str = "cache"
FEATURE_CACHE_DIR: str = "feature_cache"

# ---------------------------------------------------------------------------
# Runtime-toggleable WAV cache switch (thread-safe), mirroring the
# reference's `WAV_CACHE_ENABLED` static (src/lib.rs:67-80).
# ---------------------------------------------------------------------------
_state_lock = threading.Lock()
_wav_cache_enabled: bool = True


def set_wav_cache_enabled(enabled: bool) -> None:
    """Enable/disable writing WAV cache files (src/lib.rs:73-75)."""
    global _wav_cache_enabled
    with _state_lock:
        _wav_cache_enabled = bool(enabled)


def wav_cache_enabled() -> bool:
    """True when WAV caching is enabled (src/lib.rs:78-80)."""
    with _state_lock:
        return _wav_cache_enabled


def next_pow2(n: int) -> int:
    """Smallest power of two >= max(n, 1) — the shared padding policy that
    bounds the number of distinct batch shapes (window buckets, clip
    counts)."""
    p = 1
    while p < n:
        p *= 2
    return p
