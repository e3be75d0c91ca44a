"""Global configuration constants for the PyTorch/CUDA port of StreamZ.

The same numerology, model widths, file names and cache toggles as
``streamz_tpu/config.py`` so that feature windows, model shapes, file
formats, training runs and steganography keys stay interchangeable between
the two packages.

- sample rate / window / mel / MFCC numerology: reference
  ``streamz-rs/src/lib.rs:25-36`` (hop = WINDOW_SIZE/2 at ``src/lib.rs:288``)
- model widths: ``src/main.rs:640``, ``:649``
- training knobs: ``src/main.rs:21-37``
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

# Default dropout probability applied during training (src/lib.rs:36).
DEFAULT_DROPOUT: float = 0.2

# ---------------------------------------------------------------------------
# Model architecture (src/main.rs:640, :649)
# ---------------------------------------------------------------------------
HIDDEN1: int = 512
HIDDEN2: int = 256  # == embedding size

# ---------------------------------------------------------------------------
# CLI / training defaults (src/main.rs:21-37)
# ---------------------------------------------------------------------------
MODEL_PATH: str = "model.npz"
TRAIN_FILE_LIST: str = "train_files.txt"
TARGET_FILE_LIST: str = "target_files.txt"
DEFAULT_CONF_THRESHOLD: float = 0.8
DEFAULT_BURN_IN_FRAC: float = 0.2
TRAIN_EPOCHS: int = 100
BATCH_SIZE: int = 8
INCREMENTAL_EPOCHS: int = 5  # src/main.rs:810
# Learning-rate schedule of the discovery loop (src/main.rs:802): 0.05 for
# the first 1000 processed files, then 0.01.
LR_EARLY: float = 0.05
LR_LATE: float = 0.01
LR_SWITCH_COUNT: int = 1000

# Cache directories (src/lib.rs:450, :551)
WAV_CACHE_DIR: str = "cache"
FEATURE_CACHE_DIR: str = "feature_cache"

# ---------------------------------------------------------------------------
# Steganography (src/lib.rs:39-58)
# ---------------------------------------------------------------------------
CHECKSUM_CONSTANT: str = (
    "4273195488fa01ce67a35d4b90ef3312a5b6c7d8e9f0112233445566778899aa"
    "bbccddeeff102030405060708090a0b0c0d0e0f102132435465768798a9bacbd"
)
STEGO_MAX_EPOCHS: int = 10_000_000  # src/lib.rs:1743
STEGO_LR: float = 0.5  # src/lib.rs:1754
# Payload bound for encode_file.  The trainer's output layer is
# [h2=256, ~8·len] f32, 8192 bytes of weights per payload byte, and the
# block loop on the card keeps two such arrays live (w3 and its rank-1
# update): 128 KiB gives a w3 of 1 GiB and a peak of 2,064 MiB on an NVIDIA
# H100 80GB HBM3 (700 W; chip_smoke.py's [stego] line).  Past this,
# encode_file fails fast with the sizing math.  (The reference's only bound
# is its 10M-epoch budget, src/lib.rs:1717-1772.)
STEGO_MAX_PAYLOAD_BYTES: int = 128 * 1024

# ---------------------------------------------------------------------------
# Runtime-toggleable globals (thread-safe), mirroring the reference's
# `CHECKSUM_OVERRIDE` (src/lib.rs:43-58) and `WAV_CACHE_ENABLED`
# (src/lib.rs:67-80) statics.
# ---------------------------------------------------------------------------
_state_lock = threading.Lock()
_checksum_override: str | None = None
_wav_cache_enabled: bool = True


def set_checksum_constant_override(value: str) -> None:
    """Override the active checksum constant (src/lib.rs:46-49)."""
    global _checksum_override
    with _state_lock:
        _checksum_override = value


def get_checksum_constant() -> str:
    """Active checksum constant, honoring overrides (src/lib.rs:52-58)."""
    with _state_lock:
        return _checksum_override if _checksum_override is not None else CHECKSUM_CONSTANT


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
