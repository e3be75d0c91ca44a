"""Host-side audio ingest: extension dispatch, downmix, resample, caching.

The port's copy of the ``streamz_tpu/io/audio.py`` contracts:

- ``load_wav_samples`` and ``load_mp3_samples`` (``streamz-rs/src/lib.rs:401-444``)
- ``load_and_resample_file`` (``src/lib.rs:509-538``)
- ``load_audio_samples`` with the ``cache/<stem>.wav`` MP3 cache
  (``src/lib.rs:448-488``)
- ``audio_metadata``, including its quirk of always reporting 44100
  (``src/lib.rs:492-505``)
- ``batch_resample`` parallel loader that silently drops failures
  (``src/lib.rs:541-547``), on a Python thread pool
- ``cache_mp3_as_wav``/``precache_mp3_files``/``precache_target_files`` and
  the SHA-512 steganography trigger (``src/main.rs:138-214``)
- feature cache path scheme (``src/lib.rs:550-579``)

The JAX package also has a C++ batch-ingest runtime for ``batch_resample``,
bit-identical to the thread-pool path; it is not ported yet.
"""

from __future__ import annotations

import hashlib
import os
import threading
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path
from typing import List, Optional, Tuple

import numpy as np

from streamz_tpu_torch import config
from streamz_tpu_torch.dsp.resample import resample_to_44100
from streamz_tpu_torch.io import mp3 as mp3io
from streamz_tpu_torch.io import wav as wavio

# Set when an ingested MP3's SHA-512 matches the active checksum constant
# (src/main.rs:39, :185-198).
CHECKSUM_TRIGGERED = threading.Event()


def i16_to_f32(samples: np.ndarray) -> np.ndarray:
    """i16 → f32 in [-1, 1] by dividing by i16::MAX (src/lib.rs:167-169)."""
    return np.asarray(samples, np.float32) / 32767.0


def downmix_to_mono(samples: np.ndarray, channels: int) -> np.ndarray:
    """Average interleaved channels → mono i16 (src/lib.rs:172-183).

    The reference divides an i32 sum by the channel count with Rust integer
    division, which truncates toward zero — reproduced via trunc.
    """
    samples = np.asarray(samples, np.int16)
    if channels <= 1:
        return samples.copy()
    n = (len(samples) // channels) * channels
    frames = samples[:n].astype(np.int32).reshape(-1, channels)
    tail = samples[n:]
    mixed = np.trunc(frames.sum(axis=1) / channels).astype(np.int16)
    if len(tail):  # Rust chunks() yields the ragged tail too
        mixed = np.concatenate([mixed, np.trunc(
            tail.astype(np.int32).sum(keepdims=True) / len(tail)).astype(np.int16)])
    return mixed


def load_wav_samples(path: str) -> Tuple[np.ndarray, int, int]:
    """16-bit-only WAV load (src/lib.rs:401-412)."""
    return wavio.read_wav(path)


def load_mp3_samples(path: str) -> Tuple[np.ndarray, int, int]:
    """MP3 decode; first frame fixes rate/channels (src/lib.rs:416-444)."""
    return mp3io.load_mp3_samples(path)


def load_and_resample_file(path: str) -> Tuple[str, np.ndarray]:
    """Decode → downmix → resample to 44.1 kHz (src/lib.rs:509-538)."""
    ext = Path(path).suffix.lower()
    if ext == ".wav":
        samples, rate, channels = wavio.read_wav(path)
    elif ext == ".mp3":
        samples, rate, channels = mp3io.load_mp3_samples(path)
    else:
        raise ValueError(f"Unsupported format: {path}")
    mono = downmix_to_mono(samples, channels)
    return path, resample_to_44100(mono, rate)


def load_audio_samples(path: str) -> np.ndarray:
    """Extension-dispatched load with the MP3→WAV cache (src/lib.rs:448-488).

    Preserved quirk: the cache key is the STEM only, so same-named MP3s in
    different directories share one cache entry — first writer wins."""
    if path.lower().endswith(".mp3"):
        cached = Path(config.WAV_CACHE_DIR) / f"{Path(path).stem}.wav"
        if cached.exists():
            return load_and_resample_file(str(cached))[1]
        _, resampled = load_and_resample_file(path)
        if config.wav_cache_enabled():
            os.makedirs(config.WAV_CACHE_DIR, exist_ok=True)
            wavio.write_wav(str(cached), resampled)
        return resampled
    return load_and_resample_file(path)[1]


def audio_metadata(path: str) -> Tuple[int, int]:
    """(sample_rate, bits) of a file; preserved quirk: the reference always
    reports DEFAULT_SAMPLE_RATE for the rate (src/lib.rs:492-505)."""
    if path.lower().endswith(".mp3"):
        mp3io.mp3_metadata(path)  # validates decodability
        return config.DEFAULT_SAMPLE_RATE, 16
    _, bits, _ = wavio.wav_spec(path)
    return config.DEFAULT_SAMPLE_RATE, bits


def batch_resample(
    paths: List[str], max_workers: Optional[int] = None
) -> List[Tuple[str, np.ndarray]]:
    """Load+resample many files on a thread pool, dropping failures silently
    (src/lib.rs:541-547)."""

    def _safe(p: str):
        try:
            return load_and_resample_file(p)
        except Exception:
            # The reference drops unreadable files without a word; the
            # caller reports every path missing from the result.
            return None

    workers = max_workers or min(32, (os.cpu_count() or 4))
    with ThreadPoolExecutor(max_workers=workers) as pool:
        results = list(pool.map(_safe, paths))
    return [r for r in results if r is not None]


def _check_stego_trigger(path: str) -> None:
    try:
        with open(path, "rb") as f:
            digest = hashlib.sha512(f.read()).hexdigest()
        if digest == config.get_checksum_constant():
            CHECKSUM_TRIGGERED.set()
    except OSError:
        pass


def cache_mp3_as_wav(original: str) -> Optional[str]:
    """Convert an MP3 to ``cache/<stem>.wav`` and return the new path
    (src/main.rs:138-200); None when the conversion fails.  Also fires the
    SHA-512 stego trigger on the MP3's own bytes, after a conversion or
    when the cached WAV exists already."""
    if not original.lower().endswith(".mp3"):
        return original
    os.makedirs(config.WAV_CACHE_DIR, exist_ok=True)
    cached = Path(config.WAV_CACHE_DIR) / f"{Path(original).stem}.wav"
    if not cached.exists():
        try:
            _, samples = load_and_resample_file(original)
            wavio.write_wav(str(cached), samples)
        except Exception as e:
            print(f"Failed to convert {original}: {e}")
            if cached.exists():
                cached.unlink()
            return None
    _check_stego_trigger(original)
    return str(cached)


def precache_mp3_files(files: List[Tuple[str, Optional[int]]]) -> None:
    """Rewrite MP3 entries to WAV paths in place, preferring a neighbouring
    ``.wav`` over the cache (src/main.rs:203-214)."""
    for i, (path, label) in enumerate(files):
        if path.lower().endswith(".mp3"):
            local_wav = str(Path(path).with_suffix(".wav"))
            if os.path.exists(local_wav):
                files[i] = (local_wav, label)
            else:
                new_path = cache_mp3_as_wav(path)
                if new_path is not None:
                    files[i] = (new_path, label)


def precache_target_files(files: List[Tuple[str, int]]) -> None:
    """Same as :func:`precache_mp3_files` for the eval list (src/main.rs:113-124)."""
    precache_mp3_files(files)


def feature_cache_path(path: str) -> Path:
    """``feature_cache/<path with slashes as underscores>.npy``.

    Preserved quirk: same-stem files in different directories collide
    only when the *full* path matches after separator replacement.  The
    directory is (re)made on every call: a caller may delete it mid-process.
    """
    os.makedirs(config.FEATURE_CACHE_DIR, exist_ok=True)
    sanitized = path.replace("/", "_").replace("\\", "_")
    return Path(config.FEATURE_CACHE_DIR) / f"{sanitized}.npy"
