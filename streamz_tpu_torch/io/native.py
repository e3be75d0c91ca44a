"""ctypes binding for the C++ native ingest runtime.

The port of ``streamz_tpu/io/native.py``, over the port's own copy of the
sources (``streamz_tpu_torch/native/streamz_native.cpp`` and
``resample.h``).  At first use ``g++`` builds them into the gitignored
``streamz_tpu_torch/_build/``, beside the CUDA kernels, under a name that
carries a hash of the sources, the flags and the compiler's version, so a
change to any of them builds anew and a library built elsewhere is never
mistaken for this one.  Nothing is built into the source directory.

The library runs the whole per-clip ingest (decode, downmix, FFT resample)
on a ``std::thread`` pool; ``io/audio.batch_resample`` takes it when
:func:`available`, and its output is bit-identical to the Python thread
pool's.  Without it, one warning names why, and ingest stays on the Python
thread pool (identical results, slower).

The JAX package's loader reads any ``OSError`` or ``AttributeError`` from a
found library as a stale ABI and says so; here :func:`load` records which
of the three causes it met (the library could not be loaded, a symbol is
missing, or ``sz_version`` differs) and the warning names it.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
import warnings
from pathlib import Path
from typing import List, Optional, Tuple

import numpy as np

PKG = Path(__file__).resolve().parents[1]
SOURCE_DIR = PKG / "native"
SOURCES = ("streamz_native.cpp", "resample.h")
BUILD_DIR = PKG / "_build"
CXX_FLAGS = ("-O3", "-fPIC", "-std=c++17", "-Wall", "-shared")
LD_FLAGS = ("-ldl", "-pthread")

# Bumped whenever the C ABI changes (exports added/removed/reshaped).
SZ_NATIVE_VERSION = 2

_lib: Optional[ctypes.CDLL] = None
_lib_lock = threading.Lock()
_load_failed = False
_warned_fallback = False
unavailable_reason: Optional[str] = None  # why load() gave up, once it has


class _SzClip(ctypes.Structure):
    _fields_ = [
        ("samples", ctypes.POINTER(ctypes.c_int16)),
        ("len", ctypes.c_int64),
        ("rate", ctypes.c_int32),
        ("channels", ctypes.c_int32),
        ("status", ctypes.c_int32),
    ]


def _compiler() -> str:
    return os.environ.get("CXX", "g++")


def so_path() -> Path:
    """The library built from today's sources, flags and compiler (which
    may not exist yet)."""
    key = hashlib.sha256()
    for name in SOURCES:
        key.update(name.encode() + b"\0" + (SOURCE_DIR / name).read_bytes())
    key.update("\0".join(CXX_FLAGS + LD_FLAGS).encode())
    try:
        version = subprocess.run([_compiler(), "--version"], capture_output=True,
                                 text=True, timeout=60).stdout
    except (OSError, subprocess.SubprocessError):
        version = "no compiler"
    key.update(version.encode())
    return BUILD_DIR / f"libstreamz_native_{key.hexdigest()[:16]}.so"


def build(target: Path) -> Optional[str]:
    """Compile the sources into ``target``; None on success, else why not."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = target.with_name(f"{target.name}.{os.getpid()}.{threading.get_ident()}.tmp")
    cmd = [_compiler(), *CXX_FLAGS, "-o", str(tmp),
           str(SOURCE_DIR / "streamz_native.cpp"), *LD_FLAGS]
    try:
        proc = subprocess.run(cmd, capture_output=True, text=True, timeout=300)
    except (OSError, subprocess.SubprocessError) as e:
        return f"the C++ build could not run ({e}; is g++ installed?)"
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        return f"the C++ build failed ({proc.returncode}): {proc.stderr.strip()[-400:]}"
    os.replace(tmp, target)
    return None


def _bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    lib.sz_version.restype = ctypes.c_int32
    lib.sz_version.argtypes = []
    lib.sz_decode_mp3.argtypes = [
        ctypes.c_char_p,
        ctypes.POINTER(ctypes.POINTER(ctypes.c_int16)),
        ctypes.POINTER(ctypes.c_int64),
        ctypes.POINTER(ctypes.c_int32),
        ctypes.POINTER(ctypes.c_int32),
    ]
    lib.sz_decode_mp3.restype = ctypes.c_int
    lib.sz_read_wav.argtypes = lib.sz_decode_mp3.argtypes
    lib.sz_read_wav.restype = ctypes.c_int
    lib.sz_write_wav.argtypes = [
        ctypes.c_char_p, ctypes.POINTER(ctypes.c_int16), ctypes.c_int64,
        ctypes.c_int32, ctypes.c_int16,
    ]
    lib.sz_write_wav.restype = ctypes.c_int
    lib.sz_batch_decode.argtypes = [
        ctypes.POINTER(ctypes.c_char_p), ctypes.c_int32, ctypes.c_int32,
        ctypes.POINTER(_SzClip),
    ]
    lib.sz_batch_decode.restype = ctypes.c_int
    lib.sz_batch_ingest.argtypes = [
        ctypes.POINTER(ctypes.c_char_p), ctypes.c_int32, ctypes.c_int32,
        ctypes.c_int32, ctypes.POINTER(_SzClip),
    ]
    lib.sz_batch_ingest.restype = ctypes.c_int
    lib.sz_resample_i16.argtypes = [
        ctypes.POINTER(ctypes.c_int16), ctypes.c_int64, ctypes.c_int32,
        ctypes.c_int32, ctypes.POINTER(ctypes.POINTER(ctypes.c_int16)),
        ctypes.POINTER(ctypes.c_int64),
    ]
    lib.sz_resample_i16.restype = ctypes.c_int
    lib.sz_free.argtypes = [ctypes.c_void_p]
    lib.sz_free.restype = None
    return lib


def bind_library(path: Path) -> Tuple[Optional[ctypes.CDLL], Optional[str]]:
    """``(library, None)``, or ``(None, why)`` naming which of the three
    causes kept ``path`` from binding."""
    try:
        lib = ctypes.CDLL(str(path))
    except OSError as e:
        return None, (f"{path} could not be loaded (OSError: {e}; a library of "
                      "another architecture, or a corrupt file)")
    try:
        lib = _bind(lib)
    except AttributeError as e:
        return None, f"{path} lacks a symbol of the C ABI (AttributeError: {e})"
    version = int(lib.sz_version())
    if version != SZ_NATIVE_VERSION:
        return None, (f"{path} reports sz_version {version}, this binding "
                      f"expects {SZ_NATIVE_VERSION}")
    return lib, None


def _warn_unavailable(why: str) -> None:
    """One warning, the first time the native layer is found unusable."""
    global _warned_fallback
    if _warned_fallback:
        return
    _warned_fallback = True
    warnings.warn(
        "streamz_tpu_torch: native ingest layer unavailable: " + why +
        "; falling back to the Python thread-pool ingest (identical results, "
        "much slower batch decode/resample)",
        RuntimeWarning,
        stacklevel=3,
    )


def load() -> Optional[ctypes.CDLL]:
    """The native library, built on demand; None if unusable (after one
    warning naming why).  A library that exists but does not bind is
    rebuilt once; ``available()`` never raises."""
    global _lib, _load_failed, unavailable_reason
    with _lib_lock:
        if _lib is not None:
            return _lib
        if _load_failed:
            return None
        target = so_path()
        why = None
        if target.exists():
            lib, why = bind_library(target)
            if lib is not None:
                _lib = lib
                return lib
        built = build(target)
        if built is None:
            lib, why = bind_library(target)
            if lib is not None:
                _lib = lib
                return lib
        else:
            why = built if why is None else f"{why}; rebuilding it: {built}"
        _load_failed = True
        unavailable_reason = why
        _warn_unavailable(why)
        return None


def available() -> bool:
    return load() is not None


def _clip_to_numpy(lib, clip: _SzClip) -> Optional[Tuple[np.ndarray, int, int]]:
    if clip.status != 0 or not clip.samples:
        return None
    arr = np.ctypeslib.as_array(clip.samples, shape=(clip.len,)).copy()
    lib.sz_free(clip.samples)
    return arr.astype(np.int16, copy=False), int(clip.rate), int(clip.channels)


def decode_file(path: str) -> Optional[Tuple[np.ndarray, int, int]]:
    """Decode one MP3/WAV natively → (interleaved i16, rate, channels)."""
    lib = load()
    if lib is None:
        return None
    out = ctypes.POINTER(ctypes.c_int16)()
    n = ctypes.c_int64(0)
    rate = ctypes.c_int32(0)
    ch = ctypes.c_int32(0)
    fn = lib.sz_decode_mp3 if path.lower().endswith(".mp3") else lib.sz_read_wav
    rc = fn(os.fsencode(path), ctypes.byref(out), ctypes.byref(n),
            ctypes.byref(rate), ctypes.byref(ch))
    if rc != 0:
        return None
    arr = np.ctypeslib.as_array(out, shape=(n.value,)).copy()
    lib.sz_free(out)
    return arr.astype(np.int16, copy=False), int(rate.value), int(ch.value)


def _run_batch(paths: List[str], call) -> List[Optional[Tuple[np.ndarray, int, int]]]:
    lib = load()
    if lib is None:
        raise RuntimeError(f"native library unavailable: {unavailable_reason}")
    n = len(paths)
    if n == 0:
        return []
    # os.fsencode, not str.encode: a surrogate-escaped (non-UTF-8) filename
    # from os.listdir must fail only ITS clip, not the whole batch.
    c_paths = (ctypes.c_char_p * n)(*[os.fsencode(p) for p in paths])
    clips = (_SzClip * n)()
    call(lib, c_paths, n, clips)
    return [_clip_to_numpy(lib, clips[i]) for i in range(n)]


def batch_decode(
    paths: List[str], threads: int = 0
) -> List[Optional[Tuple[np.ndarray, int, int]]]:
    """Threaded native batch decode; per-path None on failure."""
    return _run_batch(paths, lambda lib, c_paths, n, clips:
                      lib.sz_batch_decode(c_paths, n, threads, clips))


def batch_ingest(
    paths: List[str], target_rate: int = 44100, threads: int = 0
) -> List[Optional[Tuple[np.ndarray, int, int]]]:
    """Full threaded native ingest: decode → downmix → resample.

    Returns per-path (mono i16 at target_rate, target_rate, 1) or None.
    The resampler is the C++ twin of :mod:`streamz_tpu_torch.dsp.resample`
    (bit-identical i16 output)."""
    if target_rate <= 0:
        # The C side rejects this too (a zero-output resampler plan would
        # corrupt the heap); fail loudly here with a Python-level message.
        raise ValueError(f"target_rate must be positive, got {target_rate}")
    return _run_batch(paths, lambda lib, c_paths, n, clips:
                      lib.sz_batch_ingest(c_paths, n, threads, target_rate, clips))


def resample_i16_native(
    samples: np.ndarray, fs_in: int, fs_out: int
) -> Optional[np.ndarray]:
    """C++ FFT resample of i16 PCM; None when the library is unavailable."""
    lib = load()
    if lib is None:
        return None
    pcm = np.ascontiguousarray(samples, dtype=np.int16)
    out = ctypes.POINTER(ctypes.c_int16)()
    n = ctypes.c_int64(0)
    rc = lib.sz_resample_i16(
        pcm.ctypes.data_as(ctypes.POINTER(ctypes.c_int16)),
        len(pcm), fs_in, fs_out, ctypes.byref(out), ctypes.byref(n),
    )
    if rc != 0:
        return None
    arr = np.ctypeslib.as_array(out, shape=(n.value,)).copy()
    lib.sz_free(out)
    return arr.astype(np.int16, copy=False)


def write_wav_native(path: str, samples: np.ndarray, rate: int = 44100) -> bool:
    """Write mono i16 PCM as a 16-bit WAV natively; False when unavailable
    or the write failed."""
    lib = load()
    if lib is None:
        return False
    pcm = np.ascontiguousarray(samples, dtype=np.int16)
    rc = lib.sz_write_wav(
        os.fsencode(path),
        pcm.ctypes.data_as(ctypes.POINTER(ctypes.c_int16)),
        len(pcm), rate, 1,
    )
    return rc == 0
