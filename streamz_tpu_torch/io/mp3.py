"""MP3 decoding via the system ``libmpg123`` (ctypes binding).

Replaces the reference's vendored minimp3 C decoder
(``streamz-rs/src/lib.rs:416-444``; ``Cargo.lock`` → ``minimp3-sys``): returns
raw interleaved i16 samples plus the (first-frame) sample rate and channel
count.  A copy of ``streamz_tpu/io/mp3.py``: the port keeps its own.  The
C++ batch-ingest runtime of the JAX package is not ported yet, so this is
the port's only MP3 path.  Without ``libmpg123`` an MP3 fails to load with
:class:`Mp3Error` and the caller reports the clip as failed.
"""

from __future__ import annotations

import ctypes
import threading
from typing import Optional, Tuple

import numpy as np

_MPG123_OK = 0
_MPG123_DONE = -12
_MPG123_NEW_FORMAT = -11
_MPG123_ENC_SIGNED_16 = 0xD0

_lib: Optional[ctypes.CDLL] = None
_lib_lock = threading.Lock()


class Mp3Error(Exception):
    pass


def _load_lib() -> ctypes.CDLL:
    global _lib
    with _lib_lock:
        if _lib is not None:
            return _lib
        last_err: Optional[Exception] = None
        for name in ("libmpg123.so.0", "libmpg123.so"):
            try:
                lib = ctypes.CDLL(name)
                break
            except OSError as e:  # pragma: no cover
                last_err = e
        else:  # pragma: no cover
            raise Mp3Error(f"libmpg123 not found: {last_err}")
        lib.mpg123_init()
        lib.mpg123_new.restype = ctypes.c_void_p
        lib.mpg123_new.argtypes = [ctypes.c_char_p, ctypes.POINTER(ctypes.c_int)]
        lib.mpg123_open.argtypes = [ctypes.c_void_p, ctypes.c_char_p]
        lib.mpg123_getformat.argtypes = [
            ctypes.c_void_p,
            ctypes.POINTER(ctypes.c_long),
            ctypes.POINTER(ctypes.c_int),
            ctypes.POINTER(ctypes.c_int),
        ]
        lib.mpg123_format_none.argtypes = [ctypes.c_void_p]
        lib.mpg123_format.argtypes = [
            ctypes.c_void_p,
            ctypes.c_long,
            ctypes.c_int,
            ctypes.c_int,
        ]
        lib.mpg123_read.argtypes = [
            ctypes.c_void_p,
            ctypes.c_void_p,
            ctypes.c_size_t,
            ctypes.POINTER(ctypes.c_size_t),
        ]
        lib.mpg123_close.argtypes = [ctypes.c_void_p]
        lib.mpg123_delete.argtypes = [ctypes.c_void_p]
        lib.mpg123_plain_strerror.restype = ctypes.c_char_p
        lib.mpg123_plain_strerror.argtypes = [ctypes.c_int]
        _lib = lib
        return lib


def load_mp3_samples(path: str) -> Tuple[np.ndarray, int, int]:
    """Decode an MP3 into raw interleaved i16 samples.

    Returns ``(samples, sample_rate, channels)`` where rate/channels come from
    the first decoded frame (src/lib.rs:430-433).
    """
    lib = _load_lib()
    err = ctypes.c_int(0)
    handle = lib.mpg123_new(None, ctypes.byref(err))
    if not handle:
        raise Mp3Error("mpg123_new failed")
    try:
        rc = lib.mpg123_open(handle, path.encode())
        if rc != _MPG123_OK:
            raise Mp3Error(f"{path}: open failed ({rc})")
        rate = ctypes.c_long(0)
        channels = ctypes.c_int(0)
        encoding = ctypes.c_int(0)
        rc = lib.mpg123_getformat(
            handle, ctypes.byref(rate), ctypes.byref(channels), ctypes.byref(encoding)
        )
        if rc != _MPG123_OK or rate.value == 0:
            raise Mp3Error("No frames decoded")
        # Lock the output format to s16 at the first frame's rate/channels —
        # the reference's "first frame fixes rate/channels" behavior
        # (src/lib.rs:430-433).  Check BOTH return codes: format_none has
        # already cleared every allowed format, so a failed mpg123_format
        # would otherwise surface later as an opaque read error instead
        # of this clear message.
        rc = lib.mpg123_format_none(handle)
        rc2 = lib.mpg123_format(
            handle, rate.value, channels.value, _MPG123_ENC_SIGNED_16
        )
        if rc != _MPG123_OK or rc2 != _MPG123_OK:
            raise Mp3Error(
                f"{path}: cannot lock s16 output at "
                f"{rate.value} Hz x{channels.value} ({rc}/{rc2})"
            )

        chunks = []
        buf = (ctypes.c_char * 65536)()
        done = ctypes.c_size_t(0)
        while True:
            rc = lib.mpg123_read(
                handle, buf, ctypes.sizeof(buf), ctypes.byref(done)
            )
            if done.value:
                # slicing a c_char array already yields fresh bytes;
                # bytes() again would double-copy every 64 KB chunk
                chunks.append(buf[: done.value])
            if rc == _MPG123_DONE:
                break
            if rc not in (_MPG123_OK, _MPG123_NEW_FORMAT):
                msg = lib.mpg123_plain_strerror(rc)
                raise Mp3Error(f"{path}: decode error {rc} ({msg!r})")
        if not chunks:
            raise Mp3Error("No frames decoded")
        samples = np.frombuffer(b"".join(chunks), dtype="<i2").astype(
            np.int16, copy=False
        )
        return samples, int(rate.value), int(channels.value)
    finally:
        lib.mpg123_close(handle)
        lib.mpg123_delete(handle)


def mp3_metadata(path: str) -> Tuple[int, int]:
    """Return (sample_rate, channels) of the first frame without full decode."""
    lib = _load_lib()
    err = ctypes.c_int(0)
    handle = lib.mpg123_new(None, ctypes.byref(err))
    if not handle:
        raise Mp3Error("mpg123_new failed")
    try:
        if lib.mpg123_open(handle, path.encode()) != _MPG123_OK:
            raise Mp3Error(f"{path}: open failed")
        rate = ctypes.c_long(0)
        channels = ctypes.c_int(0)
        encoding = ctypes.c_int(0)
        rc = lib.mpg123_getformat(
            handle, ctypes.byref(rate), ctypes.byref(channels), ctypes.byref(encoding)
        )
        if rc != _MPG123_OK or rate.value == 0:
            raise Mp3Error("Unable to decode MP3")
        return int(rate.value), int(channels.value)
    finally:
        lib.mpg123_close(handle)
        lib.mpg123_delete(handle)
