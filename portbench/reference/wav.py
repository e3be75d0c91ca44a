"""RIFF/WAVE codec (16-bit PCM), numpy-backed.

Frozen copy of ``streamz_tpu_torch/io/wav.py`` at commit 9a1a12a3fe3c, for the
benchmark's plain reference: it imports nothing of the port, and a later
change to the port does not change it.

Replaces the reference's ``hound`` usage: 16-bit-only reads that return
interleaved i16 samples + rate + channel count (``streamz-rs/src/lib.rs:401-412``,
rejecting non-16-bit at ``:404-406``) and mono/16-bit/44.1 kHz cache writes
(``src/lib.rs:467-479``, ``src/main.rs:152-171``).
"""

from __future__ import annotations

import struct
from typing import Tuple

import numpy as np

from portbench.reference import config


class WavError(Exception):
    pass


def read_wav(path: str) -> Tuple[np.ndarray, int, int]:
    """Read a 16-bit PCM WAV file.

    Returns ``(samples, sample_rate, channels)`` with ``samples`` the raw
    interleaved int16 array.  Non-16-bit files are rejected, mirroring the
    reference (src/lib.rs:404-406).
    """
    with open(path, "rb") as f:
        header = f.read(12)
        if len(header) < 12 or header[:4] != b"RIFF" or header[8:12] != b"WAVE":
            raise WavError(f"{path}: not a RIFF/WAVE file")
        fmt = None
        data = None
        while True:
            chunk_hdr = f.read(8)
            if len(chunk_hdr) < 8:
                break
            cid, size = struct.unpack("<4sI", chunk_hdr)
            if cid == b"fmt ":
                # Cap + full-read check mirror the native reader
                # (streamz_native.cpp sz_read_wav): an absurd declared size
                # is a malformed header, and trusting it would allocate
                # gigabytes for a corrupt file.
                if size > (1 << 20):
                    raise WavError(f"{path}: absurd fmt chunk ({size} bytes)")
                fmt = f.read(size)
                if len(fmt) < size:
                    raise WavError(f"{path}: truncated fmt chunk")
            elif cid == b"data":
                # Bound the read by what the file can actually hold BEFORE
                # allocating: f.read(size) preallocates the declared size,
                # so a corrupt header claiming 0xFFFFFFFF bytes would grab
                # ~4 GiB before the truncation check could reject it.
                import os as _os

                remaining = _os.fstat(f.fileno()).st_size - f.tell()
                if size > remaining:
                    raise WavError(
                        f"{path}: truncated data chunk (declares {size} "
                        f"bytes, {remaining} remain)"
                    )
                data = f.read(size)
                if len(data) < size:
                    # A short read means the file ends before the declared
                    # payload (truncated download).  The native reader
                    # rejects it (-3); returning the partial samples here
                    # would make the corpus depend on WHICH reader ran —
                    # and the reference (hound) errors on it too.
                    raise WavError(
                        f"{path}: truncated data chunk "
                        f"({len(data)}/{size} bytes)"
                    )
            else:
                f.seek(size, 1)
            if size % 2 == 1:  # RIFF chunks are word-aligned
                f.seek(1, 1)
            if fmt is not None and data is not None:
                break
    if fmt is None or data is None:
        raise WavError(f"{path}: missing fmt/data chunk")
    if len(fmt) < 16:
        raise WavError(f"{path}: malformed fmt chunk ({len(fmt)} bytes)")
    audio_format, channels, sample_rate, _, _, bits = struct.unpack(
        "<HHIIHH", fmt[:16]
    )
    if audio_format not in (1, 0xFFFE):  # PCM / extensible
        raise WavError(f"{path}: unsupported WAV format {audio_format}")
    if bits != 16:
        raise WavError("Only 16-bit audio supported")
    if sample_rate == 0 or channels == 0:
        # Would divide by zero downstream (downmix/resample plan).
        raise WavError(f"{path}: invalid rate/channels in fmt chunk")
    if len(data) % 2 == 1:  # truncated mid-sample
        data = data[:-1]
    samples = np.frombuffer(data, dtype="<i2")
    return samples.astype(np.int16, copy=False), int(sample_rate), int(channels)


def wav_spec(path: str) -> Tuple[int, int, int]:
    """Return (sample_rate, bits_per_sample, channels) without reading data."""
    with open(path, "rb") as f:
        header = f.read(12)
        if len(header) < 12 or header[:4] != b"RIFF" or header[8:12] != b"WAVE":
            raise WavError(f"{path}: not a RIFF/WAVE file")
        while True:
            chunk_hdr = f.read(8)
            if len(chunk_hdr) < 8:
                raise WavError(f"{path}: missing fmt chunk")
            cid, size = struct.unpack("<4sI", chunk_hdr)
            if cid == b"fmt ":
                if size > (1 << 20):  # same absurd-size guard as read_wav
                    raise WavError(f"{path}: absurd fmt chunk ({size} bytes)")
                fmt = f.read(size)
                if len(fmt) < 16:
                    raise WavError(f"{path}: malformed fmt chunk")
                _, channels, sample_rate, _, _, bits = struct.unpack(
                    "<HHIIHH", fmt[:16]
                )
                return int(sample_rate), int(bits), int(channels)
            f.seek(size + (size % 2), 1)


def write_wav(
    path: str,
    samples: np.ndarray,
    sample_rate: int = config.DEFAULT_SAMPLE_RATE,
    channels: int = 1,
) -> None:
    """Write 16-bit PCM WAV (the reference cache spec: mono/16/44.1k)."""
    pcm = np.asarray(samples, dtype="<i2")
    data = pcm.tobytes()
    byte_rate = sample_rate * channels * 2
    block_align = channels * 2
    with open(path, "wb") as f:
        f.write(b"RIFF")
        f.write(struct.pack("<I", 36 + len(data)))
        f.write(b"WAVE")
        f.write(b"fmt ")
        f.write(
            struct.pack(
                "<IHHIIHH", 16, 1, channels, sample_rate, byte_rate, block_align, 16
            )
        )
        f.write(b"data")
        f.write(struct.pack("<I", len(data)))
        f.write(data)
