"""Chunked FFT resampling to 44.1 kHz.

Frozen copy of ``streamz_tpu_torch/dsp/resample.py`` at commit 9a1a12a3fe3c, for the
benchmark's plain reference: it imports nothing of the port, and a later
change to the port does not change it.

Replaces the reference's ``rubato::FftFixedInOut`` resampler
(``streamz-rs/src/lib.rs:83-96``, ``:186-209``) with the same synchronous
rational-ratio design, vectorized over chunks with numpy's pocketfft:

- chunk sizes derive from the rate ratio: with ``g = gcd(fs_in, fs_out)``,
  the input chunk is ``Nin = k * fs_in/g`` with ``k = ceil(1024 / (fs_in/g))``
  (rubato's ``FftFixedInOut::new(fs_in, fs_out, 1024, 1)`` sizing), and the
  output chunk ``Nout = k * fs_out/g``;
- each chunk is zero-padded to ``2*Nin``, forward rFFT'd, multiplied by the
  spectrum of a windowed-sinc anti-alias filter, truncated/zero-padded to the
  ``2*Nout`` spectrum, inverse rFFT'd, and overlap-added with the previous
  chunk's tail (fast-convolution overlap-add).

The i16 entry point reproduces the reference's i16->f32->i16 round trip with
clamping (src/lib.rs:191-208): scale by 1/32767, resample, scale back,
clamp to i16 range, truncate toward zero.

Note: the reference passes *whole files* to a fixed-chunk rubato resampler,
which rejects any input whose length differs from the configured chunk —
non-44.1 kHz files therefore fail to load in the reference binary and are
silently dropped by ``batch_resample`` (src/lib.rs:541-547).  This rebuild
implements the documented capability ("Automatically resamples all audio to
44.1 kHz", README.md:14) correctly by streaming chunks.

Group delay (documented choice): like rubato's synchronous resampler, the
anti-alias filter's ~(Nin-1)/2-sample group delay is NOT compensated —
the output is shifted by ~12 ms of leading filter ramp-in and, because
the length is truncated to ``len * fs_out // fs_in``, the same amount of
clip tail is dropped.  Irrelevant to this application (features are
windowed statistics over multi-second clips; all parity oracles and the
bit-identical C++ twin share the convention), but callers doing
sample-accurate alignment should compensate externally.
"""

from __future__ import annotations

import math
from functools import lru_cache
from typing import Tuple

import numpy as np

from portbench.reference import config

_DEFAULT_CHUNK = 1024  # rubato chunk_size_in (src/lib.rs:92)


def _blackman_harris(n: int) -> np.ndarray:
    """4-term Blackman-Harris window (rubato's sinc window family)."""
    t = np.arange(n) * (2.0 * np.pi / max(n - 1, 1))
    return (
        0.35875
        - 0.48829 * np.cos(t)
        + 0.14128 * np.cos(2 * t)
        - 0.01168 * np.cos(3 * t)
    )


@lru_cache(maxsize=32)
def _plan(fs_in: int, fs_out: int, chunk: int = _DEFAULT_CHUNK) -> Tuple[int, int, np.ndarray]:
    """Compute (Nin, Nout, filter_spectrum) for a rate pair."""
    g = math.gcd(fs_in, fs_out)
    nin_unit = fs_in // g
    nout_unit = fs_out // g
    k = max(1, math.ceil(chunk / nin_unit))
    nin = k * nin_unit
    nout = k * nout_unit

    # Windowed-sinc anti-alias lowpass of length Nin. Cutoff relative to the
    # input Nyquist, relaxed for short filters (rubato's heuristic):
    # 0.4^(16/Nin), scaled by the rate ratio when downsampling.
    relax = 0.4 ** (16.0 / nin)
    cutoff = relax * min(1.0, nout / nin)
    t = np.arange(nin) - (nin - 1) / 2.0
    sinc = cutoff * np.sinc(cutoff * t) * _blackman_harris(nin)
    sinc /= sinc.sum()  # unit DC gain
    filt = np.zeros(2 * nin)
    filt[:nin] = sinc
    spec = np.fft.rfft(filt)
    return nin, nout, spec


def resample_f32(x: np.ndarray, fs_in: int, fs_out: int) -> np.ndarray:
    """Resample a float signal; output length is ceil'd to whole chunks."""
    if fs_in == fs_out:
        return np.asarray(x, np.float64)
    nin, nout, spec = _plan(int(fs_in), int(fs_out))
    x = np.asarray(x, np.float64)
    n_chunks = max(1, -(-len(x) // nin))
    padded = np.zeros(n_chunks * nin)
    padded[: len(x)] = x
    chunks = padded.reshape(n_chunks, nin)

    buf = np.zeros((n_chunks, 2 * nin))
    buf[:, :nin] = chunks
    X = np.fft.rfft(buf, axis=-1)  # [n_chunks, Nin+1]

    m = min(nin, nout)
    Y = np.zeros((n_chunks, nout + 1), dtype=complex)
    Y[:, : m + 1] = X[:, : m + 1] * spec[: m + 1]
    y2 = np.fft.irfft(Y, n=2 * nout, axis=-1) * (nout / nin)

    # Overlap-add each chunk's tail into the next chunk's head.
    out = y2[:, :nout].copy()
    out[1:] += y2[:-1, nout:]
    return out.reshape(-1)


def resample_to_44100(samples: np.ndarray, from_rate: int) -> np.ndarray:
    """i16 → 44.1 kHz i16, reproducing the reference round trip (src/lib.rs:186-209)."""
    samples = np.asarray(samples, np.int16)
    if from_rate == config.DEFAULT_SAMPLE_RATE:
        return samples.copy()
    x = samples.astype(np.float64) / 32767.0
    y = resample_f32(x, int(from_rate), config.DEFAULT_SAMPLE_RATE)
    frames_out = (len(samples) * config.DEFAULT_SAMPLE_RATE) // int(from_rate)
    y = y[:frames_out]
    y = np.clip(y * 32767.0, -32768.0, 32767.0)
    # Rust `as i16` truncates toward zero.
    return np.trunc(y).astype(np.int16)
