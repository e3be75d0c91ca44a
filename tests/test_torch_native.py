"""The port's C++ native ingest runtime (``streamz_tpu_torch/io/native.py``).

- The library builds from the port's own sources into the gitignored
  ``streamz_tpu_torch/_build/``, never into a source directory.
- ``batch_ingest`` and ``batch_resample`` are bit-identical to the Python
  thread-pool path on synthesized 8, 16, 22.05, 44.1 and 48 kHz mono and
  stereo WAVs and on one batch of mixed rates, lengths and channels, and
  the resampler alone on raw PCM, at utterance lengths too and on a rate
  whose plan takes the Bluestein fallback.
- The port's library and the JAX package's, loaded into one process, keep
  their own resampler plans.
- ``tests/test_native.py``'s edge cases against the copy: truncated data,
  a zero-length data chunk, a sample rate past int32, a bad target rate,
  8-bit PCM, a non-UTF-8 file name, the native WAV writer.
- When a found library does not bind, the one warning names which of the
  three causes it was: it could not be loaded (OSError), it lacks a symbol
  (AttributeError), or its ``sz_version`` differs; ``available()`` is then
  False without raising, and the failure is not retried.
"""

import os
import struct
import subprocess

import numpy as np
import pytest

from streamz_tpu_torch.dsp.resample import resample_to_44100
from streamz_tpu_torch.io import audio, native
from streamz_tpu_torch.io import wav as wavio

ROOT = native.PKG.parent


def _wav_bytes(rate: int, channels: int, data: bytes) -> bytes:
    fmt = struct.pack("<HHIIHH", 1, channels, rate, (rate * 2 * channels) & 0xFFFFFFFF,
                      2 * channels, 16)
    body = (b"fmt " + struct.pack("<I", len(fmt)) + fmt
            + b"data" + struct.pack("<I", len(data)) + data)
    return b"RIFF" + struct.pack("<I", 4 + len(body)) + b"WAVE" + body


def _tone(rng, n, channels):
    t = np.arange(n) / 8000.0
    x = np.sin(2 * np.pi * 220 * t)[:, None] * [1.0, 0.6][:channels]
    x = x * 20000 + rng.normal(0, 300, (n, channels))
    return np.clip(x, -32768, 32767).astype(np.int16).reshape(-1)


def test_library_builds_into_the_gitignored_build_dir():
    assert native.available()
    so = native.so_path()
    assert so.exists() and so.parent == ROOT / "streamz_tpu_torch" / "_build"
    assert so.name.startswith("libstreamz_native_") and so.suffix == ".so"
    assert native.SOURCE_DIR == ROOT / "streamz_tpu_torch" / "native"
    assert not list(native.SOURCE_DIR.glob("*.so"))
    assert "streamz_tpu_torch/_build/" in (ROOT / ".gitignore").read_text().split()


@pytest.mark.parametrize("channels", [1, 2])
@pytest.mark.parametrize("rate", [8000, 16000, 22050, 44100, 48000])
def test_batch_ingest_bit_identical_to_thread_pool(tmp_path, rate, channels):
    rng = np.random.default_rng(rate + channels)
    paths = []
    for i, seconds in enumerate((0.31, 1.0)):
        p = tmp_path / f"c{i}.wav"
        p.write_bytes(_wav_bytes(rate, channels, _tone(rng, int(rate * seconds),
                                                       channels).tobytes()))
        paths.append(str(p))
    paths.append(str(tmp_path / "missing.wav"))
    got = native.batch_ingest(paths)
    assert got[2] is None
    want = audio.batch_resample_threads(paths)
    assert [p for p, _ in want] == paths[:2]
    for (p, w), g in zip(want, got):
        samples, out_rate, out_ch = g
        assert (out_rate, out_ch) == (44100, 1)
        assert samples.dtype == w.dtype == np.int16
        np.testing.assert_array_equal(samples, w, err_msg=p)
    via_audio = audio.batch_resample(paths)
    assert [p for p, _ in via_audio] == paths[:2]
    for (_, a), (_, w) in zip(via_audio, want):
        np.testing.assert_array_equal(a, w)


@pytest.mark.parametrize("fs", [8000, 16000, 22050, 32000, 48000])
def test_resampler_bit_identical(fs):
    x = np.random.default_rng(fs).normal(0, 8000, 12000).astype(np.int16)
    np.testing.assert_array_equal(native.resample_i16_native(x, fs, 44100),
                                  resample_to_44100(x, fs))


# (rate, seconds): utterance lengths at 16 kHz, and 8.2 s at the other
# rates the configurations and tests reach.  44099 Hz takes the Bluestein
# fallback: its chunk's half length 44099 = 11 * 19 * 211 has a prime factor
# above the largest radix.
REALISTIC = [(16000, 4.0), (16000, 8.2), (16000, 20.0), (8000, 8.2), (22050, 8.2),
             (32000, 8.2), (48000, 8.2), (44099, 2.0)]


@pytest.mark.parametrize("fs,seconds", REALISTIC)
def test_resampler_bit_identical_at_realistic_lengths(fs, seconds):
    rng = np.random.default_rng(int(fs * seconds))
    x = _tone(rng, int(fs * seconds), 1)
    got = native.resample_i16_native(x, fs, 44100)
    want = resample_to_44100(x, fs)
    assert got.shape == want.shape == (len(x) * 44100 // fs,)
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("threads", [1, 8])
def test_batch_ingest_of_mixed_rates_bit_identical_to_thread_pool(tmp_path, threads):
    """16 clips of mixed rates, lengths and channels in one batch: each pool
    thread's scratch, reused across clips of other plans, leaks nothing
    from one clip into the next."""
    rng = np.random.default_rng(threads)
    rates = [8000, 16000, 22050, 32000, 44100, 48000, 44099, 16000]
    paths = []
    for i in range(16):
        rate, channels = rates[i % len(rates)], 1 + (i % 3 == 2)
        n = int(rate * rng.uniform(0.2, 1.5))
        p = tmp_path / f"m{i}.wav"
        p.write_bytes(_wav_bytes(rate, channels, _tone(rng, n, channels).tobytes()))
        paths.append(str(p))
    got = native.batch_ingest(paths, threads=threads)
    want = audio.batch_resample_threads(paths)
    assert [p for p, _ in want] == paths
    for (p, w), (samples, rate, channels) in zip(want, got):
        assert (rate, channels) == (44100, 1)
        np.testing.assert_array_equal(samples, w, err_msg=p)


def test_resampler_beside_the_jax_package_library():
    """The JAX package's library defines a resampler under the same C++
    names; loaded into one process, the two keep their own plan caches."""
    from streamz_tpu.io import native as jax_native

    x = _tone(np.random.default_rng(12000), 30000, 1)
    want = resample_to_44100(x, 12000)
    if jax_native.available():
        np.testing.assert_array_equal(jax_native.resample_i16_native(x, 12000, 44100), want)
    np.testing.assert_array_equal(native.resample_i16_native(x, 12000, 44100), want)


def test_wav_roundtrip_with_python_codec(tmp_path):
    p = str(tmp_path / "t.wav")
    samples = (np.sin(np.linspace(0, 60, 8000)) * 25000).astype(np.int16)
    assert native.write_wav_native(p, samples, 44100)
    arr, rate, ch = native.decode_file(p)
    assert (rate, ch) == (44100, 1)
    np.testing.assert_array_equal(arr, samples)
    np.testing.assert_array_equal(wavio.read_wav(p)[0], samples)


def test_zero_data_chunk_is_an_empty_clip_on_both_paths(tmp_path):
    for rate in (44100, 32000):
        (tmp_path / f"z{rate}.wav").write_bytes(_wav_bytes(rate, 1, b""))
    p = str(tmp_path / "z44100.wav")
    assert wavio.read_wav(p)[0].shape == (0,)
    assert native.decode_file(p)[0].shape == (0,)
    for res in native.batch_ingest([p, str(tmp_path / "z32000.wav")]):
        assert res is not None and res[0].shape == (0,) and res[1] == 44100


def test_truncated_data_rejected_by_both_readers(tmp_path):
    p = tmp_path / "trunc.wav"
    p.write_bytes(_wav_bytes(44100, 1, b"\x01\x02" * 100)[:-60])
    assert native.decode_file(str(p)) is None
    with pytest.raises(wavio.WavError, match="truncated data"):
        wavio.read_wav(str(p))
    assert native.batch_ingest([str(p)]) == [None]
    assert audio.batch_resample_threads([str(p)]) == []


def test_int32_overflow_sample_rate_rejected(tmp_path):
    p = tmp_path / "hugerate.wav"
    p.write_bytes(_wav_bytes(0x80000000, 1, b"\x01\x02" * 64))
    assert native.decode_file(str(p)) is None
    assert native.batch_ingest([str(p)]) == [None]


def test_non_16bit_wav_rejected(tmp_path):
    p = tmp_path / "bad.wav"
    data = b"\x00" * 8
    p.write_bytes(b"RIFF" + struct.pack("<I", 36 + len(data)) + b"WAVE"
                  + b"fmt " + struct.pack("<IHHIIHH", 16, 1, 1, 44100, 44100, 1, 8)
                  + b"data" + struct.pack("<I", len(data)) + data)
    assert native.decode_file(str(p)) is None


def test_bad_target_rate_raises(tmp_path):
    p = str(tmp_path / "ok.wav")
    wavio.write_wav(p, np.zeros(1000, np.int16), 44100)
    for bad in (0, -44100):
        with pytest.raises(ValueError, match="target_rate"):
            native.batch_ingest([p], target_rate=bad)


def test_non_utf8_filename_fails_only_its_clip(tmp_path):
    good = str(tmp_path / "good.wav")
    wavio.write_wav(good, (np.sin(np.linspace(0, 50, 4000)) * 20000).astype(np.int16))
    bad = os.fsdecode(bytes(tmp_path) + b"/bad_\xff.wav")
    with open(os.fsencode(bad), "wb") as f:
        f.write(b"not a wav")
    out = native.batch_ingest([good, bad])
    assert out[0] is not None and out[1] is None


@pytest.fixture
def fresh_loader(monkeypatch):
    """A loader that has not loaded, failed or warned yet."""
    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setattr(native, "_load_failed", False)
    monkeypatch.setattr(native, "_warned_fallback", False)
    monkeypatch.setattr(native, "unavailable_reason", None)
    return monkeypatch


def _symbol_less_library(tmp_path):
    src = tmp_path / "other.cpp"
    src.write_text('extern "C" int other_symbol() { return 0; }\n')
    so = tmp_path / "libother.so"
    subprocess.run(["g++", "-shared", "-fPIC", "-o", str(so), str(src)], check=True)
    return so


@pytest.mark.parametrize("cause", ["OSError", "AttributeError", "sz_version"])
def test_bind_failure_warning_names_its_cause(fresh_loader, tmp_path, cause):
    if cause == "OSError":
        so = tmp_path / "libcorrupt.so"
        so.write_bytes(b"\x7fELF not really a shared library")
    elif cause == "AttributeError":
        so = _symbol_less_library(tmp_path)
    else:
        so = native.so_path()
        native.load()  # a good library, built
        fresh_loader.setattr(native, "_lib", None)
        fresh_loader.setattr(native, "SZ_NATIVE_VERSION", 999)
    fresh_loader.setattr(native, "so_path", lambda: so)
    fresh_loader.setattr(native, "build", lambda target: None)  # leaves it as is
    with pytest.warns(RuntimeWarning, match=cause) as rec:
        assert native.available() is False
    assert len(rec) == 1 and "falling back to the Python thread-pool ingest" in str(
        rec[0].message)
    assert cause in native.unavailable_reason
    assert native.load() is None  # cached, not retried
    with pytest.raises(RuntimeError, match=cause):
        native.batch_ingest(["x.wav"])


def test_failed_build_is_named(fresh_loader, tmp_path):
    fresh_loader.setattr(native, "so_path", lambda: tmp_path / "libnever.so")
    fresh_loader.setattr(native, "_compiler", lambda: str(tmp_path / "no-such-g++"))
    with pytest.warns(RuntimeWarning, match="C\\+\\+ build could not run"):
        assert not native.available()
    assert audio.batch_resample([]) == []  # the thread pool takes over
