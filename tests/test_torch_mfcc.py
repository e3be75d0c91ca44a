"""The port's MFCC frontend (streamz_tpu_torch.dsp) held against the JAX package.

Inputs are made with numpy from a seed and handed to both packages.  Each
tolerance is stated where it is used.  The CUDA kernel K1 itself cannot run
here; its tiling (the layout built by ``mfcc_kernel.kernel_constants``, the
64-row tiles at a stride of 63 with the halo row, the 7 strips of 64 bins,
the parity combine, the bf16x3 products, the tail fold of strip 6 and the
window validity rule) is emulated in numpy and held to its plain version,
and the kernel is held to the plain version on the card by
``tests/test_torch_cuda.py`` and by ``chip_smoke.py``.
"""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from streamz_tpu.dsp import mfcc as jmfcc
from streamz_tpu.dsp import mfcc_ref
from streamz_tpu.dsp.pallas_mfcc import mfcc_base_pallas_v4
from streamz_tpu_torch.dsp import mfcc as tmfcc
from streamz_tpu_torch.dsp import mfcc_kernel
from streamz_tpu_torch.dsp.features import FeatureExtractor

FIX = os.path.join(os.path.dirname(os.path.abspath(__file__)), "fixtures")

# The shapes of test_pallas_mfcc.py's tail-split test: (129, 1600) and
# (513, 800) give rows = 516 and 1026, one full tile plus a short tail.
TAIL_SHAPES = [(1, 800), (1, 2000), (2, 4000), (1, 208000), (3, 208000),
               (129, 1600), (513, 800)]


def _pcm(shape, seed):
    return np.random.default_rng(seed).normal(0, 0.1, shape).astype(np.float32)


@pytest.mark.parametrize("B,T", TAIL_SHAPES)
def test_plain_base_matches_xla_formulation(B, T):
    """Both are f32 on the CPU and differ only in summation order: 1e-4."""
    pcm = _pcm((B, T), 2)
    want = np.asarray(jmfcc.mfcc_base(jnp.asarray(pcm)))
    got = tmfcc.mfcc_base(torch.from_numpy(pcm)).numpy()
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, atol=1e-4)


@pytest.mark.parametrize("B,T", [(1, 2000), (2, 4000), (129, 1600)])
def test_plain_base_matches_k1_interpret(B, T):
    """K1 (run in interpret mode, as the JAX tests run it) splits each f32
    product into bf16x3 passes; its error against f32 is the bound: 1e-3."""
    pcm = _pcm((B, T), 3)
    want = np.asarray(mfcc_base_pallas_v4(jnp.asarray(pcm)))
    got = tmfcc.mfcc_base(torch.from_numpy(pcm)).numpy()
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, atol=1e-3)


def _split64(a) -> list:
    """``bf16_split`` of an f32 array, as float64 planes (their products are
    exact in float64)."""
    planes = mfcc_kernel.bf16_split(torch.from_numpy(np.asarray(a, np.float32)))
    return [p.float().numpy().astype(np.float64) for p in planes]


def _emulate_kernel(pcm: np.ndarray) -> np.ndarray:
    """numpy model of K1's tiling (csrc/mfcc_base.cu on mfcc_tc.cuh): tiles
    of 64 block rows at a stride of 63 (the last row the halo), 7 strips of
    64 bins (cos | -sin), the bf16x3 DFT and mel products, the parity
    combine, strip 6's re^2 and im^2 split apart (the tail fold), each
    window written by one tile; sums in float64, splits of f32 values."""
    c = mfcc_kernel.kernel_constants()
    dh, dl = _split64(c["basis"])
    mh, ml = _split64(c["mel_dense"])
    B, T = pcm.shape
    nb = T // 400
    R = B * nb
    out = np.full((B, max(nb - 1, 0), 20), np.nan)
    sign = np.where(np.arange(64) % 2 == 1, -1.0, 1.0)
    flat = pcm[:, : nb * 400].reshape(R, 400)
    for r0 in range(0, R - 1, 63):
        rows = np.arange(r0, r0 + 64)
        x = np.zeros((64, 400), np.float32)
        x[rows < R] = flat[rows[rows < R]]
        xh, xl = _split64(x)
        mel = np.zeros((64, 32))
        for s in range(7):
            cols = slice(s * 128, (s + 1) * 128)
            p = xh @ dh[:, cols] + xh @ dl[:, cols] + xl @ dh[:, cols]
            nxt = np.vstack([p[1:], np.zeros((1, 128))])
            re = (p[:, :64] + sign * nxt[:, :64]).astype(np.float32)
            im = (p[:, 64:] + sign * nxt[:, 64:]).astype(np.float32)
            bins = slice(s * 64, (s + 1) * 64)
            for pw in ([re * re, im * im] if s == 6 else [re * re + im * im]):
                ph, pl = _split64(pw)
                mel += ph @ mh[bins] + ph @ ml[bins] + pl @ mh[bins]
        o = np.log(np.maximum(mel[:, :26], 1e-12)) @ c["dct"].T.astype(np.float64)
        for w in range(63):
            r = r0 + w
            if r < R and r % nb < nb - 1:
                assert np.isnan(out[r // nb, r % nb]).all(), "a window written twice"
                out[r // nb, r % nb] = o[w]
    return out


@pytest.mark.parametrize("B,T", [(1, 800), (1, 2000), (129, 1600), (3, 60000)])
def test_kernel_tiling_emulation_matches_plain(B, T):
    """Every window is written exactly once by K1's tiling, and the padded
    basis, the parity combine, the bf16x3 products and the tail fold
    reproduce K1's plain version (float64 sums vs f32: 1e-4)."""
    pcm = _pcm((B, T), 4)
    got = _emulate_kernel(pcm)
    assert not np.isnan(got).any()
    want = mfcc_kernel.mfcc_base_bf16x3_plain(
        torch.from_numpy(pcm), True, tail_fold=True).numpy()
    np.testing.assert_allclose(got, want, atol=1e-4)


def test_kernel_constants_layout():
    c = mfcc_kernel.kernel_constants()
    assert c["basis"].shape == (400, 896)
    from streamz_tpu.dsp.mel import dft_block_matrices, mel_filterbank

    ct, st = dft_block_matrices()
    basis = c["basis"].reshape(400, 7, 2, 64)
    np.testing.assert_array_equal(
        basis[:, :, 0, :].reshape(400, -1)[:, :401], ct.astype(np.float32))
    np.testing.assert_array_equal(
        basis[:, :, 1, :].reshape(400, -1)[:, :401], st.astype(np.float32))
    assert not basis[:, 6, :, 17:].any()  # bins 401..447 are padding
    fb = mel_filterbank()
    dense = np.zeros_like(fb, dtype=np.float32)
    for m in range(26):
        lo, hi, off = c["mel_lo"][m], c["mel_hi"][m], c["mel_off"][m]
        dense[m, lo:hi] = c["fbw"][off:off + hi - lo]
    np.testing.assert_array_equal(dense, fb.astype(np.float32))


def test_features_match_golden():
    """The existing golden gate: 1e-3 against the frozen numpy spec."""
    clip = np.load(os.path.join(FIX, "golden_clip.npy"))
    want = np.load(os.path.join(FIX, "golden_features.npy"))
    got = tmfcc.extract_features(clip, device="cpu")
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, atol=1e-3)


@pytest.mark.parametrize("n", [800, 1199, 20000, 44100])
def test_features_match_numpy_spec(n):
    """The frozen numpy spec (dsp/mfcc_ref.py) on seeded i16 noise: the
    1e-3 golden gate."""
    clip = np.random.default_rng(n).normal(0, 3000, n).astype(np.int16)
    want = mfcc_ref.extract_features_np(clip)
    got = FeatureExtractor("auto", device="cpu").extract(clip)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, atol=1e-3)


def test_full_chain_matches_golden_ingest_features(tmp_path, monkeypatch):
    """The whole host chain (MP3 decode, 32 kHz -> 44.1 kHz resample) plus
    the frontend reproduces the frozen fixture within the 1e-3 golden gate.
    Its source clip is the reference's bundled sample data, as for the JAX
    package's own test of this fixture."""
    from streamz_tpu_torch.io.audio import load_and_resample_file

    src = os.path.join("/root/reference/streamz-rs/examples/training_data",
                       "common_voice_fr_41911269.mp3")
    if not os.path.exists(src):
        pytest.skip("reference sample data absent")
    monkeypatch.chdir(tmp_path)
    _, pcm = load_and_resample_file(src)
    want = np.load(os.path.join(FIX, "golden_ingest_features.npy"))
    got = FeatureExtractor("auto", device="cpu").extract(pcm)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, atol=1e-3)


@pytest.mark.parametrize("n_win", [[0, 0], [1, 5], [0, 7], [3, 1], [7, 7]])
def test_deltas_and_norm_matches_jax(n_win):
    """Ragged valid-window counts, including 0 and 1: f32 elementwise work,
    1e-5."""
    base = np.random.default_rng(5).normal(0, 3, (2, 7, 20)).astype(np.float32)
    nw = np.asarray(n_win, np.int32)
    want = np.asarray(jmfcc.deltas_and_norm(jnp.asarray(base), jnp.asarray(nw)))
    got = tmfcc.deltas_and_norm(torch.from_numpy(base), torch.from_numpy(nw)).numpy()
    np.testing.assert_allclose(got, want, atol=1e-5)


def test_window_count_and_bucket_len():
    ns = np.asarray([0, 399, 400, 799, 800, 1199, 1200, 441000], np.int64)
    want = np.asarray(jmfcc.window_count(jnp.asarray(ns)))
    got = tmfcc.window_count(torch.from_numpy(ns)).numpy()
    np.testing.assert_array_equal(got, want)
    assert [tmfcc.window_count_host(int(n)) for n in ns] == list(want)
    for n in [0, 1, 399, 400, 1600, 1601, 441000]:
        assert tmfcc._bucket_len(n) == jmfcc._bucket_len(n)
    assert tmfcc._bucket_len(441000) == 2048 * 400


@pytest.mark.parametrize("T", [399, 100])
def test_zero_block_clips(T):
    pcm = torch.zeros((2, T))
    assert tmfcc.mfcc_base(pcm).shape == (2, 0, 20)
    assert mfcc_kernel.mfcc_base_v4(pcm).shape == (2, 0, 20)
    feats = tmfcc.mfcc_features(pcm, torch.tensor([T, 100]))
    assert feats.shape == (2, 0, 60)
    assert mfcc_kernel.mfcc_features_v4(pcm, torch.tensor([T, 100])).shape == (2, 0, 60)


def test_extract_features_batch_mixed_lengths_matches_jax():
    """Mixed-length clips across three buckets (one shorter than a window):
    f32 frontend plus z-norm, which divides by a per-frame std: 1e-4."""
    rng = np.random.default_rng(6)
    clips = [rng.normal(0, 3000, n).astype(np.int16)
             for n in (700, 4000, 9000, 12345, 4400)]
    want = jmfcc.extract_features_batch(clips)
    got = tmfcc.extract_features_batch(clips, device="cpu")
    for w, g in zip(want, got):
        assert g.shape == w.shape
        np.testing.assert_allclose(g, w, atol=1e-4)


def test_extractor_backends_on_cpu():
    """'auto' on CPU tensors runs the plain formulation (no kernel launch);
    'plain' is the same function; 'numpy' runs the port's golden spec;
    'jax' is spelled 'plain' here."""
    clip = np.random.default_rng(8).normal(0, 3000, 6000).astype(np.int16)
    before = mfcc_kernel.mfcc_base_v4.launches
    a = FeatureExtractor("auto", device="cpu").extract(clip)
    b = FeatureExtractor("plain", device="cpu").extract(clip)
    np.testing.assert_array_equal(a, b)
    assert mfcc_kernel.mfcc_base_v4.launches == before
    np.testing.assert_array_equal(
        FeatureExtractor("numpy", device="cpu").extract(clip),
        mfcc_ref.extract_features_np(clip))
    with pytest.raises(ValueError):
        FeatureExtractor("jax", device="cpu")

