"""Every frontend backend of the port held against the JAX package.

The port's ``FeatureExtractor`` takes the JAX package's seven backend names
(``'plain'`` standing for ``'jax'``); on the card each kernel backend runs
its own CUDA kernel (K1-K4), and on the CPU its kernel's plain version,
which is what these tests run.  Each plain version is held to the TPU
kernel it stands for, run in interpret mode as the JAX package's own tests
run it; the measured ``'auto'`` choice is held to the JAX package's rules
with fake probes.  Inputs are made with numpy from a seed; each tolerance
is stated where it is used.  The kernels themselves are held to these plain
versions on the card by ``tests/test_torch_cuda.py`` and ``chip_smoke.py``.
"""

import json
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from streamz_tpu.dsp import features as jfeatures
from streamz_tpu.dsp import mfcc_ref as jmfcc_ref
from streamz_tpu.dsp import pallas_mfcc
from streamz_tpu.infer import identify as jidentify
from streamz_tpu.nn import model as jmodel
from streamz_tpu_torch import _cuda_build
from streamz_tpu_torch import cli as tcli
from streamz_tpu_torch.dsp import features, mfcc, mfcc_kernel, mfcc_ref
from streamz_tpu_torch.infer import identify as tidentify
from streamz_tpu_torch.nn.convert import params_from_numpy
from streamz_tpu_torch.nn.model import SpeakerMLP, SpeakerNet, forward
from streamz_tpu_torch.runtime import autotune

FIX = os.path.join(os.path.dirname(os.path.abspath(__file__)), "fixtures")
KERNEL_BACKENDS = ("pallas", "pallas_v2", "pallas_v3", "pallas_v4")
DEVICE_BACKENDS = ("auto", "plain") + KERNEL_BACKENDS
# The shapes of test_pallas_mfcc.py:141-142; (129, 1600) and (513, 800)
# give rows = 516 and 1026, the tail shapes that truncated on the TPU.
TAIL_SHAPES = [(1, 800), (1, 2000), (2, 4000), (1, 208000), (3, 208000),
               (129, 1600), (513, 800)]


def _pcm(shape, seed):
    return np.random.default_rng(seed).normal(0, 0.1, shape).astype(np.float32)


# ---------------------------------------------------------------------------
# Each plain version against its TPU kernel in interpret mode.
# ---------------------------------------------------------------------------

# (port plain version, JAX kernel, tolerance).  Every plain version computes
# its TPU kernel's bf16x3 products (K1 with v4's tail fold, K4 over the
# 800-tap frame basis) and sums them in another order: about 1e-5 to 3e-5
# on seeded noise, well inside 1e-4.
PLAIN_VS_TPU = {
    "K1": (lambda x: mfcc_kernel.mfcc_base_bf16x3_plain(x, True, tail_fold=True),
           pallas_mfcc.mfcc_base_pallas_v4, 1e-4),
    "K4": (mfcc_kernel.mfcc_base_frames_plain, pallas_mfcc.mfcc_base_pallas, 1e-4),
    "K3": (lambda x: mfcc_kernel.mfcc_base_bf16x3_plain(x, False),
           pallas_mfcc.mfcc_base_pallas_v2, 1e-4),
    "K2": (lambda x: mfcc_kernel.mfcc_base_bf16x3_plain(x, True),
           pallas_mfcc.mfcc_base_pallas_v3, 1e-4),
}


@pytest.mark.parametrize("kid", sorted(PLAIN_VS_TPU))
@pytest.mark.parametrize("B,T", [(1, 2000), (2, 4000), (3, 12000), (129, 1600), (513, 800)])
def test_plain_version_matches_tpu_kernel_interpret(kid, B, T):
    plain, tpu, tol = PLAIN_VS_TPU[kid]
    pcm = _pcm((B, T), 3)
    want = np.asarray(tpu(jnp.asarray(pcm)))
    got = plain(torch.from_numpy(pcm)).numpy()
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, atol=tol)


@pytest.mark.parametrize("kid", sorted(PLAIN_VS_TPU))
def test_plain_version_matches_tpu_kernel_on_silence(kid):
    """A zero clip next to a quiet one: the log floor, where small absolute
    power errors would grow, gives the same MFCCs."""
    plain, tpu, tol = PLAIN_VS_TPU[kid]
    pcm = np.zeros((2, 6000), np.float32)
    pcm[1] = _pcm((6000,), 4) * 1e-3
    want = np.asarray(tpu(jnp.asarray(pcm)))
    got = plain(torch.from_numpy(pcm)).numpy()
    np.testing.assert_allclose(got, want, atol=tol)


def test_bf16_split_matches_the_tpu_kernels():
    """The hi/lo planes the port uploads are the JAX package's, bit for bit."""
    a = _pcm((400, 64), 5) * 30
    jhi, jlo = pallas_mfcc._bf16_split(a)
    hi, lo = mfcc_kernel.bf16_split(torch.from_numpy(a))
    np.testing.assert_array_equal(hi.float().numpy(), jhi.astype(np.float32))
    np.testing.assert_array_equal(lo.float().numpy(), jlo.astype(np.float32))


def test_kernel_constants_layouts():
    """K4's [800, 896] basis groups the full-window DFT as ``basis`` groups
    the block DFT; K2's dense mel planes split the filterbank exactly."""
    c = mfcc_kernel.kernel_constants()
    dft = pallas_mfcc._kernel_constants()
    full = (dft[0].astype(np.float32) + dft[1].astype(np.float32))  # hi + lo
    fb = c["frame_basis"].reshape(800, 7, 2, 64)
    cos = fb[:, :, 0, :].reshape(800, -1)[:, :401]
    sin = fb[:, :, 1, :].reshape(800, -1)[:, :401]
    np.testing.assert_allclose(cos, full[:, :401], atol=1e-5)
    np.testing.assert_allclose(sin, full[:, 512:913], atol=1e-5)
    assert not fb[:, 6, :, 17:].any()
    mel = c["mel_dense"]
    assert mel.shape == (448, 32) and not mel[401:].any() and not mel[:, 26:].any()
    hi, lo = mfcc_kernel.bf16_split(torch.from_numpy(mel))
    np.testing.assert_allclose((hi.float() + lo.float()).numpy(), mel, rtol=1e-5)


def _bits(t):
    return t.contiguous().view(torch.int16).numpy().view(np.uint16)


def _unswizzle32(blocks):
    """Undo wgmma's 32-byte swizzle on [..., rows, 2, 8] blocks: row n's two
    16-byte halves are swapped when n // 4 is odd."""
    out = blocks.copy()
    odd = (np.arange(blocks.shape[-3]) // 4) % 2 == 1
    out[..., odd, :, :] = out[..., odd, :, :][..., ::-1, :]
    return out


def _unpermute_stages(stages, steps):
    """[7, steps, 4096] ring stages -> the (hi, lo) uint16 planes
    [16 steps, 896] they were laid out from (the inverse of
    ``tc_basis_stages``)."""
    s = _unswizzle32(stages.reshape(7, steps, 2, 128, 2, 8))
    return [s[:, :, plane].transpose(1, 3, 4, 0, 2).reshape(16 * steps, 896)
            for plane in range(2)]


def test_tc_stage_layouts_unpermute_to_the_split_constants():
    """K2's and K3's ring stages, un-permuted from wgmma's swizzled K-major
    blocks, are ``basis`` and ``mel_dense`` split into bf16 hi and lo, bit
    for bit: stage (strip, step) holds plane p at p * 2048 elements, column
    n's 16 k at 16 n; a mel stage holds k16 step i at 512 i + 2048 p, mel
    n's 16 bins at 16 n."""
    c = mfcc_kernel.kernel_constants()
    stages = c["basis_tc"]
    assert stages.shape == (7, 25, 4096) and stages.dtype == np.uint16
    for got, want in zip(_unpermute_stages(stages, 25),
                         mfcc_kernel.bf16_split(torch.from_numpy(c["basis"]))):
        np.testing.assert_array_equal(got, _bits(want))
    mel = c["mel_tc"]
    assert mel.shape == (7, 4096) and mel.dtype == np.uint16
    # [strip, plane, step, n, k8, kk] -> plane [bin = (strip, step, k8, kk), mel n]
    m = _unswizzle32(mel.reshape(7, 2, 4, 32, 2, 8))
    for plane, want in zip(range(2), mfcc_kernel.bf16_split(torch.from_numpy(c["mel_dense"]))):
        got = m[:, plane].transpose(0, 1, 3, 4, 2).reshape(448, 32)
        np.testing.assert_array_equal(got, _bits(want))


def test_frame_stages_unpermute_to_the_tpu_kernels_split_basis():
    """K4's ring stages, un-permuted, are the TPU kernel's own bf16 hi and
    lo planes of the 800-tap basis (``_kernel_constants``: cos bins at
    columns 0..400, -sin at 512..912), bit for bit; bins 401..447 are zero."""
    c = mfcc_kernel.kernel_constants()
    stages = c["frame_basis_tc"]
    assert stages.shape == (7, 50, 4096) and stages.dtype == np.uint16
    dft_hi, dft_lo = pallas_mfcc._kernel_constants()[:2]
    for got, want in zip(_unpermute_stages(stages, 50), (dft_hi, dft_lo)):
        want = np.asarray(want).view(np.uint16)
        grouped = got.reshape(800, 7, 2, 64)
        cos = grouped[:, :, 0].reshape(800, 448)
        sin = grouped[:, :, 1].reshape(800, 448)
        np.testing.assert_array_equal(cos[:, :401], want[:, :401])
        np.testing.assert_array_equal(sin[:, :401], want[:, 512:913])
        assert not cos[:, 401:].any() and not sin[:, 401:].any()


def test_k1_mel_stages_read_as_the_tpu_kernels_doubled_tail():
    """K1's mel stages are K2's, with strip 6 (bins 384..447) read twice,
    under the tail's re^2 and im^2 planes.  Un-permuted, strips 0..5 and
    strip 6 stacked twice are the TPU kernel v4's split mel rows 0..511
    (``_kernel4_constants``, rows 384..400 doubled at 448..464), bit for bit."""
    c = mfcc_kernel.kernel_constants()
    m = _unswizzle32(c["mel_tc"].reshape(7, 2, 4, 32, 2, 8))
    _, _, mel_cat, mel_hi, _ = pallas_mfcc._kernel4_constants()
    mel_lo = mel_cat[:, pallas_mfcc._CH_PAD:]
    for plane, want in zip(range(2), (mel_hi, mel_lo)):
        got = m[:, plane].transpose(0, 1, 3, 4, 2).reshape(448, 32)
        read = np.concatenate([got, got[384:]])  # strip 6 a second time
        np.testing.assert_array_equal(read, np.asarray(want).view(np.uint16)[:, :32])


# ---------------------------------------------------------------------------
# The frontend as a whole: every backend.
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("backend", features._BACKENDS)
def test_every_backend_matches_golden_features(backend):
    """The existing golden gate, 1e-3, for each of the seven backends."""
    clip = np.load(os.path.join(FIX, "golden_clip.npy"))
    want = np.load(os.path.join(FIX, "golden_features.npy"))
    got = features.FeatureExtractor(backend, device="cpu").extract(clip)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, atol=1e-3)


@pytest.mark.parametrize("backend", features._BACKENDS)
def test_every_backend_matches_numpy_backend(backend):
    """Ragged i16 clips in three buckets (one shorter than a window)
    against the port's 'numpy' backend: the 1e-3 gate."""
    rng = np.random.default_rng(21)
    clips = [rng.normal(0, 3000, n).astype(np.int16) for n in (700, 4000, 9000, 12345)]
    want = features.FeatureExtractor("numpy", device="cpu").extract_batch(clips)
    got = features.FeatureExtractor(backend, device="cpu").extract_batch(clips)
    for g, w in zip(got, want):
        assert g.shape == w.shape
        np.testing.assert_allclose(g, w, atol=1e-3)


@pytest.mark.parametrize("n,dtype", [(0, np.int16), (799, np.int16), (800, np.int16),
                                     (20000, np.int16), (44100, np.float32)])
def test_numpy_spec_equals_jax_package_bit_for_bit(n, dtype):
    rng = np.random.default_rng(n + 1)
    if dtype == np.int16:
        clip = rng.normal(0, 3000, n).astype(np.int16)
    else:
        clip = rng.uniform(-0.5, 0.5, n).astype(np.float32)
    want = jmfcc_ref.extract_features_np(clip)
    got = mfcc_ref.extract_features_np(clip)
    assert got.dtype == want.dtype and got.shape == want.shape
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("kid", sorted(mfcc_kernel.WRAPPERS))
@pytest.mark.parametrize("T", [100, 399, 799])
def test_every_kernel_wrapper_short_clips(kid, T):
    """Fewer than two blocks: [B, 0, 20] base and [B, 0, 60] features,
    without a launch."""
    wrapper = mfcc_kernel.WRAPPERS[kid]
    before = wrapper.launches
    pcm = torch.zeros((2, T))
    assert wrapper(pcm).shape == (2, 0, 20)
    core = features.frontend_core(
        {"K1": "pallas_v4", "K2": "pallas_v3", "K3": "pallas_v2", "K4": "pallas"}[kid])
    assert core(pcm, torch.tensor([T, 50])).shape == (2, 0, 60)
    assert wrapper.launches == before


@pytest.mark.parametrize("kid", ["K1", "K2", "K3", "K4"])
@pytest.mark.parametrize("B,T", TAIL_SHAPES)
def test_every_kernel_wrapper_tail_shapes(kid, B, T):
    """The tail shapes through each wrapper's CPU path against the f32 plain
    formulation: bf16x3 (K4 over the 800-tap DFT) against f32, the 1e-3
    gate."""
    pcm = torch.from_numpy(_pcm((B, T), 6))
    got = mfcc_kernel.WRAPPERS[kid](pcm)
    want = mfcc.mfcc_base(pcm)
    assert got.shape == want.shape == (B, max(T // 400 - 1, 0), 20)
    np.testing.assert_allclose(got.numpy(), want.numpy(), atol=1e-3)


def test_backend_names_and_numpy_core():
    """The JAX names, with 'plain' for 'jax'; 'numpy' has no device core."""
    assert features._BACKENDS == tuple(
        "plain" if b == "jax" else b for b in jfeatures._BACKENDS)
    with pytest.raises(ValueError, match="unknown backend"):
        features.FeatureExtractor("jax", device="cpu")
    with pytest.raises(ValueError, match="no device core"):
        features.frontend_core("numpy")
    with pytest.raises(ValueError, match="unknown frontend backend"):
        features.frontend_core("pallas_v9")
    assert features.frontend_core("pallas") is mfcc_kernel.mfcc_features_frames
    assert features.FeatureExtractor("pallas_v2", device="cpu").resolved() == "pallas_v2"


def test_global_extractor_is_built_at_first_use(monkeypatch, tmp_path):
    """Importing builds no extractor; without a card the global one raises
    at first use; ``load_cached_features(path)`` and
    ``with_thread_extractor`` hand out the global extractor."""
    from streamz_tpu_torch.io import wav

    monkeypatch.setattr(features, "_global", None)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        features.with_thread_extractor(lambda ex: ex)
    cpu = features.FeatureExtractor(device="cpu")
    monkeypatch.setattr(features, "_global", cpu)
    assert features.with_thread_extractor(lambda ex: ex) is cpu
    monkeypatch.chdir(tmp_path)
    clip = np.random.default_rng(3).normal(0, 3000, 9000).astype(np.int16)
    wav.write_wav("a.wav", clip)
    got = features.load_cached_features("a.wav")
    np.testing.assert_array_equal(got, cpu.extract(clip))
    np.testing.assert_array_equal(features.load_cached_features("a.wav"), got)


# ---------------------------------------------------------------------------
# The measured 'auto' choice.
# ---------------------------------------------------------------------------


@pytest.fixture()
def fake_card(monkeypatch, tmp_path):
    """autotune sees a card named 'FakeCard' and a fresh cache file."""
    path = tmp_path / "tune.json"
    monkeypatch.setenv("STREAMZ_AUTOTUNE_CACHE", str(path))
    monkeypatch.delenv("STREAMZ_NO_AUTOTUNE", raising=False)
    monkeypatch.setattr(autotune, "on_cuda", lambda: True)
    monkeypatch.setattr(autotune, "device_kind", lambda: "FakeCard")
    autotune.reset()
    yield path
    autotune.reset()


def _probes(times, calls):
    def make(name):
        def probe():
            calls.append(name)
            return times[name]
        return probe
    return {name: make(name) for name in times}


def test_auto_on_cpu_is_plain_without_probing(monkeypatch):
    def no_probe(*a, **k):
        raise AssertionError("probed on the CPU")

    monkeypatch.setattr(features, "_time_frontend", no_probe)
    autotune.reset("frontend")
    assert features.autotune_frontend(force=True) == "plain"
    assert features.autotune_frontend() == "plain"
    assert features.FeatureExtractor(device="cpu").resolved() == "plain"
    autotune.reset("frontend")


def test_fastest_candidate_wins_and_round_trips_the_disk_cache(fake_card):
    calls = []
    times = {"pallas_v3": 2.0, "pallas_v4": 1.0}
    assert autotune.measured_choice("frontend", _probes(times, calls), "x") == "pallas_v4"
    assert sorted(calls) == ["pallas_v3", "pallas_v4"]
    assert autotune.probe_times["frontend:FakeCard"] == times
    entry = json.loads(fake_card.read_text())["frontend:FakeCard"]
    assert entry == {"choice": "pallas_v4", "candidates": ["pallas_v3", "pallas_v4"]}
    # A later process: no in-process memory, the same candidates, no probe.
    autotune.reset()
    calls.clear()
    assert autotune.measured_choice("frontend", _probes(times, calls), "x") == "pallas_v4"
    assert calls == []
    assert autotune.cached_choice("frontend", "d", "o") == "pallas_v4"


def test_changed_candidate_set_probes_anew(fake_card):
    calls = []
    autotune.measured_choice("frontend", _probes({"a": 1.0, "b": 2.0}, calls), "a")
    autotune.reset()
    calls.clear()
    got = autotune.measured_choice(
        "frontend", _probes({"a": 1.0, "b": 2.0, "c": 0.5}, calls), "a")
    assert got == "c" and sorted(calls) == ["a", "b", "c"]


def test_a_rebuilt_candidate_probes_anew(fake_card):
    """A decision holds only for the kernel builds it measured: a changed
    source hash of one candidate probes both again."""
    calls = []
    times = {"pallas_v3": 2.0, "pallas_v4": 1.0}
    got = autotune.measured_choice("frontend", _probes(times, calls), "x",
                                   versions={"pallas_v3": "aaa", "pallas_v4": "bbb"})
    assert got == "pallas_v4"
    entry = json.loads(fake_card.read_text())["frontend:FakeCard"]
    assert entry["candidates"] == ["pallas_v3@aaa", "pallas_v4@bbb"]
    # Another process with the same builds: no probe.
    autotune.reset()
    calls.clear()
    got = autotune.measured_choice("frontend", _probes(times, calls), "x",
                                   versions={"pallas_v3": "aaa", "pallas_v4": "bbb"})
    assert got == "pallas_v4" and calls == []
    # K2 rebuilt from changed sources, now faster: probed again, and it wins.
    autotune.reset()
    times["pallas_v3"] = 0.5
    got = autotune.measured_choice("frontend", _probes(times, calls), "x",
                                   versions={"pallas_v3": "ccc", "pallas_v4": "bbb"})
    assert got == "pallas_v3" and sorted(calls) == ["pallas_v3", "pallas_v4"]


def test_no_autotune_with_a_cold_cache_takes_the_static_default(fake_card, monkeypatch):
    monkeypatch.setenv("STREAMZ_NO_AUTOTUNE", "1")
    calls = []
    got = autotune.measured_choice(
        "frontend", _probes({"pallas_v3": 0.5, "pallas_v4": 1.0}, calls), "pallas_v4")
    assert got == "pallas_v4" and calls == []
    assert not fake_card.exists()  # never persisted
    assert autotune.probing_disabled()


def test_a_probe_that_raises_makes_measured_choice_raise(fake_card):
    """The no-fallback rule: a candidate kernel that cannot build or launch
    fails the run instead of quietly losing its probe."""
    def broken():
        raise RuntimeError("nvcc failed")

    with pytest.raises(RuntimeError, match="nvcc failed"):
        autotune.measured_choice("frontend", {"pallas_v3": broken,
                                              "pallas_v4": lambda: 1.0}, "pallas_v4")
    assert not fake_card.exists()


def test_autotune_frontend_measures_k2_against_k1(fake_card, monkeypatch):
    """The frontend's candidates are K2 ('pallas_v3') and K1 ('pallas_v4'),
    probed at the JAX package's [32, 441600] with 16 calls per timing; the
    plain version is no candidate."""
    seen = {}

    def fake_time(core, pcm, ns, iters=8):
        seen[core.__name__] = (tuple(pcm.shape), iters)
        return {"mfcc_features_v3": 0.5, "mfcc_features_v4": 1.0}[core.__name__]

    monkeypatch.setattr(features, "_time_frontend", fake_time)
    monkeypatch.setattr(features, "resolve_device", lambda d=None: torch.device("cpu"))
    assert features.autotune_frontend(force=True) == "pallas_v3"
    assert seen == {"mfcc_features_v3": ((32, 441600), 16),
                    "mfcc_features_v4": ((32, 441600), 16)}
    assert features.frontend_core("auto") is mfcc_kernel.mfcc_features_v3
    # The cached decision names the sources of the builds it measured.
    entry = json.loads(fake_card.read_text())["frontend:FakeCard"]
    assert entry["candidates"] == [
        f"pallas_v3@{_cuda_build.source_hash('mfcc_v3')}",
        f"pallas_v4@{_cuda_build.source_hash('mfcc_base')}",
    ]


def test_cli_accepts_no_autotune(tmp_path, monkeypatch, capsys):
    # setenv, not delenv: monkeypatch then restores the variable's prior
    # state after the CLI has set it.
    monkeypatch.setenv("STREAMZ_NO_AUTOTUNE", "0")
    monkeypatch.chdir(tmp_path)
    rc = tcli.main(["--identify", "a.wav", "--no-autotune", "--device", "cpu"])
    assert rc == 1  # no model.npz here, but the flag is not refused
    err = capsys.readouterr().err
    assert "not yet ported" not in err and "Failed to load model" in err
    assert os.environ["STREAMZ_NO_AUTOTUNE"] == "1"


# ---------------------------------------------------------------------------
# The slice as a whole: the vote pipeline through every backend.
# ---------------------------------------------------------------------------

SPEAKERS = [(110.0, 0.55), (190.0, 0.8), (300.0, 0.35)]  # (f0, harmonic decay)
THRESHOLD = 0.5


def _voice(rng, f0, decay, seconds, rate=44100):
    t = np.arange(int(seconds * rate)) / rate
    x = sum(decay ** h * np.sin(2 * np.pi * f0 * (h + 1) * t + rng.uniform(0, 6.3))
            for h in range(12))
    x = x * (1 + 0.3 * np.sin(2 * np.pi * 3 * t)) + rng.normal(0, 0.05, t.shape)
    return np.clip(x / np.abs(x).max() * 12000, -32768, 32767).astype(np.int16)


@pytest.fixture(scope="module")
def vote_corpus():
    """Seeded clips of three voices plus noise, and a small 60->32->16 net
    with three speakers, the same parameters in both packages."""
    rng = np.random.default_rng(4)
    clips = [_voice(rng, *SPEAKERS[i % 3], 0.3 + 0.05 * i) for i in range(6)]
    clips.append(rng.normal(0, 4000, 12000).astype(np.int16))
    jnet = jmodel.SpeakerNet.new(60, 32, 16, 3, seed=11)
    tnet = SpeakerNet(
        mlp=SpeakerMLP(params_from_numpy(
            {k: np.asarray(v) for k, v in jnet.params.items()}, device="cpu")),
        num_speakers=3, file_lists=[[], [], []])
    return clips, jnet, tnet


def test_vote_corpus_is_far_from_every_gate(vote_corpus):
    """No window's best probability lies within 1e-3 of the threshold or of
    the runner-up, so a 1e-3 feature difference cannot change a vote."""
    clips, _, tnet = vote_corpus
    for c in clips:
        f = torch.from_numpy(mfcc_ref.extract_features_np(c))
        p = np.sort(forward(tnet.params, f, 3).numpy()[:, :3], axis=1)
        assert np.abs(p[:, -1] - THRESHOLD).min() > 1e-3
        assert (p[:, -1] - p[:, -2]).min() > 1e-3


@pytest.mark.parametrize("backend", DEVICE_BACKENDS + ("numpy",))
def test_vote_pipeline_through_every_backend_matches_jax(vote_corpus, backend):
    clips, jnet, tnet = vote_corpus
    want = jidentify.identify_speaker_list_batch(jnet, clips, THRESHOLD)
    got = tidentify.identify_speaker_list_batch(
        tnet, clips, THRESHOLD, features.FeatureExtractor(backend, device="cpu"))
    assert got == want
    assert sum(1 for g in got if g) >= 3
