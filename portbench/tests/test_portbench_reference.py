"""The frozen plain reference against the port's CPU path at a tiny size."""

import numpy as np
import pytest
import torch

from portbench.reference import mfcc_np, plain, prng, resample
from streamz_tpu_torch.app import corpus as port_corpus
from streamz_tpu_torch.dsp import mfcc_ref as port_mfcc
from streamz_tpu_torch.dsp import resample as port_resample
from streamz_tpu_torch.infer.cosine import identify_sims_cosine
from streamz_tpu_torch.nn import prng as port_prng
from streamz_tpu_torch.nn import train as port_train
from streamz_tpu_torch.nn.model import SpeakerNet, init_params


def _clip(seed, n=9000):
    rng = np.random.default_rng(seed)
    t = np.arange(n) / 44100
    x = 6000 * np.sin(2 * np.pi * 180 * t) + 800 * rng.normal(size=n)
    return np.clip(x, -32768, 32767).astype(np.int16)


def test_mfcc_matches_the_golden_spec():
    pcm = _clip(1)
    want = port_mfcc.extract_features_np(pcm)
    got = plain.mfcc(torch.from_numpy(plain.pcm_to_f32(pcm))).numpy()
    assert got.shape == want.shape
    assert np.abs(got - want).max() < 1e-4
    assert np.array_equal(mfcc_np.extract_features_np(pcm), want)  # the frozen copy


def test_tf32_control_moves_the_features():
    pcm = torch.from_numpy(plain.pcm_to_f32(_clip(2)))
    gap = (plain.mfcc(pcm, tf32=True) - plain.mfcc(pcm)).abs().max()
    assert gap > 3e-4  # FP32 reads about 1e-6 (test_mfcc_matches_the_golden_spec)


def test_keys_and_draws_bit_for_bit():
    for mine, port in ((prng, port_prng),):
        k = mine.fold_in(mine.PRNGKey(1), 5)
        assert torch.equal(k, port.fold_in(port.PRNGKey(1), 5))
        assert torch.equal(mine.uniform(mine.split(k, 3), (4, 7)),
                           port.uniform(port.split(k, 3), (4, 7)))


def test_resample_bit_for_bit():
    pcm = _clip(3, 16000)
    assert np.array_equal(resample.resample_to_44100(pcm, 16000),
                          port_resample.resample_to_44100(pcm, 16000))


def test_init_matches_the_port():
    a = plain.init_params(3, seed=7)
    b = init_params(60, 512, 256, 3, seed=7, device="cpu")
    assert all(torch.equal(a[k], b[k]) for k in plain.NAMES)


def test_file_training_matches_the_port():
    torch.manual_seed(0)
    params = plain.init_params(3, seed=1)
    windows = torch.zeros(32, 60)
    windows[:21] = torch.randn(21, 60)
    key = plain.file_key(4)
    want = {k: v.clone() for k, v in params.items()}
    tvec = torch.zeros(128)
    tvec[2] = 1.0
    port_train.train_on_windows_impl(want, windows, 21, tvec, 3, key, 0.05, 0.2,
                                     epochs=5, batch_size=8)
    got = plain.train_file(params, windows, 21, 2, 3, key, 0.05)
    for k in plain.NAMES:
        assert torch.allclose(got[k], want[k], atol=2e-6, rtol=1e-5), k


def test_corpus_training_matches_the_port():
    rng = np.random.default_rng(0)
    x = rng.normal(size=(300, 60)).astype(np.float32)
    y = rng.integers(0, 3, 300).astype(np.int32)
    net = SpeakerNet.new(output=3, device="cpu")
    port_corpus.train_corpus(net, x, y, epochs=3, batch_size=128, lr=0.01, dropout=0.2, seed=0)
    got = plain.train_corpus(plain.init_params(3, seed=0), torch.from_numpy(x),
                             torch.from_numpy(y.astype(np.int64)), 3, epochs=3,
                             batch_size=128)
    for k in plain.NAMES:
        assert torch.allclose(got[k], net.params[k], atol=1e-6, rtol=1e-5), k


@pytest.mark.parametrize("n_spk", [5, 250])
def test_gate_matches_the_port(n_spk):
    rng = np.random.default_rng(n_spk)
    for _ in range(50):
        sims = rng.uniform(0.3, 1.0, n_spk).astype(np.float32)
        stats = [(None, float(m), float(s)) for m, s in
                 zip(rng.uniform(0.6, 0.95, n_spk), rng.uniform(0.0, 0.1, n_spk))]
        want = identify_sims_cosine(sims, stats, 0.8)
        got, _ = plain.gate(sims, np.array([m for _, m, _ in stats], np.float32),
                            np.array([s for _, _, s in stats], np.float32))
        assert got == want
