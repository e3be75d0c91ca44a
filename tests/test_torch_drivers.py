"""The model and training leftovers of the port against the JAX package, on
the CPU: the threefry twin's ``uniform(minval, maxval)`` and ``augment`` bit
for bit, the steganography head and steps of the MLP, and the raw-PCM
drivers ``pretrain_network`` and ``train_from_files``.

Tolerances: the single steps (``forward_bits``, ``train_bits_step``,
``train``, ``train_batch``) are f32 sums in another order, 1e-5 as in
tests/test_torch_model.py.  The drivers chain the frontend (the port's
'plain' against JAX's 'jax', 1e-5 apart on features) and a few dozen SGD
steps at 60 -> 32 -> 16: 1e-4 on parameters and losses, as the per-file
trainer's comparison in tests/test_torch_train.py.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from streamz_tpu.dsp.augment import augment as jaugment
from streamz_tpu.dsp.features import FeatureExtractor as JExtractor
from streamz_tpu.io import wav as jwav
from streamz_tpu.nn import drivers as jdrivers
from streamz_tpu.nn import model as jmodel
from streamz_tpu.nn import train as jtrain
from streamz_tpu_torch.dsp.augment import augment as taugment
from streamz_tpu_torch.dsp.features import FeatureExtractor as TExtractor
from streamz_tpu_torch.nn import drivers as tdrivers
from streamz_tpu_torch.nn import model as tmodel
from streamz_tpu_torch.nn import prng
from streamz_tpu_torch.nn import train as ttrain
from streamz_tpu_torch.nn.convert import params_from_numpy, params_to_numpy


def _bits(a):
    return np.asarray(a, np.float32).view(np.uint32)


def _tparams(jparams):
    return {k: v.contiguous() for k, v in params_from_numpy(
        {k: np.asarray(v) for k, v in jparams.items()}, device="cpu").items()}


def _max_err(jparams, tparams):
    t = params_to_numpy(tparams)
    return max(float(np.abs(np.asarray(jparams[k]) - t[k]).max()) for k in tmodel.PARAM_NAMES)


# ---------------------------------------------------------------------------
# The threefry twin's scaled uniform and augment: bit for bit.
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("seed", [0, 3, 123456789])
@pytest.mark.parametrize("lo,hi", [(0.95, 1.05), (-1.0, 1.0), (0.0, 0.005), (-3.25, 0.7)])
@pytest.mark.parametrize("shape", [(7,), (4, 1), (64, 300)])
def test_uniform_minval_maxval_bit_for_bit(seed, lo, hi, shape):
    want = jax.random.uniform(jax.random.PRNGKey(seed), shape, minval=lo, maxval=hi)
    got = prng.uniform(prng.PRNGKey(seed), shape, lo, hi)
    assert got.dtype == torch.float32 and tuple(got.shape) == shape
    np.testing.assert_array_equal(_bits(got.numpy()), _bits(want))


def test_uniform_default_form_unchanged():
    """The default [0, 1) form is the raw mantissa draw, with or without
    explicit bounds."""
    key = prng.PRNGKey(11)
    a = prng.uniform(key, (5, 9))
    b = prng.uniform(key, (5, 9), 0.0, 1.0)
    assert torch.equal(a, b)
    np.testing.assert_array_equal(
        _bits(a.numpy()), _bits(jax.random.uniform(jax.random.PRNGKey(11), (5, 9))))


def _pcm(shape, seed=0):
    return np.random.default_rng(seed).integers(-32768, 32768, shape).astype(np.float32)


@pytest.mark.parametrize("seed", [0, 3])
@pytest.mark.parametrize("n_samples", [None, [44100, 500, 0], 600])
def test_augment_bit_for_bit(seed, n_samples):
    """[3, 44100] i16-range PCM; valid lengths including a clip shorter than
    the 800-sample shift bound and a zero-length clip."""
    pcm = _pcm((3, 44100), seed)
    want = jaugment(jax.random.PRNGKey(seed), jnp.asarray(pcm), n_samples)
    got = taugment(prng.PRNGKey(seed), torch.from_numpy(pcm), n_samples)
    assert got.shape == (3, 44100) and got.dtype == torch.float32
    np.testing.assert_array_equal(_bits(got.numpy()), _bits(want))


def test_augment_one_clip_and_int16_input():
    pcm = _pcm((44100,), 5).astype(np.int16)
    want = jaugment(jax.random.PRNGKey(9), jnp.asarray(pcm))
    got = taugment(prng.PRNGKey(9), pcm)
    assert got.shape == (44100,)
    np.testing.assert_array_equal(_bits(got.numpy()), _bits(want))
    # Integer-valued, within the i16 range, and not the input.
    v = got.numpy()
    assert (v == np.trunc(v)).all() and v.min() >= -32768 and v.max() <= 32767
    assert not np.array_equal(v, pcm)


# ---------------------------------------------------------------------------
# The MLP's stego head and in-place steps.
# ---------------------------------------------------------------------------


def _nets(seed=4, dims=(60, 32, 16, 5)):
    j = jmodel.SpeakerNet.new(*dims, seed=seed)
    t = tmodel.SpeakerNet.new(*dims, seed=seed, device="cpu")
    for k in tmodel.PARAM_NAMES:
        np.testing.assert_array_equal(t.params[k].numpy(), np.asarray(j.params[k]))
    return j, t


def test_forward_bits_and_host_heads_match_jax():
    jnet, tnet = _nets()
    x = np.random.default_rng(1).normal(0, 1, (3, 60)).astype(np.float32)
    np.testing.assert_allclose(
        tmodel.forward_bits(tnet.params, torch.from_numpy(x)).numpy(),
        np.asarray(jmodel.forward_bits(jnet.params, jnp.asarray(x))), atol=1e-5)
    got = tnet.forward_bits(x)
    assert got.shape == (3, 5)  # sliced to num_speakers, not the capacity
    np.testing.assert_allclose(got, jnet.forward_bits(x), atol=1e-5)
    np.testing.assert_allclose(tnet.embed_np(x), jnet.embed_np(x), atol=1e-5)
    np.testing.assert_allclose(tnet.embed_host(x), jnet.embed_host(x), atol=1e-5)
    np.testing.assert_allclose(tnet.forward_embedding_np(x), jnet.forward_embedding_np(x),
                               atol=1e-5)


@pytest.mark.parametrize("n_live", [3, 70, 128])
def test_train_bits_step_matches_jax(n_live):
    """The whole trunk moves; columns at or past n_live do not."""
    jnet, _ = _nets(dims=(60, 32, 16, 128))
    rng = np.random.default_rng(n_live)
    x = rng.integers(0, 2, 60).astype(np.float32)
    target = np.zeros(128, np.float32)
    target[:n_live] = rng.integers(0, 2, n_live)
    want = jtrain.train_bits_step(jnet.params, jnp.asarray(x), jnp.asarray(target),
                                  jnp.float32(0.5), jnp.int32(n_live))
    before = _tparams(jnet.params)
    got = ttrain.train_bits_step(_tparams(jnet.params), torch.from_numpy(x),
                                 torch.from_numpy(target), 0.5, n_live)
    assert _max_err(want, got) <= 1e-5
    assert torch.equal(got["w3"][:, n_live:], before["w3"][:, n_live:])
    assert torch.equal(got["b3"][n_live:], before["b3"][n_live:])
    assert not torch.equal(got["w1"], before["w1"])


def test_speaker_net_steps_match_jax():
    """``train``, ``train_batch`` and ``train_bits`` with a target shorter
    than the capacity, one after the other on both packages' nets."""
    jnet, tnet = _nets(seed=6)
    rng = np.random.default_rng(2)
    x = rng.normal(0, 1, 60).astype(np.float32)
    batch = rng.normal(0, 1, (6, 60)).astype(np.float32)
    onehot = np.eye(5, dtype=np.float32)[2]
    bits = rng.integers(0, 2, 4).astype(np.float32)
    for net in (jnet, tnet):
        net.train(x, onehot, 0.05)
    assert _max_err(jnet.params, tnet.params) <= 1e-5
    for net in (jnet, tnet):
        net.train_batch(batch, onehot, 0.05)
        net.train_batch(np.zeros((0, 60), np.float32), onehot, 0.05)  # no-op
    assert _max_err(jnet.params, tnet.params) <= 1e-5
    before = tnet.params["w3"].clone()
    for net in (jnet, tnet):
        net.train_bits(x, bits, 0.5)
    assert _max_err(jnet.params, tnet.params) <= 1e-5
    assert torch.equal(tnet.params["w3"][:, 4:], before[:, 4:])


def test_encoding_layer_and_save_load(tmp_path):
    _, tnet = _nets()
    assert tnet.encoding_layer() is None
    w4 = np.arange(32, dtype=np.float64).reshape(16, 2)
    tnet.set_encoding_layer(w4, [0.5, -0.5])
    w, b = tnet.encoding_layer()
    assert w.dtype == b.dtype == np.float32 and w.shape == (16, 2)
    path = str(tmp_path / "m.npz")
    tnet.save(path)
    back = tmodel.SpeakerNet.load(path, device="cpu")
    np.testing.assert_array_equal(back.encoding_layer()[0], w)
    np.testing.assert_array_equal(back.encoding_layer()[1], b)
    np.testing.assert_array_equal(back.params["w1"].numpy(), tnet.params["w1"].numpy())


# ---------------------------------------------------------------------------
# The raw-PCM drivers.
# ---------------------------------------------------------------------------


def _voice(rng, f0, seconds):
    t = np.arange(int(44100 * seconds)) / 44100.0
    x = sum(np.sin(2 * np.pi * f0 * h * t) / h for h in range(1, 5))
    x = x + rng.normal(0, 0.05, t.shape)
    return np.clip(x / np.abs(x).max() * 12000, -32768, 32767).astype(np.int16)


@pytest.mark.parametrize("jbackend,tbackend", [("jax", "plain"), ("numpy", "numpy")])
def test_pretrain_network_matches_jax(jbackend, tbackend):
    """Two epochs of augment + frontend + one epoch of the per-file trainer,
    keys from ``fold_in`` and ``split`` as in the JAX package; through the
    plain frontend and the host golden spec."""
    rng = np.random.default_rng(3)
    pcm = _voice(rng, 150.0, 0.4)
    jnet, tnet = _nets(seed=8, dims=(60, 32, 16, 2))
    jl = jdrivers.pretrain_network(jnet, pcm, 1, 2, 2, 0.05, 0.2, 8, JExtractor(jbackend),
                                   key=jax.random.PRNGKey(5))
    tl = tdrivers.pretrain_network(tnet, pcm, 1, 2, 2, 0.05, 0.2, 8,
                                   TExtractor(tbackend, device="cpu"), key=prng.PRNGKey(5))
    assert abs(tl - jl) <= 1e-4 and tl > 0
    assert _max_err(jnet.params, tnet.params) <= 1e-4
    # A clip too short for a window trains nothing and reports 0.
    short = pcm[:500]
    assert tdrivers.pretrain_network(tnet, short, 1, 2, 2, 0.05, 0.2, 8,
                                     TExtractor("plain", device="cpu"),
                                     key=prng.PRNGKey(1)) == 0.0


def test_train_from_files_matches_jax(tmp_path, monkeypatch):
    """Three short WAV clips (and one missing file, skipped), 2 epochs: the
    same lr decay ``lr * 0.99**step`` and the same keys per (file, epoch),
    the same provenance lists, parameters within 1e-4."""
    rng = np.random.default_rng(4)
    files = []
    for i, f0 in enumerate((120.0, 210.0, 330.0)):
        path = str(tmp_path / f"c{i}.wav")
        jwav.write_wav(path, _voice(rng, f0, 0.3 + 0.1 * i))
        files.append((path, i % 2))
    files.insert(1, (str(tmp_path / "missing.wav"), 0))
    jnet, tnet = _nets(seed=9, dims=(60, 32, 16, 2))

    calls = {"jax": [], "torch": []}
    real = {"jax": jdrivers.pretrain_network, "torch": tdrivers.pretrain_network}

    def spy(pkg):
        def call(net, samples, cls, ns, epochs, lr, *a, key=None, **k):
            calls[pkg].append((cls, ns, epochs, lr, np.asarray(key).tolist()))
            return real[pkg](net, samples, cls, ns, epochs, lr, *a, key=key, **k)
        return call

    monkeypatch.setattr(jdrivers, "pretrain_network", spy("jax"))
    monkeypatch.setattr(tdrivers, "pretrain_network", spy("torch"))
    assert jdrivers.train_from_files(jnet, files, 2, 2, 0.05, 0.2, 8, JExtractor("jax"),
                                     key=jax.random.PRNGKey(7)) is None
    mean = tdrivers.train_from_files(tnet, files, 2, 2, 0.05, 0.2, 8,
                                     TExtractor("plain", device="cpu"), key=prng.PRNGKey(7))
    assert calls["torch"] == calls["jax"] and len(calls["jax"]) == 6
    assert [c[3] for c in calls["torch"]] == [0.05 * 0.99 ** s for s in range(6)]
    assert tnet.file_lists == jnet.file_lists
    assert tnet.file_lists == [[files[0][0], files[3][0]], [files[2][0]]]
    assert (tnet.sample_rate, tnet.bits) == (jnet.sample_rate, jnet.bits)
    assert _max_err(jnet.params, tnet.params) <= 1e-4
    assert mean > 0


def test_default_extractor_follows_the_net(monkeypatch):
    """Without an extractor the drivers run the frontend on the net's
    device ('auto' is the plain formulation on the CPU)."""
    seen = []
    real = TExtractor.extract_device

    def spy(self, pcm):
        seen.append((self.device.type, self.resolved()))
        return real(self, pcm)

    monkeypatch.setattr(TExtractor, "extract_device", spy)
    _, tnet = _nets(dims=(60, 32, 16, 2))
    pcm = _voice(np.random.default_rng(0), 200.0, 0.2)
    tdrivers.pretrain_network(tnet, pcm, 0, 2, 1, 0.05, 0.2, 8, key=prng.PRNGKey(0))
    assert seen == [("cpu", "plain")]


@pytest.mark.parametrize("n", [50, 128, 256])
def test_set_output_layer_matches_jax(n):
    """The live columns replaced, the padding re-drawn from the growth seed
    as the JAX package draws it (none to draw when n fills the capacity),
    then growth continues from the same seed."""
    jnet, tnet = _nets(seed=3, dims=(60, 32, 16, 5))
    rng = np.random.default_rng(n)
    w3 = rng.normal(size=(16, n)).astype(np.float32)
    b3 = rng.normal(size=n).astype(np.float32)
    for net in (jnet, tnet):
        net.set_output_layer(w3, b3)
        net.add_output_class()
        net.ensure_capacity(net.capacity + 1)
    assert tnet.num_speakers == jnet.num_speakers == n + 1
    for k in tmodel.PARAM_NAMES:
        np.testing.assert_array_equal(tnet.params[k].numpy(), np.asarray(jnet.params[k]))
