"""The port's MLP and checkpoint codec (streamz_tpu_torch.nn) held against the
JAX package on the same numpy-made weights and inputs."""

import os
import zipfile

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from streamz_tpu.nn import checkpoint as jckpt
from streamz_tpu.nn import model as jmodel
from streamz_tpu_torch.nn import checkpoint as tckpt
from streamz_tpu_torch.nn import model as tmodel
from streamz_tpu_torch.nn.convert import params_from_numpy, params_to_numpy

FIX = os.path.join(os.path.dirname(os.path.abspath(__file__)), "fixtures")


def _jax_params_np(seed=3, dims=(60, 32, 16, 5)):
    p = jmodel.init_params(*dims, seed=seed)
    return {k: np.asarray(v) for k, v in p.items()}


@pytest.mark.parametrize("dims,capacity", [((60, 32, 16, 5), None),
                                           ((60, 512, 256, 3), 130)])
def test_init_params_bit_identical(dims, capacity):
    want = jmodel.init_params(*dims, capacity=capacity, seed=11)
    got = tmodel.init_params(*dims, capacity=capacity, seed=11, device="cpu")
    for k in tmodel.PARAM_NAMES:
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]))
    assert tmodel.round_capacity(130) == jmodel.round_capacity(130) == 256


def test_params_from_numpy_round_trip():
    d = _jax_params_np()
    p = params_from_numpy(d, device="cpu")
    assert all(t.dtype == torch.float32 and t.device.type == "cpu" for t in p.values())
    back = params_to_numpy(tmodel.SpeakerMLP(p).params())
    for k in tmodel.PARAM_NAMES:
        np.testing.assert_array_equal(back[k], d[k])
    bad = dict(d, w2=d["w2"][:, :3])
    with pytest.raises(ValueError, match="inconsistent"):
        params_from_numpy(bad, device="cpu")
    with pytest.raises(KeyError):
        params_from_numpy({k: v for k, v in d.items() if k != "b3"}, device="cpu")


@pytest.mark.parametrize("ns", [0, 1, 3, 5])
def test_forward_heads_match_jax(ns):
    """f32 matmuls on the CPU in another order: 1e-5.  Inactive columns are
    exactly 0, also with num_speakers = 0."""
    d = _jax_params_np()
    jp = {k: jnp.asarray(v) for k, v in d.items()}
    tp = params_from_numpy(d, device="cpu")
    x = np.random.default_rng(ns).normal(0, 1, (2, 9, 60)).astype(np.float32)
    xt = torch.from_numpy(x)
    probs = tmodel.forward(tp, xt, ns).numpy()
    np.testing.assert_allclose(probs, np.asarray(jmodel.forward(jp, jnp.asarray(x), ns)),
                               atol=1e-5)
    assert (probs[..., ns:] == 0.0).all()
    np.testing.assert_allclose(
        tmodel.forward_logits(tp, xt, ns).numpy(),
        np.asarray(jmodel.forward_logits(jp, jnp.asarray(x), ns)), atol=1e-5, rtol=1e-6)
    np.testing.assert_allclose(
        tmodel.forward_embedding(tp, xt).numpy(),
        np.asarray(jmodel.forward_embedding(jp, jnp.asarray(x))), atol=1e-5)
    np.testing.assert_allclose(
        tmodel.embed(tp, xt).numpy(), np.asarray(jmodel.embed(jp, jnp.asarray(x))),
        atol=1e-5)
    np.testing.assert_allclose(tmodel.SpeakerMLP(tp)(xt, ns).numpy(), probs)


def test_golden_model_probs():
    net = tckpt.load(os.path.join(FIX, "golden_model.npz"), device="cpu")
    x = np.load(os.path.join(FIX, "golden_model_input.npy"))
    want = np.load(os.path.join(FIX, "golden_model_probs.npy"))
    np.testing.assert_allclose(net.forward(x), want, atol=1e-5, rtol=1e-5)


def test_golden_checkpoint_loads_like_jax():
    path = os.path.join(FIX, "golden_model.npz")
    j = jckpt.load(path)
    t = tckpt.load(path, device="cpu")
    assert t.num_speakers == j.num_speakers == 3
    assert t.file_lists == j.file_lists
    assert (t.sample_rate, t.bits) == (j.sample_rate, j.bits)
    for k in tmodel.PARAM_NAMES:
        np.testing.assert_array_equal(t.params[k].numpy(), np.asarray(j.params[k]))
    assert len(t.embeddings) == len(j.embeddings)
    for (te, tm, ts), (je, jm, js) in zip(t.embeddings, j.embeddings):
        np.testing.assert_array_equal(te, je)
        assert (tm, ts) == (jm, js)
    np.testing.assert_array_equal(t.w4, j.w4)
    np.testing.assert_array_equal(t.b4, j.b4)


def _jax_net(tmp_path):
    net = jmodel.SpeakerNet.new(60, 32, 16, 4, seed=5)
    net.file_lists = [["a.wav"], [], ["c.wav", "d.wav"], ["e.mp3"]]
    rng = np.random.default_rng(1)
    net.set_embeddings([(rng.normal(size=16).astype(np.float32), 0.5 + i / 10, 0.1)
                        for i in range(4)])
    return net


def test_checkpoint_jax_to_port_and_back(tmp_path):
    """A model.npz written by JAX loads in the port; the port's save of it
    loads in JAX with the same parameters and metadata, and the two files
    hold the same entries."""
    jnet = _jax_net(tmp_path)
    p1, p2 = str(tmp_path / "j.npz"), str(tmp_path / "t.npz")
    jckpt.save(jnet, p1)
    tnet = tckpt.load(p1, device="cpu")
    tckpt.save(tnet, p2)
    j2 = jckpt.load(p2)
    for k in tmodel.PARAM_NAMES:
        np.testing.assert_array_equal(np.asarray(j2.params[k]), np.asarray(jckpt.load(p1).params[k]))
        np.testing.assert_array_equal(tnet.params[k].numpy(), np.asarray(j2.params[k]))
    assert j2.file_lists == jnet.file_lists and j2.num_speakers == 4
    for (a, am, as_), (b, bm, bs) in zip(j2.embeddings, jnet.embeddings):
        np.testing.assert_array_equal(a, b)
        assert (am, as_) == (np.float32(bm), np.float32(bs))
    with zipfile.ZipFile(p1) as z1, zipfile.ZipFile(p2) as z2:
        assert sorted(z1.namelist()) == sorted(z2.namelist())
        for name in z1.namelist():
            a = np.load(z1.open(name))
            b = np.load(z2.open(name))
            assert a.dtype == b.dtype and a.shape == b.shape
            np.testing.assert_array_equal(a, b)


def test_checkpoint_port_new_net_loads_in_jax(tmp_path):
    tnet = tmodel.SpeakerNet.new(60, 32, 16, 2, seed=9, device="cpu")
    tnet.file_lists = [["x.wav"], ["y.wav"]]
    path = str(tmp_path / "m.npz")
    tckpt.save(tnet, path)
    jnet = jckpt.load(path)
    w3, b3 = tnet.output_layer()
    jw3, jb3 = jnet.output_layer()
    np.testing.assert_array_equal(w3, jw3)
    np.testing.assert_array_equal(b3, jb3)
    np.testing.assert_array_equal(np.asarray(jnet.params["w1"]), tnet.params["w1"].numpy())
    assert jnet.file_lists == [["x.wav"], ["y.wav"]]


@pytest.mark.parametrize("payload", [
    b"this is not a zip archive",
    b"PK\x03\x04" + b"\x00" * 60,
])
def test_malformed_npz_raises_before_building(tmp_path, payload):
    path = tmp_path / "bad.npz"
    path.write_bytes(payload)
    with pytest.raises(Exception):
        tckpt.load(str(path), device="cpu")


def test_inconsistent_core_shapes_raise(tmp_path):
    path = str(tmp_path / "bad.npz")
    np.savez(path, w1=np.zeros((60, 8), np.float32), b1=np.zeros(7, np.float32),
             w2=np.zeros((8, 4), np.float32), b2=np.zeros(4, np.float32),
             sample_rate=np.array([44100]), bits=np.array([16]))
    with pytest.raises(ValueError, match="inconsistent core"):
        tckpt.load(path, device="cpu")


def test_hostile_num_speakers_and_entry_cap(tmp_path, monkeypatch):
    path = str(tmp_path / "m.npz")
    tnet = tmodel.SpeakerNet.new(60, 8, 4, 1, device="cpu")
    tckpt.save(tnet, path)
    monkeypatch.setenv("STREAMZ_CHECKPOINT_MAX_ENTRY_BYTES", "64")
    with pytest.raises(ValueError, match="cap"):
        tckpt.load(path, device="cpu")
    monkeypatch.delenv("STREAMZ_CHECKPOINT_MAX_ENTRY_BYTES")
    with zipfile.ZipFile(path) as z:
        entries = {n[:-4]: np.load(z.open(n)) for n in z.namelist()}
    entries["num_speakers"] = np.array([2 ** 40], np.int64)
    np.savez(path, **entries)
    with pytest.raises(ValueError, match="sane range"):
        tckpt.load(path, device="cpu")

