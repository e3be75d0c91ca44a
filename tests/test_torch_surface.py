"""The port's public surface and checkpoint reader against the JAX package.

- ``streamz_tpu_torch.__all__`` is the JAX package's, the streaming and
  serving names included; every name resolves to the port's own, and
  ``SimpleNeuralNet`` has the reference's method surface.
- A property test of the ``model.npz`` reader: random files in the Rust
  writer's layout (entries without ``.npy``, stored), with random speaker
  counts and widths, optional ``w4``/``b4`` and embeddings, and the legacy
  monolithic ``w3``, load in both packages to the same parameters and
  metadata and give the same forwards (f32 sums in another order: 1e-5).
"""

import inspect
import io
import zipfile

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import streamz_tpu
import streamz_tpu_torch
from streamz_tpu.nn import checkpoint as jckpt
from streamz_tpu.nn import model as jmodel
from streamz_tpu_torch.nn import checkpoint as tckpt
from streamz_tpu_torch.nn import model as tmodel

# Names of the JAX package's surface the port does not export yet: none
# since the streaming and serving slice.
NOT_YET: set = set()


def test_all_is_the_reference_surface_less_streaming_and_serving():
    assert len(streamz_tpu.__all__) == 63
    assert sorted(streamz_tpu_torch.__all__) == sorted(set(streamz_tpu.__all__) - NOT_YET)
    assert len(streamz_tpu_torch.__all__) == len(set(streamz_tpu_torch.__all__)) == 63


@pytest.mark.parametrize("name", sorted(set(streamz_tpu.__all__) - NOT_YET))
def test_every_name_resolves_to_the_ports_own(name):
    obj = getattr(streamz_tpu_torch, name)
    ref = getattr(streamz_tpu, name)
    if isinstance(ref, (str, int, float, bool)):
        assert obj == ref
    else:
        assert callable(obj)
        assert getattr(obj, "__module__", "").startswith("streamz_tpu_torch")


def test_simple_neural_net_is_speaker_net():
    assert streamz_tpu_torch.SimpleNeuralNet is streamz_tpu_torch.SpeakerNet
    assert streamz_tpu_torch.average_features is streamz_tpu_torch.average_vectors


def test_model_api_surface():
    """The reference's SimpleNeuralNet method surface (src/lib.rs:744-1281),
    as tests/test_public_api.py checks it on the JAX package, and every
    public method of the JAX SpeakerNet."""
    net = streamz_tpu_torch.SimpleNeuralNet.new(
        input_size=4, hidden1=3, hidden2=2, output=2, device="cpu")
    for m in [
        "output_size", "add_output_class", "set_dataset_specs",
        "set_output_layer", "set_encoding_layer", "encoding_layer",
        "output_layer", "record_training_file", "set_embeddings",
        "embedding_size", "forward",
    ]:
        assert hasattr(net, m), m
    ref = [n for n, _ in inspect.getmembers(jmodel.SpeakerNet) if not n.startswith("_")]
    assert [n for n in ref if not hasattr(net, n)] == []


def test_host_one_liners_match_jax(tmp_path):
    from streamz_tpu.io import wav as jwav

    pcm = (np.sin(np.arange(4410) / 7.0) * 9000).astype(np.int16)
    path = str(tmp_path / "a.wav")
    jwav.write_wav(path, pcm)
    t, j = streamz_tpu_torch.load_wav_samples(path), streamz_tpu.load_wav_samples(path)
    np.testing.assert_array_equal(t[0], j[0])
    assert t[1:] == j[1:]
    assert streamz_tpu_torch.audio_metadata(path) == streamz_tpu.audio_metadata(path) == (
        44100, 16)
    vecs = [np.arange(4, dtype=np.float32), np.ones(4, np.float32)]
    np.testing.assert_array_equal(streamz_tpu_torch.average_features(vecs),
                                  streamz_tpu.average_features(vecs))


# ---------------------------------------------------------------------------
# The checkpoint property test.
# ---------------------------------------------------------------------------


def _npy(a) -> bytes:
    buf = io.BytesIO()
    np.lib.format.write_array(buf, np.asarray(a))
    return buf.getvalue()


def _rust_npz(path, seed):
    """A random model.npz as the Rust writer lays it out (NpzWriter: names
    without ``.npy``, stored entries, i64 [1] scalars, per-column w3_{i}).
    Returns a description of what it holds."""
    rng = np.random.default_rng(seed)
    F = int(rng.integers(2, 70))
    H1, H2 = int(rng.integers(1, 40)), int(rng.integers(1, 24))
    S = int(rng.integers(0, 300))
    legacy = bool(rng.integers(0, 2)) and S > 0
    with_ns = bool(rng.integers(0, 2))
    n_bits = int(rng.integers(1, 50)) if rng.integers(0, 2) else 0
    with_emb = bool(rng.integers(0, 2)) and S > 0
    f32 = lambda *s: rng.normal(0, 0.5, s).astype(np.float32)  # noqa: E731
    entries = [("w1", f32(F, H1)), ("b1", f32(H1)), ("w2", f32(H1, H2)), ("b2", f32(H2)),
               ("sample_rate", np.array([int(rng.choice([16000, 44100]))], np.int64)),
               ("bits", np.array([16], np.int64))]
    if with_ns:
        entries.append(("num_speakers", np.array([S], np.int64)))
    if legacy:
        entries += [("w3", f32(H2, S)), ("b3", f32(S))]
    else:
        for i in range(S):
            entries += [(f"w3_{i + 1}", f32(H2)), (f"b3_{i + 1}", f32(1))]
    for i in range(n_bits):
        entries += [(f"w4_{i + 1}", f32(H2)), (f"b4_{i + 1}", f32(1))]
    for i in range(S if rng.integers(0, 2) else 0):
        text = "\n".join(f"clips/s{i}_{j}.mp3" for j in range(int(rng.integers(0, 3))))
        entries.append((f"speaker_{i}_files", np.frombuffer(text.encode(), np.uint8)))
    if with_emb:
        entries += [("speaker_embeddings", f32(S, H2)),
                    ("speaker_mean_sims", f32(S)), ("speaker_std_sims", f32(S))]
    order = rng.permutation(len(entries))
    with zipfile.ZipFile(path, "w", zipfile.ZIP_STORED) as zf:
        for k in order:
            name, arr = entries[k]
            zf.writestr(name, _npy(arr))
    return {"F": F, "S": S, "n_bits": n_bits, "legacy": legacy, "with_emb": with_emb}


@pytest.mark.parametrize("seed", range(24))
def test_random_rust_layout_checkpoints_load_like_jax(tmp_path, seed):
    path = str(tmp_path / "model.npz")
    desc = _rust_npz(path, seed)
    j = jckpt.load(path)
    t = tckpt.load(path, device="cpu")
    assert t.num_speakers == j.num_speakers
    assert t.file_lists == j.file_lists
    assert (t.sample_rate, t.bits) == (j.sample_rate, j.bits)
    for k in tmodel.PARAM_NAMES:
        np.testing.assert_array_equal(t.params[k].numpy(), np.asarray(j.params[k]), err_msg=k)
    assert (t.encoding_layer() is None) == (j.encoding_layer() is None) == (desc["n_bits"] == 0)
    if desc["n_bits"]:
        for a, b in zip(t.encoding_layer(), j.encoding_layer()):
            np.testing.assert_array_equal(a, b)
    assert len(t.embeddings) == len(j.embeddings)
    for (te, tm, ts), (je, jm, js) in zip(t.embeddings, j.embeddings):
        np.testing.assert_array_equal(te, je)
        assert (tm, ts) == (jm, js)
    x = np.random.default_rng(seed + 100).normal(0, 1, (5, desc["F"])).astype(np.float32)
    np.testing.assert_allclose(t.forward(x), j.forward(x), atol=1e-5)
    np.testing.assert_allclose(t.forward_bits(x), j.forward_bits(x), atol=1e-5)
    np.testing.assert_allclose(
        tmodel.forward_bits(t.params, torch.from_numpy(x)).numpy(),
        np.asarray(jmodel.forward_bits(j.params, jnp.asarray(x))), atol=1e-5)


@pytest.mark.parametrize("seed", range(4))
def test_random_checkpoints_with_a_duplicate_key_are_refused(tmp_path, seed):
    """The same files with one entry repeated under its ``.npy`` name: the
    JAX reader takes the last one, the port refuses the file."""
    path = str(tmp_path / "model.npz")
    _rust_npz(path, seed)
    with zipfile.ZipFile(path) as zf:
        names = zf.namelist()
        name = names[seed % len(names)]
        payload = zf.read(name)
    with zipfile.ZipFile(path, "a", zipfile.ZIP_STORED) as zf:
        zf.writestr(name + ".npy", payload)
    jckpt.load(path)
    with pytest.raises(ValueError, match="both name the key"):
        tckpt.load(path, device="cpu")


def test_random_checkpoint_past_the_total_cap_is_refused(tmp_path, monkeypatch):
    path = str(tmp_path / "model.npz")
    _rust_npz(path, 5)
    with zipfile.ZipFile(path) as zf:
        total = sum(i.file_size for i in zf.infolist())
    monkeypatch.setenv("STREAMZ_CHECKPOINT_MAX_TOTAL_BYTES", str(total - 1))
    with pytest.raises(ValueError, match="total cap"):
        tckpt.load(path, device="cpu")
    jckpt.load(path)  # the reference has no such variable
