"""The port's MLP and checkpoint codec (streamz_tpu_torch.nn) held against the
JAX package on the same numpy-made weights and inputs."""

import contextlib
import io
import os
import warnings
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



# ---------------------------------------------------------------------------
# The reader's one pass: fast entries read as views into the file's bytes,
# every other entry through np.load, the result the JAX package's bit for bit.
# ---------------------------------------------------------------------------


def _npy(a, version=None) -> bytes:
    buf = io.BytesIO()
    np.lib.format.write_array(buf, a, version=version, allow_pickle=True)
    return buf.getvalue()


def _reader_arrays():
    """A small model with three output columns, a stego layer of two bits,
    file lists and stored embeddings, in the writers' dtypes."""
    rng = np.random.default_rng(7)
    f32 = lambda *s: rng.normal(0, 0.5, s).astype(np.float32)  # noqa: E731
    arrays = {"w1": f32(6, 5), "b1": f32(5), "w2": f32(5, 4), "b2": f32(4),
              "sample_rate": np.array([16000], np.int64), "bits": np.array([16], np.int64),
              "num_speakers": np.array([3], np.int64),
              "speaker_embeddings": f32(3, 4), "speaker_mean_sims": f32(3),
              "speaker_std_sims": f32(3)}
    for i in range(3):
        arrays[f"w3_{i + 1}"] = f32(4)
        arrays[f"b3_{i + 1}"] = f32(1)
        arrays[f"speaker_{i}_files"] = np.frombuffer(f"s{i}.wav\nt{i}.wav".encode(), np.uint8)
    for i in range(2):
        arrays[f"w4_{i + 1}"] = f32(4)
        arrays[f"b4_{i + 1}"] = f32(1)
    return arrays


def _write_npz(path, arrays, deflated=(), version=None):
    """Each array as ``<key>.npy``, stored unless its key is in ``deflated``;
    ``version`` maps a key to its ``.npy`` format version."""
    version = version or {}
    with zipfile.ZipFile(path, "w") as zf:
        for key, a in arrays.items():
            kind = zipfile.ZIP_DEFLATED if key in deflated else zipfile.ZIP_STORED
            zf.writestr(key + ".npy", _npy(a, version.get(key)), compress_type=kind)


@pytest.fixture()
def read_spans(monkeypatch):
    """The arguments of each ``load.read`` span the port's reader opens."""
    seen = []

    def span(name, *args):
        seen.append((name, args))
        return contextlib.nullcontext()

    monkeypatch.setattr(tckpt, "span", span)
    return seen


def _assert_loads_like_jax(path):
    j = jckpt.load(path)
    t = tckpt.load(path, device="cpu")
    assert (t.num_speakers, t.file_lists) == (j.num_speakers, j.file_lists)
    assert (t.sample_rate, t.bits) == (j.sample_rate, j.bits)
    for k in tmodel.PARAM_NAMES:
        np.testing.assert_array_equal(t.params[k].numpy(), np.asarray(j.params[k]), err_msg=k)
    assert (t.w4 is None) == (j.w4 is None)
    if t.w4 is not None:
        for a, b in ((t.w4, j.w4), (t.b4, j.b4)):
            assert a.dtype == b.dtype and a.shape == b.shape and a.tobytes() == b.tobytes()
            assert a.flags.writeable and a.flags.aligned and a.flags.c_contiguous
    assert len(t.embeddings) == len(j.embeddings)
    for (te, tm, ts), (je, jm, js) in zip(t.embeddings, j.embeddings):
        np.testing.assert_array_equal(te, je)
        assert te.flags.writeable and te.flags.aligned
        assert (tm, ts) == (jm, js)
    return t


@pytest.mark.parametrize("case,fallback", [
    ("deflated", 1), ("npy_v2", 1), ("fortran_w1", 1), ("big_endian_column", 1),
    ("int32_sample_rate", 0), ("all", 4),
])
def test_reader_mixes_fast_and_fallback_entries_like_jax(tmp_path, read_spans, case,
                                                         fallback):
    """One file of fast entries and, per case, entries np.load decodes: a
    deflated ``w2``, a format-2.0 ``b1``, a Fortran-order ``w1``, a
    big-endian column ``w3_2``; an int32 ``sample_rate`` is read fast."""
    arrays = _reader_arrays()
    deflated, version = set(), {}
    if case in ("deflated", "all"):
        deflated.add("w2")
    if case in ("npy_v2", "all"):
        version["b1"] = (2, 0)
    if case in ("fortran_w1", "all"):
        arrays["w1"] = np.asfortranarray(arrays["w1"])
    if case in ("big_endian_column", "all"):
        arrays["w3_2"] = arrays["w3_2"].astype(">f4")
    if case in ("int32_sample_rate", "all"):
        arrays["sample_rate"] = arrays["sample_rate"].astype(np.int32)
    path = str(tmp_path / "m.npz")
    _write_npz(path, arrays, deflated, version)
    t = _assert_loads_like_jax(path)
    assert read_spans == [("load.read", (len(arrays), fallback))]
    np.testing.assert_array_equal(t.output_layer()[0][:, 1], arrays["w3_2"].astype(np.float32))
    assert t.sample_rate == 16000


def _flip_last_data_byte(data: bytes, payload: bytes) -> bytes:
    at = data.index(payload) + len(payload) - 1
    return data[:at] + bytes([data[at] ^ 0x10]) + data[at + 1:]


def _longer_local_name(data: bytes, name: bytes) -> bytes:
    at = data.index(name) - 30  # the name's first bytes in the file: its local header's
    assert data[at:at + 4] == b"PK\x03\x04"
    n = int.from_bytes(data[at + 26:at + 28], "little")
    return data[:at + 26] + (n + 1).to_bytes(2, "little") + data[at + 28:]


@pytest.mark.parametrize("fault", ["bit_flip_in_w1", "bit_flip_in_a_column", "truncated",
                                   "local_name_length", "local_name_differs",
                                   "short_npy_data", "pickled_entry", "column_widths_differ",
                                   "cap_after_a_bit_flip", "cap_before_a_bit_flip"])
def test_reader_faults_raise_as_jax_before_any_state(tmp_path, monkeypatch, fault):
    """Each malformed file raises the JAX reader's exception, with its
    message, and no parameter is built.  Of two faults, the one in the
    earlier entry raises: a bit flip or an entry over the cap."""
    arrays = _reader_arrays()
    if fault.startswith("cap_"):
        extra = {"extra": np.zeros(10_000, np.float32)}
        arrays = {**extra, **arrays} if fault == "cap_before_a_bit_flip" else {**arrays, **extra}
        monkeypatch.setenv("STREAMZ_CHECKPOINT_MAX_ENTRY_BYTES", "20000")
    if fault == "pickled_entry":
        arrays["speaker_1_files"] = np.array(["s1.wav"], dtype=object)
    if fault == "column_widths_differ":
        arrays["w3_3"] = arrays["w3_3"][:3]
    path = tmp_path / "m.npz"
    _write_npz(str(path), arrays)
    data = path.read_bytes()
    if fault in ("bit_flip_in_w1", "cap_after_a_bit_flip", "cap_before_a_bit_flip"):
        data = _flip_last_data_byte(data, _npy(arrays["w1"]))
    elif fault == "bit_flip_in_a_column":
        data = _flip_last_data_byte(data, _npy(arrays["w3_2"]))
    elif fault == "truncated":
        data = data[:len(data) * 2 // 3]
    elif fault == "local_name_length":
        data = _longer_local_name(data, b"b2.npy")
    elif fault == "local_name_differs":
        data = data.replace(b"b2.npy", b"c2.npy", 1)
    elif fault == "short_npy_data":
        with zipfile.ZipFile(path, "w") as zf:
            for key, a in arrays.items():
                payload = _npy(a)
                zf.writestr(key + ".npy", payload[:-4] if key == "w2" else payload)
        data = path.read_bytes()
    path.write_bytes(data)
    with pytest.raises(Exception) as want:
        jckpt.load(str(path))
    built = []
    monkeypatch.setattr(tckpt, "params_from_numpy", lambda *a, **k: built.append(1))
    with pytest.raises(type(want.value)) as got:
        tckpt.load(str(path), device="cpu")
    assert str(got.value) == str(want.value)
    assert built == []


def test_reader_takes_a_bias_as_float_takes_it(tmp_path, read_spans):
    """A signalling-NaN bias read fast comes out as ``float()`` leaves it
    (quieted), as the JAX reader's, and no warning is raised."""
    arrays = _reader_arrays()
    arrays["b3_2"] = np.array([0x7F800001], np.uint32).view(np.float32)
    arrays["b4_1"] = np.array([0x7F800002], np.uint32).view(np.float32)
    path = str(tmp_path / "m.npz")
    _write_npz(path, arrays)
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        t = _assert_loads_like_jax(path)
    assert read_spans == [("load.read", (len(arrays), 0))]
    want = np.float32(float(arrays["b3_2"][0]))
    assert t.output_layer()[1][1:2].tobytes() == np.array([want]).tobytes()


def test_a_vox1251_schema_model_reads_every_entry_fast(tmp_path, read_spans):
    """A model of 1,251 speakers with empty file lists and stored
    embeddings, saved by the port: 3,763 entries, none through np.load,
    and every array the JAX reader's."""
    n = 1251
    net = tmodel.SpeakerNet.new(60, 512, 256, n, seed=4, device="cpu")
    rng = np.random.default_rng(8)
    net.set_embeddings([(rng.normal(size=256).astype(np.float32), 0.5, 0.1)
                        for _ in range(n)])
    path = str(tmp_path / "model.npz")
    tckpt.save(net, path)
    t = _assert_loads_like_jax(path)
    assert read_spans == [("load.read", (7 + 3 * n + 3, 0))]
    assert t.file_lists == [[]] * n
    for a, b in zip(t.output_layer(), net.output_layer()):
        np.testing.assert_array_equal(a, b)
