"""Two faults of the port against the reference, repaired: the frontend's
'auto' rule that let a win inside the probe's noise flip the main path's
kernel, and the checkpoint reader's duplicate keys and hard-wired total
cap.  The JAX package keeps its behaviour; the round trips with it are in
tests/test_torch_model.py."""

import io
import json
import zipfile

import numpy as np
import pytest

from streamz_tpu.nn import checkpoint as jckpt
from streamz_tpu_torch.dsp import features
from streamz_tpu_torch.nn import checkpoint as tckpt
from streamz_tpu_torch.nn import model as tmodel
from streamz_tpu_torch.runtime import autotune


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


def _frontend_choice(monkeypatch, runs):
    """autotune_frontend with probes that return ``runs[core]``, the
    seconds of each of the probe's three runs."""
    names = {"mfcc_features_v3": "K2", "mfcc_features_v4": "K1"}

    def fake_time(core, pcm, ns, iters=8):
        return list(runs[names[core.__name__]])

    monkeypatch.setattr(features, "_time_frontend", fake_time)
    return features.autotune_frontend(force=True)


@pytest.mark.parametrize("k1,k2,want", [
    # K2 faster by 2% while K1's runs spread 5%: inside the noise, K1 stays.
    ((1.00, 1.02, 1.05), (0.97, 0.98, 0.99), "pallas_v4"),
    # K2 faster by 10% with a 2% spread: a clear win.
    ((1.00, 1.01, 1.02), (0.89, 0.90, 0.905), "pallas_v3"),
    # A tie: the static default.
    ((1.00, 1.00, 1.00), (1.00, 1.00, 1.00), "pallas_v4"),
    # K1 faster: K1, whatever the spread.
    ((0.90, 0.91, 0.95), (1.00, 1.01, 1.02), "pallas_v4"),
])
def test_frontend_keeps_k1_unless_k2_wins_past_the_spread(fake_card, monkeypatch,
                                                          k1, k2, want):
    """The rule reads the probe's three runs: K2 must be faster than K1 by
    more than the larger relative spread of either candidate's runs.  The
    spread it read is cached with the decision."""
    monkeypatch.setattr(features, "resolve_device", lambda d=None: "cpu")
    got = _frontend_choice(monkeypatch, {"K1": k1, "K2": k2})
    assert got == want
    spread = max((max(r) - min(r)) / sorted(r)[1] for r in (k1, k2))
    entry = json.loads(fake_card.read_text())["frontend:FakeCard"]
    assert entry["choice"] == want
    assert entry["spread"] == pytest.approx(spread, rel=1e-12)
    assert autotune.probe_spread["frontend:FakeCard"] == pytest.approx(spread, rel=1e-12)
    # The probe's time stays the median of its runs.
    assert autotune.probe_times["frontend:FakeCard"] == {
        "pallas_v3": sorted(k2)[1], "pallas_v4": sorted(k1)[1]}


def test_a_default_outside_the_candidates_takes_the_lowest_time(fake_card):
    """Without a candidate to keep, the fastest median wins whatever the
    spread, and the cache entry carries no spread."""
    got = autotune.measured_choice(
        "t_stage", {"a": lambda: [1.0, 1.1, 1.2], "b": lambda: [0.99, 1.0, 1.01]}, "x")
    assert got == "b"
    assert "spread" not in json.loads(fake_card.read_text())["t_stage:FakeCard"]


def test_single_time_probes_have_no_spread(fake_card):
    """A probe that returns one time reads as no spread: the strictly
    faster candidate wins, a tie keeps the default."""
    assert autotune.measured_choice("t_a", {"a": lambda: 1.0, "b": lambda: 0.999}, "a") == "b"
    assert autotune.measured_choice("t_b", {"a": lambda: 1.0, "b": lambda: 1.0}, "a") == "a"
    assert autotune.probe_spread["t_a:FakeCard"] == 0.0


# ---------------------------------------------------------------------------
# The checkpoint reader
# ---------------------------------------------------------------------------


def _npy(a) -> bytes:
    buf = io.BytesIO()
    np.lib.format.write_array(buf, np.asarray(a))
    return buf.getvalue()


def _model_entries():
    rng = np.random.default_rng(3)
    return {
        "w1": rng.normal(size=(5, 6)).astype(np.float32),
        "b1": np.zeros(6, np.float32),
        "w2": rng.normal(size=(6, 4)).astype(np.float32),
        "b2": np.zeros(4, np.float32),
        "sample_rate": np.array([44100], np.int64),
        "bits": np.array([16], np.int64),
        "w3_1": rng.normal(size=4).astype(np.float32),
        "b3_1": np.array([0.5], np.float32),
    }


def _write_zip(path, names_and_arrays):
    with zipfile.ZipFile(path, "w") as zf:
        for name, arr in names_and_arrays:
            zf.writestr(name, _npy(arr))


@pytest.mark.parametrize("first,second", [("w1", "w1.npy"), ("w1.npy", "w1"),
                                          ("b3_1", "b3_1.npy")])
def test_two_entries_with_one_key_raise(tmp_path, first, second):
    """``w1`` and ``w1.npy`` name one key: the port raises before building
    any state, where the JAX package lets the last entry win."""
    entries = _model_entries()
    key = first.removesuffix(".npy")
    other = np.full_like(entries[key], 7.0)
    items = [(k, v) for k, v in entries.items() if k != key]
    items += [(first, entries[key]), (second, other)]
    path = str(tmp_path / "dup.npz")
    _write_zip(path, items)
    with pytest.raises(ValueError, match=f"both name the key '{key}'"):
        tckpt.load(path, device="cpu")
    # The reference reads it, the last entry winning: the departure is on
    # this malformed input only.
    loaded = jckpt.load(path)
    if key == "w1":
        np.testing.assert_array_equal(np.asarray(loaded.params["w1"]), other)


def test_total_cap_has_its_own_variable(tmp_path, monkeypatch):
    """The total decompressed size is capped by
    STREAMZ_CHECKPOINT_MAX_TOTAL_BYTES, default twice the entry cap."""
    path = str(tmp_path / "m.npz")
    net = tmodel.SpeakerNet.new(60, 8, 4, 1, device="cpu")
    tckpt.save(net, path)
    with zipfile.ZipFile(path) as z:
        sizes = [i.file_size for i in z.infolist()]
    total, largest = sum(sizes), max(sizes)
    monkeypatch.delenv("STREAMZ_CHECKPOINT_MAX_ENTRY_BYTES", raising=False)
    monkeypatch.setenv("STREAMZ_CHECKPOINT_MAX_TOTAL_BYTES", str(total - 1))
    with pytest.raises(ValueError, match="STREAMZ_CHECKPOINT_MAX_TOTAL_BYTES"):
        tckpt.load(path, device="cpu")
    monkeypatch.setenv("STREAMZ_CHECKPOINT_MAX_TOTAL_BYTES", str(total))
    assert tckpt.load(path, device="cpu").num_speakers == 1
    # The default: twice the entry cap.
    monkeypatch.delenv("STREAMZ_CHECKPOINT_MAX_TOTAL_BYTES")
    monkeypatch.setenv("STREAMZ_CHECKPOINT_MAX_ENTRY_BYTES", str(largest))
    if total > 2 * largest:
        with pytest.raises(ValueError, match="total cap"):
            tckpt.load(path, device="cpu")
    monkeypatch.setenv("STREAMZ_CHECKPOINT_MAX_ENTRY_BYTES",
                       str(max(largest, -(-total // 2))))
    assert tckpt.load(path, device="cpu").num_speakers == 1
    monkeypatch.setenv("STREAMZ_CHECKPOINT_MAX_TOTAL_BYTES", "lots")
    with pytest.raises(ValueError, match="STREAMZ_CHECKPOINT_MAX_TOTAL_BYTES='lots'"):
        tckpt.load(path, device="cpu")
