"""The port's steganography codec and CLI modes against the JAX package, on
the CPU.  The host helpers are exact copies (the same bits); the encode loop
runs in blocks on the device, and either package decodes the other's
encoding to the same bytes, after the same number of steps."""

import contextlib
import hashlib
import io
import re
import shutil

import numpy as np
import pytest
import torch

from streamz_tpu import cli as jcli
from streamz_tpu import config as jconfig
from streamz_tpu.io import wav as jwav
from streamz_tpu.nn import checkpoint as jckpt
from streamz_tpu.nn import drivers as jdrivers
from streamz_tpu.stego import codec as jcodec
from streamz_tpu_torch import cli as tcli
from streamz_tpu_torch import config as tconfig
from streamz_tpu_torch.io import audio as taudio
from streamz_tpu_torch.nn import checkpoint as tckpt
from streamz_tpu_torch.nn import drivers as tdrivers
from streamz_tpu_torch.stego import codec as tcodec

OTHER_KEY = "ab" * 64


@pytest.fixture(autouse=True)
def fresh_checksum():
    """Both packages' checksum override is process-global: every test starts
    and ends on the built-in constant."""
    for cfg in (jconfig, tconfig):
        cfg.set_checksum_constant_override(None)
    yield
    for cfg in (jconfig, tconfig):
        cfg.set_checksum_constant_override(None)


def _override(value):
    for cfg in (jconfig, tconfig):
        cfg.set_checksum_constant_override(value)


# ---------------------------------------------------------------------------
# Host helpers: exact.
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("text", ["00ff10", "zzff", "", "0f f0 1", " f0f\t0aB",
                                  "4273195488fa01ce67", "a"])
def test_hex_to_bytes_matches_jax(text):
    assert tcodec.hex_to_bytes(text) == jcodec.hex_to_bytes(text)
    assert tcodec.hex_to_bytes(" f0f") == b"\x0f"  # whitespace pairs are skipped


def test_bit_packing_matches_jax():
    data = bytes(range(256)) + b"\x80\x01"
    bits = tcodec.bytes_to_bits(data)
    np.testing.assert_array_equal(bits, jcodec.bytes_to_bits(data))
    assert tcodec.bits_to_bytes(bits) == data
    odd = bits[:13]
    assert tcodec.bits_to_bytes(odd) == jcodec.bits_to_bytes(odd)


@pytest.mark.parametrize("key", [None, OTHER_KEY, "0f f0 zz" * 20])
def test_keyed_draws_match_jax(key):
    """The input bits, the seed, the keystream and the hidden activation h2
    under the built-in constant and under overrides."""
    _override(key)
    np.testing.assert_array_equal(tcodec.checksum_input_bits(), jcodec.checksum_input_bits())
    assert tcodec._seed_from_checksum() == jcodec._seed_from_checksum()
    np.testing.assert_array_equal(tcodec._keystream(1001), jcodec._keystream(1001))
    bits = tcodec.checksum_input_bits()
    np.testing.assert_array_equal(tcodec._hidden_activation(bits),
                                  jcodec._hidden_activation(bits))
    np.testing.assert_array_equal(tcodec._hidden_activation(bits, hidden2=64),
                                  jcodec._hidden_activation(bits, hidden2=64))


# ---------------------------------------------------------------------------
# Encode in one package, decode in the other.
# ---------------------------------------------------------------------------


def _encode(codec, path, **kw):
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        net = codec.encode_file(str(path), **kw)
    steps = int(re.search(r"\((\d+) steps\)", out.getvalue()).group(1))
    return net, steps


PAYLOADS = {
    "short": b"StreamZ hidden payload \x00\x01\xfe!",
    "4KiB": np.random.default_rng(4096).bytes(4096),
}


@pytest.mark.parametrize("name", sorted(PAYLOADS))
def test_encode_in_one_package_decode_in_the_other(tmp_path, name):
    payload = PAYLOADS[name]
    src = tmp_path / "secret.bin"
    src.write_bytes(payload)
    tnet, tsteps = _encode(tcodec, src, device="cpu")
    jnet, jsteps = _encode(jcodec, src)
    assert tsteps == jsteps
    n = len(payload)
    # The port's encoding, decoded by both packages; the JAX one's by the port.
    assert jcodec.extract_file(*tnet.encoding_layer())[:n] == payload
    assert tcodec.extract_file_from_classifier(tnet)[:n] == payload
    assert tcodec.extract_file(tnet)[:n] == payload  # its live output layer
    assert tcodec.extract_file(*jnet.encoding_layer())[:n] == payload
    w4, b4 = tnet.encoding_layer()
    assert w4.shape == (256, 8 * n) and b4.shape == (8 * n,)
    assert tnet.num_speakers == 8 * n and tnet.input_size() == 512
    np.testing.assert_allclose(w4, jnet.encoding_layer()[0], atol=1e-5)


def test_no_epochs_raises_runtime_error(tmp_path):
    src = tmp_path / "s.bin"
    src.write_bytes(b"abc")
    for codec, kw in ((tcodec, {"device": "cpu"}), (jcodec, {})):
        with pytest.raises(RuntimeError, match="did not converge within 0 epochs"):
            codec.encode_file(str(src), max_epochs=0, **kw)


def test_oversized_payload_refused_with_the_same_text(tmp_path):
    src = tmp_path / "huge.bin"
    with open(src, "wb") as f:
        f.truncate(tconfig.STEGO_MAX_PAYLOAD_BYTES + 1)
    assert tconfig.STEGO_MAX_PAYLOAD_BYTES == jconfig.STEGO_MAX_PAYLOAD_BYTES == 128 * 1024
    with pytest.raises(ValueError) as got:
        tcodec.encode_file(str(src), device="cpu")
    with pytest.raises(ValueError) as want:
        jcodec.encode_file(str(src))
    # The same message, naming each package's own config module and its own
    # peak device memory per payload byte (w3 and its update on the card).
    assert str(got.value) == str(want.value).replace(
        "streamz_tpu.config", "streamz_tpu_torch.config").replace("~24 KB", "~16 KB")
    assert "capped at 131072 bytes" in str(got.value)


def test_another_checksum_decodes_to_noise(tmp_path):
    payload = np.random.default_rng(1).bytes(512)
    src = tmp_path / "s.bin"
    src.write_bytes(payload)
    net, _ = _encode(tcodec, src, device="cpu")
    assert tcodec.extract_file_from_classifier(net) == payload
    _override(OTHER_KEY)
    noise = tcodec.extract_file_from_classifier(net)
    assert len(noise) == len(payload)
    flipped = np.unpackbits(np.frombuffer(bytes(a ^ b for a, b in zip(noise, payload)),
                                          np.uint8)).mean()
    assert 0.4 < flipped < 0.6  # about half the bits: noise


# ---------------------------------------------------------------------------
# The block loop equals a loop that stops at the first satisfied step.
# ---------------------------------------------------------------------------


def _one_step_loop(w3, b3, h2, target, n_bits, lr, max_epochs):
    """The JAX package's while_loop, one step at a time on the host."""
    def match(out):
        ok = torch.where(target > 0.5, out > 0.52, out < 0.48)
        return bool(torch.all(ok | (torch.arange(len(out)) >= n_bits)))

    out = torch.sigmoid(h2 @ w3 + b3)
    done, step = match(out), 0
    while not done and step < max_epochs:
        delta = (out - target) * out * (1.0 - out)
        upd = torch.outer(h2, delta)
        upd.mul_(lr)
        w3 = w3 - upd
        b3 = b3 - lr * delta
        step += 1
        out = torch.sigmoid(h2 @ w3 + b3)
        done = match(out)
    return w3, b3, step, done


def _slow_problem(seed=0, n_bits=200, cap=256):
    """A target that needs a few dozen steps at a small learning rate."""
    rng = np.random.default_rng(seed)
    h2 = torch.from_numpy(np.tanh(rng.normal(0, 1, 64)).astype(np.float32))
    w3 = torch.from_numpy(rng.uniform(-0.05, 0.05, (64, cap)).astype(np.float32))
    target = np.zeros(cap, np.float32)
    target[:n_bits] = rng.integers(0, 2, n_bits)
    return w3, torch.zeros(cap), h2, torch.from_numpy(target), n_bits


def _block_ends(max_block, limit):
    ends, total, block = [], 0, 1
    while total < limit:
        total += block
        ends.append(total)
        block = min(2 * block, max_block)
    return ends


@pytest.mark.parametrize("max_block", [1, 5, 256])
@pytest.mark.parametrize("max_epochs", [10_000, 11, 3])
def test_block_loop_equals_the_step_loop(max_block, max_epochs):
    """The same weights, bit for bit, and the same step count as stopping at
    the first step that satisfied the predicate: also where that step falls
    inside a block (the steps after it run masked) and where max_epochs
    cuts the last block."""
    w3, b3, h2, target, n_bits = _slow_problem()
    lr = 0.002
    want_w3, want_b3, want_steps, want_done = _one_step_loop(
        w3.clone(), b3.clone(), h2, target, n_bits, lr, max_epochs)
    if max_epochs == 10_000:
        assert want_done and want_steps == 79
        if max_block > 1:  # done inside a block: masked steps ran after it
            assert want_steps not in _block_ends(max_block, want_steps)
    else:
        assert not want_done and want_steps == max_epochs
    got_w3, got_b3 = w3.clone(), b3.clone()
    steps, done = tcodec._train_bits_loop(got_w3, got_b3, h2, target, n_bits, lr,
                                          max_epochs=max_epochs, max_block=max_block)
    assert (steps, done) == (want_steps, want_done)
    assert torch.equal(got_w3, want_w3) and torch.equal(got_b3, want_b3)


# ---------------------------------------------------------------------------
# The CLI: --encode / --decode / --checksum beside the JAX CLI.
# ---------------------------------------------------------------------------


def _voice(rng, f0, seconds=0.6):
    t = np.arange(int(44100 * seconds)) / 44100.0
    x = sum(np.sin(2 * np.pi * f0 * h * t + rng.uniform(0, 6.3)) / h for h in range(1, 6))
    x = x + rng.normal(0, 0.05, t.shape)
    return np.clip(x / np.abs(x).max() * 12000, -32768, 32767).astype(np.int16)


BLOB = np.random.default_rng(77).bytes(3000)  # the trigger "MP3": never decoded
SHA = hashlib.sha512(BLOB).hexdigest()
SECRET = np.random.default_rng(78).bytes(300)


@pytest.fixture(scope="module")
def stego_dir(tmp_path_factory):
    """Four clips, three labelled, plus clips/blob.mp3 (arbitrary bytes)
    whose cache/blob.wav is a real clip, and the payload secret.bin."""
    root = tmp_path_factory.mktemp("stego")
    rng = np.random.default_rng(9)
    (root / "clips").mkdir()
    (root / "cache").mkdir()
    lines = []
    for i, f0 in enumerate((110.0, 190.0, 300.0, 150.0)):
        jwav.write_wav(str(root / f"c{i}.wav"), _voice(rng, f0))
        lines.append(f"c{i}.wav,{i % 3}" if i < 3 else f"c{i}.wav")
    (root / "clips" / "blob.mp3").write_bytes(BLOB)
    jwav.write_wav(str(root / "cache" / "blob.wav"), _voice(rng, 240.0))
    lines.insert(2, "clips/blob.mp3,1")
    (root / "train_files.txt").write_text("\n".join(lines) + "\n")
    (root / "secret.bin").write_bytes(SECRET)
    return root


def _cli(monkeypatch, capsys, work, package, args):
    monkeypatch.chdir(work)
    monkeypatch.setenv("STREAMZ_TPU_MESH", "0")  # one device, as the port
    monkeypatch.setattr(jdrivers, "_key_counter", [0])
    monkeypatch.setattr(tdrivers, "_key_counter", [0])
    report = {}
    if package == "jax":
        rc = jcli.main(args)
    else:
        rc = tcli.main(args + ["--device", "cpu"], report=report)
    out = capsys.readouterr()
    return rc, out.out, out.err, report


def _fresh(tmp_path, stego_dir, package):
    work = tmp_path / package
    shutil.copytree(stego_dir, work)
    return work


def test_cli_encode_then_decode_beside_jax(monkeypatch, capsys, tmp_path, stego_dir):
    runs = {}
    for package in ("jax", "torch"):
        work = _fresh(tmp_path, stego_dir, package)
        enc = _cli(monkeypatch, capsys, work, package,
                   ["--encode", "secret.bin", "--checksum", SHA, "--burn-in-limit", "2"])
        dec = _cli(monkeypatch, capsys, work, package,
                   ["--decode", "out.bin", "--checksum", SHA])
        runs[package] = (work, enc, dec)
    (jwork, jenc, jdec), (twork, tenc, tdec) = runs["jax"], runs["torch"]
    assert tenc[0] == jenc[0] == 0 and tdec[0] == jdec[0] == 0
    hiding = [[ln for ln in r[1].splitlines() if ln.startswith(("Hiding", "Finished enc"))]
              for r in (jenc, tenc)]
    assert hiding[0] == hiding[1] == ["Hiding secret.bin in neural network",
                                      "Finished encoding secret.bin (1 steps)"]
    assert "stego" in tenc[3]["phase_seconds"]
    decoded = [[ln for ln in r[1].splitlines() if ln.startswith("Decoded")]
               for r in (jdec, tdec)]
    assert decoded[0] == decoded[1] == [f"Decoded {len(SECRET)} bytes"]
    for work in (jwork, twork):
        assert (work / "out.bin").read_bytes() == SECRET
    # train_files.txt is written back with the list's own paths in both.
    assert (twork / "train_files.txt").read_text() == (jwork / "train_files.txt").read_text()
    assert "clips/blob.mp3" in (twork / "train_files.txt").read_text()
    # The port's model.npz carries w4_*/b4_*; the JAX reader takes them back
    # and both packages decode the payload from it.
    with np.load(twork / "model.npz") as z:
        names = set(z.files)
    assert {"w4_1", "b4_1", f"w4_{8 * len(SECRET)}"} <= names
    jnet = jckpt.load(str(twork / "model.npz"))
    assert jcodec.extract_file_from_classifier(jnet) == SECRET
    _override(SHA)
    tnet = tckpt.load(str(jwork / "model.npz"), device="cpu")
    assert tcodec.extract_file_from_classifier(tnet) == SECRET


def test_cli_checksum_matching_no_clip_trains_without_hiding(monkeypatch, capsys,
                                                             tmp_path, stego_dir):
    work = _fresh(tmp_path, stego_dir, "torch")
    rc, out, err, report = _cli(monkeypatch, capsys, work, "torch",
                                ["--encode", "secret.bin", "--checksum", OTHER_KEY,
                                 "--burn-in-limit", "2"])
    assert rc == 0 and "Hiding" not in out and "Number of speakers" in out
    assert "stego" not in report["phase_seconds"]
    assert not taudio.CHECKSUM_TRIGGERED.is_set()
    with np.load(work / "model.npz") as z:
        assert not any(n.startswith("w4_") for n in z.files)


def test_cli_encode_failure_is_reported_and_training_goes_on(monkeypatch, capsys,
                                                             tmp_path, stego_dir):
    work = _fresh(tmp_path, stego_dir, "torch")
    rc, out, err, _ = _cli(monkeypatch, capsys, work, "torch",
                           ["--encode", "absent.bin", "--checksum", SHA,
                            "--burn-in-limit", "2"])
    assert rc == 0 and "Hiding absent.bin in neural network" in out
    assert "Encoding failed:" in err and "Number of speakers" in out


def test_cli_decode_without_a_model_fails(monkeypatch, capsys, tmp_path):
    for package in ("jax", "torch"):
        work = tmp_path / package
        work.mkdir()
        rc, out, err, _ = _cli(monkeypatch, capsys, work, package, ["--decode", "o.bin"])
        assert rc == 1 and "Failed to load model" in err
