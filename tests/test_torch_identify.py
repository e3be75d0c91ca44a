"""The --identify slice end to end: the port (on the CPU) against the JAX CLI.

Both packages read the same ``model.npz`` (a small 60→32→16 net with three
speakers, written by the JAX package) and the same seeded synthetic WAV
clips, one of them at 16 kHz so that the resampler is on the path.  The
verdict lines must be the same and the similarities agree within 1e-4; the
data is seeded so that every similarity stays more than 1e-3 away from the
gate's boundaries, so a 1e-5 feature difference cannot flip a verdict.
"""

import os

import jax.numpy as jnp
import numpy as np
import pytest

from streamz_tpu import cli as jcli
from streamz_tpu.dsp import mfcc as jmfcc
from streamz_tpu.infer import embed as jembed
from streamz_tpu.infer import identify as jidentify
from streamz_tpu.io import wav as jwav
from streamz_tpu.nn import checkpoint as jckpt
from streamz_tpu.nn import model as jmodel
from streamz_tpu_torch import cli as tcli
from streamz_tpu_torch.dsp.features import FeatureExtractor
from streamz_tpu_torch.infer import embed as tembed
from streamz_tpu_torch.infer import identify as tidentify
from streamz_tpu_torch.nn import checkpoint as tckpt

SPEAKERS = [(110.0, 0.55), (190.0, 0.8), (300.0, 0.35)]  # (f0, harmonic decay)


def _voice(rng, f0, decay, seconds, rate=44100):
    t = np.arange(int(seconds * rate)) / rate
    x = sum(decay ** h * np.sin(2 * np.pi * f0 * (h + 1) * t + rng.uniform(0, 6.3))
            for h in range(12))
    x = x * (1 + 0.3 * np.sin(2 * np.pi * 3 * t)) + rng.normal(0, 0.05, t.shape)
    return np.clip(x / np.abs(x).max() * 12000, -32768, 32767).astype(np.int16)


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    """Enrolment and query clips on disk plus the JAX-written model."""
    root = tmp_path_factory.mktemp("identify")
    rng = np.random.default_rng(42)
    enrol = [_voice(rng, f0, d, 1.5) for f0, d in SPEAKERS]
    queries = {
        "q0.wav": (_voice(rng, *SPEAKERS[0], 1.2), 44100),
        "q1.wav": (_voice(rng, *SPEAKERS[1], 0.9), 44100),
        "q2_16k.wav": (_voice(rng, *SPEAKERS[2], 1.0, rate=16000), 16000),
        "noise.wav": (rng.normal(0, 4000, 30000).astype(np.int16), 44100),
        "short.wav": (_voice(rng, *SPEAKERS[0], 0.5), 44100),
    }
    for name, (pcm, rate) in queries.items():
        jwav.write_wav(str(root / name), pcm, sample_rate=rate)

    net = jmodel.SpeakerNet.new(60, 32, 16, len(SPEAKERS), seed=7)
    feats = jmfcc.extract_features_batch(enrol)
    cents = jembed.batch_clip_embeddings(net, feats)
    net.set_embeddings([(c, 0.97, 0.02) for c in cents])
    net.file_lists = [[f"enrol_{i}.wav"] for i in range(len(SPEAKERS))]
    jckpt.save(net, str(root / "model.npz"))
    return root, list(queries)


def _verdicts(text):
    return {ln.split(":")[0]: ln for ln in text.splitlines() if ".wav:" in ln}


def _sim(line):
    return float(line.rsplit("similarity ", 1)[1].split(")")[0].split(" ")[0])


@pytest.mark.parametrize("threshold", ["0.8", "0.985"])
def test_identify_cli_matches_jax(corpus, capsys, monkeypatch, threshold):
    root, names = corpus
    monkeypatch.chdir(root)
    # One device for the JAX CLI: the data mesh only shards the same math.
    monkeypatch.setenv("STREAMZ_TPU_MESH", "0")
    args = ["--identify", *names, "missing.wav", "--threshold", threshold]
    assert jcli.main(args) == 0
    jout = capsys.readouterr()
    assert tcli.main(args + ["--device", "cpu"]) == 0
    tout = capsys.readouterr()
    jv, tv = _verdicts(jout.out), _verdicts(tout.out)
    assert set(tv) == set(jv) == set(names)
    for name in names:
        # Same verdict (speaker id or unknown, and best speaker), printed
        # similarity within the last printed digit.
        assert tv[name].split("(")[0] == jv[name].split("(")[0], (tv[name], jv[name])
        assert abs(_sim(tv[name]) - _sim(jv[name])) <= 1e-3 + 1e-9
    assert "missing.wav: failed to load" in tout.err
    assert "missing.wav: failed to load" in jout.err
    verdict_kinds = {ln.split(": ")[1].split(" ")[0] for ln in tv.values()}
    if threshold == "0.8":
        assert "speaker" in verdict_kinds
    else:
        assert "unknown" in verdict_kinds


def test_similarities_and_gate_margins(corpus, monkeypatch):
    """Per-clip similarities within 1e-4 of JAX's, and far from the gate."""
    root, names = corpus
    monkeypatch.chdir(root)
    from streamz_tpu.infer.cosine import cosine_matrix_many as jcos
    from streamz_tpu_torch.infer.cosine import cosine_matrix_many as tcos
    from streamz_tpu_torch.io.audio import batch_resample

    jnet = jckpt.load("model.npz")
    tnet = tckpt.load("model.npz", device="cpu")
    pcms = [p for _, p in batch_resample(names)]
    jf = jmfcc.extract_features_batch(pcms)
    tf = FeatureExtractor(device="cpu").extract_batch(pcms)
    cents = np.stack([m for m, _, _ in jnet.embeddings])
    js = jcos(np.stack(jembed.batch_clip_embeddings(jnet, jf)), cents)
    ts = tcos(np.stack(tembed.batch_clip_embeddings(tnet, tf)), cents)
    np.testing.assert_allclose(ts, js, atol=1e-4)
    # Gate boundaries: mean - 2 std (0.93), mean + 0.3 std (0.976), 0.5,
    # 0.35 and the two thresholds; and the top-2 gap.
    for b in (0.93, 0.976, 0.5, 0.35, 0.8, 0.985):
        assert np.abs(js - b).min() > 1e-3
    top2 = np.sort(js, axis=1)[:, -2:]
    assert (top2[:, 1] - top2[:, 0]).min() > 1e-3


def test_batch_clip_embeddings_match_jax():
    """Same features into both packages: f32 MLP and mean pooling, 1e-5."""
    jnet = jmodel.SpeakerNet.new(60, 32, 16, 3, seed=4)
    from streamz_tpu_torch.nn.convert import params_from_numpy
    from streamz_tpu_torch.nn.model import SpeakerMLP, SpeakerNet

    tnet = SpeakerNet(
        mlp=SpeakerMLP(params_from_numpy(
            {k: np.asarray(v) for k, v in jnet.params.items()}, device="cpu")),
        num_speakers=3, file_lists=[[], [], []],
    )
    rng = np.random.default_rng(9)
    clips = [rng.normal(0, 1, (n, 60)).astype(np.float32) for n in (5, 0, 17, 3, 32, 9)]
    want = jembed.batch_clip_embeddings(jnet, clips)
    got = tembed.batch_clip_embeddings(tnet, clips)
    for w, g in zip(want, got):
        np.testing.assert_allclose(g, w, atol=1e-5)
    want = jembed.batch_median_embeddings(jnet, clips)
    got = tembed.batch_median_embeddings(tnet, clips)
    for w, g in zip(want, got):
        np.testing.assert_allclose(g, w, atol=1e-5)


def test_vote_counts_match_jax(corpus, monkeypatch):
    """identify_speaker_list_batch gives JAX's speaker lists, and the gated
    vote counts on the same features are equal.  Margins: no window's best
    probability lies within 1e-4 of the threshold or of the runner-up."""
    root, names = corpus
    monkeypatch.chdir(root)
    from streamz_tpu_torch.io.audio import batch_resample

    jnet = jckpt.load("model.npz")
    tnet = tckpt.load("model.npz", device="cpu")
    pcms = [p for _, p in batch_resample(names)]
    threshold = 0.6
    feats = jmfcc.extract_features_batch(pcms)
    W = max(len(f) for f in feats)
    batch = np.zeros((len(feats), W, 60), np.float32)
    lens = np.asarray([len(f) for f in feats], np.int32)
    for i, f in enumerate(feats):
        batch[i, : len(f)] = f
    probs = np.asarray(jmodel.forward(jnet.params, jnp.asarray(batch), 3))[..., :3]
    valid = np.arange(W)[None, :] < lens[:, None]
    best = np.sort(probs, axis=-1)[valid]
    assert np.abs(best[:, -1] - threshold).min() > 1e-4
    assert (best[:, -1] - best[:, -2]).min() > 1e-4

    jc = np.asarray(jidentify._vote_counts_batch(
        jnet.params, jnp.asarray(batch), jnp.asarray(lens), 3, jnp.float32(threshold)))
    import torch

    tc = tidentify._vote_counts_batch(
        tnet.params, torch.from_numpy(batch), torch.from_numpy(lens.astype(np.int64)),
        3, threshold).numpy()
    np.testing.assert_array_equal(tc, jc)
    for i, f in enumerate(feats):
        assert tidentify._list_from_probs(probs[i, : len(f)], 3, threshold) == \
            jidentify._list_from_probs(probs[i, : len(f)], 3, threshold)
    # The ordering rule both paths share: descending count, ties by id.
    assert tidentify._sorted_from_counts(np.array([2, 5, 0, 5, 1]), 4) == [1, 3, 0]

    want = jidentify.identify_speaker_list_batch(jnet, pcms, threshold)
    got = tidentify.identify_speaker_list_batch(
        tnet, pcms, threshold, FeatureExtractor(device="cpu"))
    assert got == want
    assert any(got)


def test_identify_requires_model(tmp_path, monkeypatch, capsys):
    monkeypatch.chdir(tmp_path)
    jwav.write_wav(str(tmp_path / "a.wav"), np.zeros(4000, np.int16))
    assert tcli.main(["--identify", "a.wav", "--device", "cpu"]) == 1
    assert "Failed to load model" in capsys.readouterr().err


def test_identify_missing_value(tmp_path, monkeypatch, capsys):
    monkeypatch.chdir(tmp_path)
    assert tcli.main(["--identify", "--threshold", "0.5"]) == 1
    assert "Missing value for --identify" in capsys.readouterr().err


def test_identify_all_inputs_failed(corpus, monkeypatch, capsys):
    root, _ = corpus
    monkeypatch.chdir(root)
    assert tcli.main(["--identify", "nope1.wav", "nope2.wav", "--device", "cpu"]) == 1
    assert "No input file could be loaded" in capsys.readouterr().err


@pytest.mark.parametrize("args", [["--process-id", "0"], ["--coordinator", "localhost:1234"],
                                  ["--identify", "a.wav", "--process-id", "1"],
                                  ["--no-cache-wav", "--num-processes", "2"]])
def test_unported_flags_return_2(tmp_path, monkeypatch, capsys, args):
    """The JAX CLI's modes that are not ported yet (the multi-host flags;
    ``--serve`` is ported) are refused before any work: rc 2 and no model
    is written."""
    monkeypatch.chdir(tmp_path)
    assert tcli.main(args) == 2
    assert "not yet ported to streamz_tpu_torch" in capsys.readouterr().err
    assert not os.path.exists(tmp_path / "model.npz")


def test_help(capsys):
    assert tcli.main(["--help"]) == 0
    assert "--identify" in capsys.readouterr().out


def test_help_into_a_closed_pipe_exits_0(tmp_path):
    """``python -m streamz_tpu_torch --help`` whose reader closed the pipe
    before the child wrote (as ``--help | head -0`` can): rc 0 and nothing
    on stderr, as the JAX CLI's guard gives (streamz_tpu/cli.py:196-208)."""
    import subprocess
    import sys

    read_end, write_end = os.pipe()
    os.close(read_end)
    try:
        proc = subprocess.run([sys.executable, "-m", "streamz_tpu_torch", "--help"],
                              stdout=write_end, stderr=subprocess.PIPE, timeout=120,
                              cwd=os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    finally:
        os.close(write_end)
    assert proc.returncode == 0
    assert proc.stderr == b""


def test_identify_on_cuda_without_card_fails_cleanly(corpus, monkeypatch, capsys):
    import torch

    root, names = corpus
    monkeypatch.chdir(root)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert tcli.main(["--identify", names[0]]) == 1
    assert "CUDA is not available" in capsys.readouterr().err
