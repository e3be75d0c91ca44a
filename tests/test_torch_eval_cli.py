"""``--eval``, ``--eval-split``, ``--check-embeddings``,
``--cluster-embeddings`` and ``--profile``: the port's CLI on the CPU
against the JAX CLI on the same working directory.

Each package runs in its own copy of the directory (a mode may write
``feature_cache/``).  The model is written by the JAX package
(``checkpoint.save``, a 60→32→16 net with three speakers whose stored
centroids come from their training clips), the clips are seeded synthetic
WAVs.  Both CLIs must return the same code and print the same lines; a
number printed with more digits than the f32 difference between the
packages allows (the verbose per-file similarities, 6 decimals) may differ
by 1e-5, every other token must be equal.
"""

import os
import re
import shutil

import numpy as np
import pytest

from streamz_tpu import cli as jcli
from streamz_tpu.dsp import mfcc as jmfcc
from streamz_tpu.infer import embed as jembed
from streamz_tpu.io import filelists as jfl
from streamz_tpu.io import wav as jwav
from streamz_tpu.nn import checkpoint as jckpt
from streamz_tpu.nn import model as jmodel
from streamz_tpu_torch import cli as tcli

SPEAKERS = [(110.0, 0.55), (190.0, 0.8), (300.0, 0.35)]  # (f0, harmonic decay)
_NUM = re.compile(r"-?\d+\.\d+")


def _voice(rng, f0, decay, seconds=1.0, rate=44100):
    t = np.arange(int(seconds * rate)) / rate
    x = sum(decay ** h * np.sin(2 * np.pi * f0 * (h + 1) * t + rng.uniform(0, 6.3))
            for h in range(12))
    x = x * (1 + 0.3 * np.sin(2 * np.pi * 3 * t)) + rng.normal(0, 0.05, t.shape)
    return np.clip(x / np.abs(x).max() * 12000, -32768, 32767).astype(np.int16)


@pytest.fixture(scope="module")
def workdir(tmp_path_factory):
    """Two labelled training clips per speaker, one held-out clip each
    listed as an MP3 whose cache WAV exists (the precache rewrites the
    list), and three JAX-written models: with stored embeddings, without
    (so --check-embeddings recomputes them from the speakers' files), and
    a corrupt one."""
    root = tmp_path_factory.mktemp("eval")
    rng = np.random.default_rng(21)
    (root / "cache").mkdir()
    train, feats = [], []
    for s, (f0, d) in enumerate(SPEAKERS):
        for j in range(2):
            pcm = _voice(rng, f0, d, 0.8 + 0.2 * j)
            jwav.write_wav(str(root / f"t{s}{j}.wav"), pcm)
            train.append((f"t{s}{j}.wav", s))
            feats.append(pcm)
        jwav.write_wav(str(root / "cache" / f"h{s}.wav"), _voice(rng, f0, d, 0.9))
    # One held-out clip of speaker 2 listed under speaker 0's label: a miss.
    targets = [("clips/h0.mp3", 0), ("clips/h1.mp3", 1), ("clips/h2.mp3", 0)]
    jfl.write_train_files(str(root / "train_files.txt"), train)
    jfl.write_target_files(str(root / "target_files.txt"), targets)

    net = jmodel.SpeakerNet.new(60, 32, 16, len(SPEAKERS), seed=7)
    embs = jembed.batch_clip_embeddings(net, jmfcc.extract_features_batch(feats))
    net.file_lists = [[p for p, c in train if c == s] for s in range(len(SPEAKERS))]
    jckpt.save(net, str(root / "bare.npz"))
    net.set_embeddings([(jembed.normalize(embs[2 * s] + embs[2 * s + 1]), 0.97 - 0.01 * s,
                         0.02 + 0.005 * s) for s in range(len(SPEAKERS))])
    jckpt.save(net, str(root / "model.npz"))
    (root / "corrupt.npz").write_bytes(b"PK\x03\x04 not a model")
    return root


def _run(monkeypatch, capsys, tmp_path, workdir, package, args, model="model.npz"):
    work = tmp_path / package
    shutil.copytree(workdir, work)
    if model != "model.npz":
        if (work / model).exists():
            os.replace(work / model, work / "model.npz")
        else:
            os.remove(work / "model.npz")
    monkeypatch.chdir(work)
    monkeypatch.setenv("STREAMZ_TPU_MESH", "0")  # one device, as the port
    report = {}
    if package == "jax":
        rc = jcli.main(args)
    else:
        rc = tcli.main(args + ["--device", "cpu"], report=report)
    out = capsys.readouterr()
    return rc, out.out, out.err, report


def _assert_same_text(got: str, want: str, tol: float = 1e-5):
    g, w = got.splitlines(), want.splitlines()
    assert len(g) == len(w), (got, want)
    for a, b in zip(g, w):
        assert _NUM.sub("#", a) == _NUM.sub("#", b), (a, b)
        for x, y in zip(_NUM.findall(a), _NUM.findall(b)):
            assert abs(float(x) - float(y)) <= tol, (a, b)


def _both(monkeypatch, capsys, tmp_path, workdir, args, model="model.npz"):
    j = _run(monkeypatch, capsys, tmp_path, workdir, "jax", args, model)
    t = _run(monkeypatch, capsys, tmp_path, workdir, "torch", args, model)
    assert t[0] == j[0]
    return j, t


@pytest.mark.parametrize("args", [
    ["--eval", "--threshold", "0.6"],
    ["--eval", "--threshold", "0.997"],
])
def test_eval_matches_jax(monkeypatch, capsys, tmp_path, workdir, args):
    """The MP3 target list through the precache, the plain sim > threshold
    match: the same stdout (metrics to two decimals) and the same verbose
    log; the port's metrics dict has the counts the text shows."""
    (jrc, jout, jerr, _), (trc, tout, terr, report) = _both(
        monkeypatch, capsys, tmp_path, workdir, args)
    assert jrc == 0
    assert tout == jout
    assert "Evaluation complete:" in tout
    _assert_same_text(terr, jerr)
    m = report["metrics"]
    assert m["correct"] + m["false_positive"] + m["false_negative"] == 3
    assert set(report["phase_seconds"]) == {"ingest", "features", "eval"}
    assert report["store_stats"]["host_pack_bytes"] == 0
    if args[-1] == "0.6":
        assert m["correct"] == 2 and m["false_positive"] == 1
    else:
        assert m["false_negative"] > 0


def test_eval_split_matches_jax(monkeypatch, capsys, tmp_path, workdir):
    """No target list: the tail half of the labelled training files."""
    os.replace(workdir / "target_files.txt", workdir / "targets.bak")
    try:
        (_, jout, jerr, _), (_, tout, terr, report) = _both(
            monkeypatch, capsys, tmp_path, workdir,
            ["--eval", "--eval-split", "0.5", "--threshold", "0.8"])
    finally:
        os.replace(workdir / "targets.bak", workdir / "target_files.txt")
    assert tout == jout
    _assert_same_text(terr, jerr)
    assert terr.count("Evaluating file:") == 3
    assert report["metrics"]["correct"] > 0


@pytest.mark.parametrize("model", ["corrupt.npz", "absent.npz"])
def test_eval_without_a_model_matches_jax(monkeypatch, capsys, tmp_path, workdir, model):
    (jrc, jout, jerr, _), (_, tout, terr, _) = _both(
        monkeypatch, capsys, tmp_path, workdir, ["--eval"], model=model)
    assert jrc == 1
    assert tout == jout
    last = terr.splitlines()[-1]
    assert last == jerr.splitlines()[-1]
    assert last.startswith("Failed to load model:" if model == "corrupt.npz"
                           else "Model file model.npz not found.")


@pytest.mark.parametrize("model", ["model.npz", "bare.npz"])
def test_check_embeddings_matches_jax(monkeypatch, capsys, tmp_path, workdir, model):
    """The stored stats as saved, or, without stored embeddings, those
    recomputed from the speakers' files through each package's frontend
    (4 decimals: within 1e-4)."""
    (jrc, jout, _, _), (_, tout, _, _) = _both(
        monkeypatch, capsys, tmp_path, workdir, ["--check-embeddings"], model=model)
    assert jrc == 0
    if model == "model.npz":
        assert tout == jout
        assert "Saved embeddings found in model.npz:" in tout
    else:
        _assert_same_text(tout, jout, tol=1e-4 + 1e-9)
        assert tout.count(": mean similarity") == len(SPEAKERS)


@pytest.mark.parametrize("args", [["--cluster-embeddings", "3"],
                                  ["--cluster-embeddings", "-1"]])
def test_cluster_embeddings_matches_jax(monkeypatch, capsys, tmp_path, workdir, args):
    (jrc, jout, jerr, _), (_, tout, terr, _) = _both(
        monkeypatch, capsys, tmp_path, workdir, args)
    assert tout == jout and terr == jerr
    if args[-1] == "3":
        assert jrc == 0 and tout.count(" -> cluster ") == len(SPEAKERS)
    else:
        assert jrc == 1


def test_profile_prints_phases_and_writes_a_trace(monkeypatch, capsys, tmp_path, workdir):
    """--profile dir: the phase report after the metrics, and a
    torch.profiler trace in dir; the rest of the output as without it."""
    _, out, _, report = _run(monkeypatch, capsys, tmp_path, workdir, "torch",
                             ["--eval", "--profile", "traces", "--threshold", "0.6"])
    assert "Phase timing:" in out
    for name in ("ingest", "features", "eval", "total"):
        assert re.search(rf"^  {name} +\d+\.\d{{3}}s", out, re.M), name
    traces = os.listdir("traces")
    assert len(traces) == 1 and traces[0].endswith(".pt.trace.json")
    assert "aten::" in (tmp_path / "torch" / "traces" / traces[0]).read_text()
    plain = out.split("Phase timing:")[0]
    shutil.rmtree(tmp_path / "torch")
    _, out2, _, _ = _run(monkeypatch, capsys, tmp_path, workdir, "torch",
                         ["--eval", "--threshold", "0.6"])
    assert plain == out2


def test_phase_timer_and_watchdog_match_jax(capsys):
    """PhaseTimer adds a phase entered twice and reports as the JAX one
    does; the watchdog prints its stall diagnostic as the JAX one does."""
    import time

    from streamz_tpu.runtime import profiler as jprof
    from streamz_tpu.runtime import watchdog as jwd
    from streamz_tpu_torch.runtime import profiler as tprof
    from streamz_tpu_torch.runtime import watchdog as twd

    timer = tprof.PhaseTimer("cpu")
    for _ in range(2):
        with timer.phase("a"):
            time.sleep(0.01)
    assert timer.phases["a"] >= 0.02
    jt = jprof.PhaseTimer()
    jt.phases = timer.phases = {"ingest": 0.25, "eval": 1.5, "features": 0.0}
    assert timer.report() == jt.report()
    with tprof.trace(None, "cpu"):  # no directory: a no-op
        pass
    for wd in (twd, jwd):
        with wd.watchdog("stall", 0.01):
            time.sleep(0.2)
    err = capsys.readouterr().err.splitlines()
    heads = [ln for ln in err if "still running" in ln]
    assert len(heads) == 2 and heads[0] == heads[1]
