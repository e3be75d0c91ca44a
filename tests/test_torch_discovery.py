"""The discovery loop and the default CLI run: the port against the JAX package.

Both packages run the same synthetic corpora on the CPU with dropout 0.2
and the same keys (each package's process-global key counter reset to 0,
so both draw PRNGKey(1) first and fold in the file index).  The labels and
class counts must be identical and the centroids agree within rtol 1e-3 /
atol 1e-5 (as ``tests/test_device_loop.py`` holds the JAX loop to its host
oracle).  The corpora's clusters are well separated: each test prints the
smallest decision margin the port's loop saw (how far a similarity lay
from another label), which stays far above the f32 differences between
the packages (about 1e-6).

Where a run keeps pushing the weights without converging (files forced
onto a capped class, or a zero target that the softmax of one live class
can never reach), a 1e-7 relative change of the initial weights grows to
about 1e-3 in the parameters when the features are three times their
z-normed scale; those tests draw unit-scale features, as the frontend's
z-norm gives, where the two packages agree within 1e-5.
"""

import os

import numpy as np
import pytest

from streamz_tpu.app import incremental as jinc
from streamz_tpu.nn import drivers as jdrivers
from streamz_tpu.nn import model as jmodel
from streamz_tpu_torch.app import incremental as tinc
from streamz_tpu_torch.nn import drivers as tdrivers
from streamz_tpu_torch.nn import model as tmodel


def _corpus(n_files, n_clusters, rng, windows_per_file=12, dim=60, noise=0.1,
            scale=3.0):
    centers = rng.normal(size=(n_clusters, dim)).astype(np.float32) * scale
    files, fm = [], {}
    for i in range(n_files):
        wins = (centers[i % n_clusters]
                + rng.normal(0, noise, size=(windows_per_file, dim))).astype(np.float32)
        files.append((f"clip_{i}.wav", None))
        fm[f"clip_{i}.wav"] = wins
    return files, fm


def _nets(output, seed, embeddings=None):
    jnet = jmodel.SpeakerNet.new(output=output, seed=seed)
    tnet = tmodel.SpeakerNet.new(output=output, seed=seed, device="cpu")
    if embeddings is not None:
        jnet.set_embeddings(embeddings)
        tnet.set_embeddings(embeddings)
    return jnet, tnet


def _run_both(monkeypatch, files, fm, jnet, tnet, **kw):
    monkeypatch.setattr(jdrivers, "_key_counter", [0])
    monkeypatch.setattr(tdrivers, "_key_counter", [0])
    jf, tf = list(files), list(files)
    jr = jinc.run_incremental(jnet, jf, dict(fm), show_progress=False, **kw)
    tr = tinc.run_incremental(tnet, tf, dict(fm), show_progress=False, **kw)
    finite = [m for m in tr.decision_margins if np.isfinite(m)]
    print(f"smallest decision margin: {min(finite) if finite else 'none decided'}")
    return (jf, jr), (tf, tr)


def _assert_same(jnet, tnet, jrun, trun):
    (jf, jr), (tf, tr) = jrun, trun
    assert [c for _, c in tf] == [c for _, c in jf]
    assert tnet.output_size() == jnet.output_size()
    assert tnet.capacity == jnet.capacity
    assert tnet.file_lists == jnet.file_lists
    assert tr.processed == jr.processed
    assert set(tr.speaker_embeddings) == set(jr.speaker_embeddings)
    for sid, c in jr.speaker_embeddings.items():
        np.testing.assert_allclose(tr.speaker_embeddings[sid], c, rtol=1e-3, atol=1e-5)
    assert abs(tr.total_loss - jr.total_loss) <= 1e-3 * max(1.0, abs(jr.total_loss))
    for k, v in jnet.params.items():
        np.testing.assert_allclose(tnet.params[k].detach().numpy(), np.asarray(v),
                                   atol=1e-4, err_msg=k)


def test_discovery_matches_jax(monkeypatch):
    rng = np.random.default_rng(0)
    files, fm = _corpus(24, 3, rng)
    files[0] = (files[0][0], 0)
    jnet, tnet = _nets(1, 0)
    runs = _run_both(monkeypatch, files, fm, jnet, tnet, burn_in_limit=4,
                     conf_threshold=0.8, dropout=0.2)
    _assert_same(jnet, tnet, *runs)
    assert tnet.output_size() > 1


def test_discovery_with_seeds_and_labels_matches_jax(monkeypatch):
    """Seeded centroids (a resumed model) and a mix of labelled files."""
    rng = np.random.default_rng(3)
    files, fm = _corpus(16, 2, rng)
    for i in (0, 1, 4):
        files[i] = (files[i][0], i % 2)
    seeds = [(np.ones(256, np.float32) / 16.0, 0.9, 0.05),
             (-np.ones(256, np.float32) / 16.0, 0.9, 0.05)]
    jnet, tnet = _nets(2, 1, seeds)
    runs = _run_both(monkeypatch, files, fm, jnet, tnet, burn_in_limit=2,
                     conf_threshold=0.8, dropout=0.2)
    _assert_same(jnet, tnet, *runs)


def test_discovery_max_speakers_cap_matches_jax(monkeypatch):
    rng = np.random.default_rng(2)
    files, fm = _corpus(12, 6, rng, scale=1.0)
    files[0] = (files[0][0], 0)
    jnet, tnet = _nets(1, 0)
    runs = _run_both(monkeypatch, files, fm, jnet, tnet, burn_in_limit=12,
                     conf_threshold=0.99, max_speakers=4, dropout=0.2)
    _assert_same(jnet, tnet, *runs)
    assert tnet.output_size() <= 4
    assert all(c is not None and c < 4 for _, c in runs[1][0])


def test_discovery_out_of_range_label_matches_jax(monkeypatch):
    """A label beyond the live classes trains a zero target and grows
    nothing (src/lib.rs:592-594); a too-short clip is skipped."""
    rng = np.random.default_rng(4)
    files, fm = _corpus(4, 1, rng, scale=1.0)
    files = [(p, 7) for p, _ in files[:3]] + [files[3]]
    fm[files[3][0]] = fm[files[3][0]][:4]  # fewer than 5 windows
    jnet, tnet = _nets(1, 0)
    runs = _run_both(monkeypatch, files, fm, jnet, tnet, burn_in_limit=0,
                     dropout=0.2)
    _assert_same(jnet, tnet, *runs)
    assert tnet.output_size() == 1
    assert [c for _, c in runs[1][0]] == [7, 7, 7, None]


# ---------------------------------------------------------------------------
# The bare CLI run of both packages on the same clips.
# ---------------------------------------------------------------------------

SPEAKERS = [(110.0, 0.55), (190.0, 0.8), (300.0, 0.35), (150.0, 0.7)]


def _voice(rng, f0, decay, seconds=1.0, rate=44100):
    t = np.arange(int(seconds * rate)) / rate
    x = sum(decay ** h * np.sin(2 * np.pi * f0 * (h + 1) * t + rng.uniform(0, 6.3))
            for h in range(12))
    x = x * (1 + 0.3 * np.sin(2 * np.pi * 3 * t)) + rng.normal(0, 0.05, t.shape)
    return np.clip(x / np.abs(x).max() * 12000, -32768, 32767).astype(np.int16)


@pytest.fixture(scope="module")
def clips(tmp_path_factory):
    """8 one-second WAVs of 4 synthetic speakers, the first 3 labelled."""
    from streamz_tpu.io import wav

    src = tmp_path_factory.mktemp("clips")
    rng = np.random.default_rng(5)
    lines = []
    for i in range(8):
        name = f"c{i}_s{i % 4}.wav"
        wav.write_wav(str(src / name), _voice(rng, *SPEAKERS[i % 4]))
        lines.append(f"{name},{i % 4}" if i < 3 else name)
    return src, "\n".join(lines) + "\n"


def _run_cli(monkeypatch, capsys, tmp_path, clips, package, args):
    import shutil

    from streamz_tpu import cli as jcli
    from streamz_tpu_torch import cli as tcli

    src, lines = clips
    work = tmp_path / package
    if not work.exists():
        shutil.copytree(src, work)
        (work / "train_files.txt").write_text(lines)
    monkeypatch.chdir(work)
    monkeypatch.setenv("STREAMZ_TPU_MESH", "0")  # one device, as the port
    monkeypatch.setattr(jdrivers, "_key_counter", [0])
    monkeypatch.setattr(tdrivers, "_key_counter", [0])
    report = {}
    if package == "jax":
        rc = jcli.main(args)
    else:
        rc = tcli.main(args + ["--device", "cpu"], report=report)
    out = capsys.readouterr().out
    return rc, out, work, report


@pytest.mark.parametrize("args", [["--threshold", "0.9", "--burn-in-limit", "2"],
                                  ["--burn-in-limit", "3", "--max-speakers", "3"]])
def test_bare_cli_matches_jax(monkeypatch, capsys, tmp_path, clips, args):
    """The default run: the same relabelled train_files.txt and
    target_files.txt, the same printed labels and class count, and
    model.npz parameters within 1e-4 (a hundred corpus epochs and eight
    files of chunk SGD in f32).  A second run resumes from model.npz."""
    from streamz_tpu_torch.nn import checkpoint as tckpt

    results = {}
    for package in ("jax", "torch"):
        rc, out, work, report = _run_cli(monkeypatch, capsys, tmp_path, clips,
                                         package, args)
        assert rc == 0
        results[package] = (out, work)
    (jout, jwork), (tout, twork) = results["jax"], results["torch"]
    for name in ("train_files.txt", "target_files.txt"):
        assert (twork / name).read_text() == (jwork / name).read_text(), name
    keep = ("Number of speakers", "->", "Speaker ", "Processed", "Initial")
    lines = [[ln for ln in o.splitlines() if ln.startswith(keep) or " -> speaker" in ln]
             for o in (jout, tout)]
    assert lines[0] == lines[1]
    jnet = tckpt.load(str(jwork / "model.npz"), device="cpu")
    tnet = tckpt.load(str(twork / "model.npz"), device="cpu")
    assert tnet.num_speakers == jnet.num_speakers
    assert tnet.file_lists == jnet.file_lists
    # Live columns only: the loader draws the padding columns from a hash of
    # the live ones, so any difference there re-draws them all.
    ns = tnet.num_speakers
    for k in jnet.params:
        t, j = (n.params[k].detach().numpy() for n in (tnet, jnet))
        if k in ("w3", "b3"):
            t, j = t[..., :ns], j[..., :ns]
        np.testing.assert_allclose(t, j, atol=1e-4, err_msg=k)
    assert set(report["phase_seconds"]) == {"ingest", "features", "corpus",
                                            "discovery", "finalize"}
    assert len(report["decision_margins"]) == 8
    # Resume: the second run loads model.npz and skips the corpus training.
    for package in ("jax", "torch"):
        rc, out, _, report = _run_cli(monkeypatch, capsys, tmp_path, clips, package,
                                      args)
        assert rc == 0 and "Loaded saved model" in out
    assert "corpus" not in report["phase_seconds"]
    for name in ("train_files.txt", "target_files.txt"):
        assert (twork / name).read_text() == (jwork / name).read_text(), name


def test_bare_cli_without_labels_assigns_speaker_0(monkeypatch, capsys, tmp_path, clips):
    from streamz_tpu_torch import cli as tcli

    src, lines = clips
    unlabelled = "".join(ln.split(",")[0] + "\n" for ln in lines.splitlines())
    (tmp_path / "w").mkdir()
    for name in os.listdir(src):
        if name.endswith(".wav"):
            (tmp_path / "w" / name).write_bytes((src / name).read_bytes())
    (tmp_path / "w" / "train_files.txt").write_text(unlabelled)
    monkeypatch.chdir(tmp_path / "w")
    assert tcli.main(["--device", "cpu", "--burn-in-limit", "1", "--force"]) == 0
    out = capsys.readouterr().out
    assert "No labeled speakers found - assigned speaker 0 to first file." in out
    assert (tmp_path / "w" / "model.npz").exists()
    assert (tmp_path / "w" / "train_files.txt").read_text().startswith("c0_s0.wav,0\n")


def test_bare_cli_needs_train_files(monkeypatch, capsys, tmp_path):
    from streamz_tpu_torch import cli as tcli

    monkeypatch.chdir(tmp_path)
    assert tcli.main(["--device", "cpu"]) == 1
    assert "train_files.txt is empty" in capsys.readouterr().err


def test_embedding_and_match_helpers_match_jax():
    """The per-clip mean embedding (1e-5) and the best-centroid match with
    the under-20 relaxation (same ids) of both packages."""
    from streamz_tpu.infer import cosine as jcos
    from streamz_tpu.infer import embed as jemb
    from streamz_tpu_torch.infer import cosine as tcos
    from streamz_tpu_torch.infer import embed as temb

    jnet, tnet = _nets(3, 4)
    rng = np.random.default_rng(10)
    for n in (0, 7, 40):
        feats = rng.normal(0, 1, (n, 60)).astype(np.float32)
        np.testing.assert_allclose(temb.extract_embedding_from_features(tnet, feats),
                                   jemb.extract_embedding_from_features(jnet, feats),
                                   atol=1e-5)
    cents = {i: rng.normal(0, 1, 256).astype(np.float32) for i in (0, 2, 5)}
    for _ in range(20):
        emb = rng.normal(0, 1, 256).astype(np.float32)
        emb = emb + 3 * cents[int(rng.choice([0, 2, 5]))] * rng.uniform()
        for thr in (0.3, 0.8):
            assert (tcos.identify_speaker_from_embedding(emb, cents, thr)
                    == jcos.identify_speaker_from_embedding(emb, cents, thr))
    assert tcos.identify_speaker_from_embedding(cents[0], {}, 0.5) is None


def test_filelists_and_precache_match_jax(tmp_path, monkeypatch):
    """The list formats round-trip as the JAX package writes them, and the
    MP3 precache prefers a neighbouring WAV and drops what it cannot
    convert, as the JAX package does."""
    from streamz_tpu.io import audio as jaudio
    from streamz_tpu.io import filelists as jfl
    from streamz_tpu_torch.io import audio as taudio
    from streamz_tpu_torch.io import filelists as tfl

    monkeypatch.chdir(tmp_path)
    (tmp_path / "lists.txt").write_text("a.wav,3\nb.mp3\n,4\nc.wav,x\nd.wav, 7 \n\n")
    for fn in ("load_train_files", "load_target_files"):
        assert getattr(tfl, fn)("lists.txt") == getattr(jfl, fn)("lists.txt")
    entries = tfl.load_train_files("lists.txt")
    tfl.write_train_files("t.txt", entries)
    jfl.write_train_files("j.txt", entries)
    assert (tmp_path / "t.txt").read_text() == (tmp_path / "j.txt").read_text()
    tfl.write_target_files("t.txt", entries)
    jfl.write_target_files("j.txt", entries)
    assert (tmp_path / "t.txt").read_text() == (tmp_path / "j.txt").read_text()
    assert tfl.count_speakers(entries) == jfl.count_speakers(entries) == 2
    label_map = tfl.build_label_map(entries, [("e.wav", 9)])
    assert label_map == jfl.build_label_map(entries, [("e.wav", 9)])
    assert tfl.normalize_with_map(entries, label_map) == jfl.normalize_with_map(
        entries, label_map)

    (tmp_path / "near.wav").write_bytes(b"")
    (tmp_path / "broken.mp3").write_bytes(b"not an mp3")
    files = [("near.mp3", 1), ("broken.mp3", None), ("keep.wav", 2)]
    tfiles, jfiles = list(files), list(files)
    taudio.precache_mp3_files(tfiles)
    jaudio.precache_mp3_files(jfiles)
    assert tfiles == jfiles == [("near.wav", 1), ("broken.mp3", None), ("keep.wav", 2)]
    np.testing.assert_array_equal(taudio.i16_to_f32(np.array([-32767, 0, 32767], np.int16)),
                                  jaudio.i16_to_f32(np.array([-32767, 0, 32767], np.int16)))
