"""The port's CLI as one process and as a multi-process run, on the CPU.

The default run and then ``--eval`` on a small synthesized corpus, once as
one process and once as two (``--coordinator 127.0.0.1:<port>
--num-processes 2 --process-id i --device cpu``), each process in its own
working directory holding the same files, as ``tests/test_multihost.py:116-207``
runs the JAX CLI.  Every process of the two writes the same
``train_files.txt`` as the single process and prints the same labels, and
the four metric lines of ``--eval`` are equal.  Every run has a hard
deadline (``test_torch_dist.run_ranks``).
"""

import sys

import numpy as np
import pytest

from test_torch_dist import run_ranks

SPEAKERS = [(110.0, 0.55), (190.0, 0.8), (300.0, 0.35), (150.0, 0.7)]
ARGS = ["--device", "cpu", "--burn-in-limit", "3", "--threshold", "0.9"]


def _voice(rng, f0, decay, seconds, rate=44100):
    t = np.arange(int(seconds * rate)) / rate
    x = sum(decay ** h * np.sin(2 * np.pi * f0 * (h + 1) * t + rng.uniform(0, 6.3))
            for h in range(12))
    x = x * (1 + 0.3 * np.sin(2 * np.pi * 3 * t)) + rng.normal(0, 0.05, t.shape)
    return np.clip(x / np.abs(x).max() * 12000, -32768, 32767).astype(np.int16)


def _metrics(text):
    return [ln.strip() for ln in text.splitlines()
            if ln.strip().startswith(("Accuracy:", "Precision:", "Recall:", "F1-score:"))]


def _labels(text):
    return [ln for ln in text.splitlines()
            if " -> speaker" in ln or ln.startswith(("Number of speakers", "Speaker "))]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The working directories and the (rc, output) of every process, for
    the default run and then --eval, each as one process and as two."""
    from streamz_tpu_torch.io import wav

    root = tmp_path_factory.mktemp("distcli")
    rng = np.random.default_rng(5)
    clips = {f"c{i}_s{i % 4}.wav": _voice(rng, *SPEAKERS[i % 4], 0.8 + 0.05 * i)
             for i in range(8)}
    lines = [f"{n},{i % 4}" if i < 3 else n for i, n in enumerate(clips)]
    dirs = {1: [root / "single"], 2: [root / "p0", root / "p1"]}
    for d in dirs[1] + dirs[2]:
        d.mkdir()
        for name, pcm in clips.items():
            wav.write_wav(str(d / name), pcm)
        (d / "train_files.txt").write_text("\n".join(lines) + "\n")
    outs = {}
    for mode, extra in (("train", []), ("eval", ["--eval"])):
        for world, ds in dirs.items():
            flags = [] if world == 1 else ["--coordinator", "127.0.0.1:{port}",
                                           "--num-processes", str(world)]
            outs[mode, world] = run_ranks(world, lambda r, port: [
                sys.executable, "-m", "streamz_tpu_torch", *ARGS, *extra,
                *(f.format(port=port) for f in flags),
                *([] if world == 1 else ["--process-id", str(r)])],
                cwd_of=lambda r: ds[r], deadline=120)
            for rc, text in outs[mode, world]:
                assert rc == 0, text[-3000:]
    return dirs, outs


def test_two_process_default_run_writes_the_single_process_labels(runs):
    dirs, outs = runs
    want = (dirs[1][0] / "train_files.txt").read_text()
    single = outs["train", 1][0][1]
    assert "Running on" not in single
    for d, (_, text) in zip(dirs[2], outs["train", 2]):
        assert "Running on 2 devices (data-parallel mesh across 2 hosts, gloo)" in text
        assert (d / "train_files.txt").read_text() == want
        assert (d / "target_files.txt").read_text() == (
            dirs[1][0] / "target_files.txt").read_text()
        assert _labels(text) == _labels(single)
    assert len(_labels(single)) > 8


def test_two_process_eval_prints_the_single_process_metrics(runs):
    _, outs = runs
    want = _metrics(outs["eval", 1][0][1])
    assert len(want) == 4
    for _, text in outs["eval", 2]:
        assert _metrics(text) == want
