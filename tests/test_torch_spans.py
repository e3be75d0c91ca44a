"""The port's spans (``runtime/profiler.span``) and the phases that open them.

A span is a host range named ``streamz.<name>`` in the running
``torch.profiler``: a CPU operation, never a user annotation, so that it
has no shadow on the device timeline.  With no profiler running it is a
shared no-op.  The CLI's phases are spans of their names, and spans under
them mark the layers inside: the frontend's pack, upload, download and
unpack, the corpus draws, each discovery file, the file's draws, the loop's
read-back and finalize's writes; under ingest, the native resampler's pass.

This file imports neither jax nor the JAX package: its ``cuda`` case also
runs on a machine with a card (``python -m pytest --noconftest -m cuda
tests/test_torch_spans.py -q``).
"""

import re

import numpy as np
import pytest
import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

from streamz_tpu_torch import cli
from streamz_tpu_torch.io import audio, native, wav
from streamz_tpu_torch.nn import drivers
from streamz_tpu_torch.runtime import profiler

DEFAULT_RUN_SPANS = {"ingest", "features", "features.pack", "features.upload",
                     "features.download", "features.unpack", "corpus", "corpus.draws",
                     "discovery", "discovery.file", "train.draws", "discovery.fetch",
                     "finalize", "finalize.save"}
SPEAKERS = [(110.0, 0.55), (190.0, 0.8), (300.0, 0.35)]


def _voice(rng, f0, decay, seconds=1.0, rate=44100):
    t = np.arange(int(seconds * rate)) / rate
    x = sum(decay ** h * np.sin(2 * np.pi * f0 * (h + 1) * t + rng.uniform(0, 6.3))
            for h in range(12))
    x = x * (1 + 0.3 * np.sin(2 * np.pi * 3 * t)) + rng.normal(0, 0.05, t.shape)
    return np.clip(x / np.abs(x).max() * 12000, -32768, 32767).astype(np.int16)


def _corpus(root):
    """6 one-second WAVs of 3 synthetic speakers, the first 3 labelled, and
    their ``train_files.txt``."""
    rng = np.random.default_rng(3)
    lines = []
    for i in range(6):
        name = f"c{i}_s{i % 3}.wav"
        wav.write_wav(str(root / name), _voice(rng, *SPEAKERS[i % 3]))
        lines.append(f"{name},{i % 3}" if i < 3 else name)
    (root / "train_files.txt").write_text("\n".join(lines) + "\n")
    return root


def _streamz(prof):
    """The ``streamz.*`` events of a finished profile, by name without the prefix."""
    out = {}
    for e in prof.events():
        if e.name.startswith("streamz."):
            out.setdefault(e.name[len("streamz."):], []).append(e)
    return out


def _traced_cli(argv, activities, report=None):
    with profile(activities=activities, record_shapes=True) as prof:
        rc = cli.main(argv, report=report)
    return rc, _streamz(prof)


@pytest.fixture(scope="module")
def trained(tmp_path_factory):
    """One default run on the CPU under the profiler: its directory, its
    report and its spans."""
    work = _corpus(tmp_path_factory.mktemp("spans"))
    mp = pytest.MonkeyPatch()
    try:
        mp.chdir(work)
        mp.setattr(drivers, "_key_counter", [0])
        report = {}
        rc, spans = _traced_cli(["--device", "cpu", "--burn-in-limit", "2"],
                                [ProfilerActivity.CPU], report)
    finally:
        mp.undo()
    assert rc == 0
    return work, report, spans


def test_span_off_records_nothing():
    """No profiler running: every span is the one shared no-op, and a
    profiler started afterwards holds none of its names."""
    assert not torch.autograd.profiler._is_profiler_enabled
    first, second = profiler.span("off.a"), profiler.span("off.b", 7)
    assert first is second is profiler._OFF
    with first:
        torch.ones(2) + 1
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        torch.ones(2) + 1
    assert not [e for e in prof.events() if e.name.startswith("streamz.")]


def test_span_is_a_cpu_op_nested_in_its_phase():
    """Each span is a CPU event named ``streamz.<name>``, not a user
    annotation; a span inside a phase is its child; its argument is
    recorded where the profiler records shapes; the phase still counts
    its seconds."""
    timer = profiler.PhaseTimer("cpu")
    with profile(activities=[ProfilerActivity.CPU], record_shapes=True) as prof:
        with timer.phase("outer"):
            with profiler.span("outer.inner", 5):
                torch.ones(4) * 2
    spans = _streamz(prof)
    assert set(spans) == {"outer", "outer.inner"}
    (outer,), (inner,) = spans["outer"], spans["outer.inner"]
    for e in (outer, inner):
        assert e.device_type == DeviceType.CPU and not e.is_user_annotation
    assert inner.cpu_parent is not None and inner.cpu_parent.name == "streamz.outer"
    assert outer.time_range.start <= inner.time_range.start
    assert inner.time_range.end <= outer.time_range.end
    assert list(inner.concrete_inputs) == [5]
    assert set(timer.phases) == {"outer"} and timer.phases["outer"] > 0


def test_default_run_spans(trained):
    """A default run yields every phase and every span under them, each
    nested in its phase, one ``discovery.file`` per file with its index,
    and the phases of ``phase_seconds`` as before."""
    _, report, spans = trained
    assert DEFAULT_RUN_SPANS <= set(spans), DEFAULT_RUN_SPANS - set(spans)
    assert set(report["phase_seconds"]) == {"ingest", "features", "corpus", "discovery",
                                            "finalize"}
    parents = {"features": "features", "corpus": "corpus", "discovery": "discovery",
               "train": "discovery", "finalize": "finalize"}
    for name, events in spans.items():
        if "." not in name:
            assert len(events) == 1, name
            continue
        (phase,) = spans[parents[name.split(".")[0]]]
        for e in events:
            assert phase.time_range.start <= e.time_range.start, name
            assert e.time_range.end <= phase.time_range.end, name
    files = spans["discovery.file"]
    assert sorted(int(e.concrete_inputs[0]) for e in files) == list(range(6))
    assert len(spans["train.draws"]) == 6
    assert len(spans["corpus.draws"]) >= 1


def test_identify_phases_and_profile_report(trained, capsys, monkeypatch):
    """``--identify`` times ``load``, ``embed`` and ``gate`` beside ingest
    and features, each a span; ``--profile dir`` prints the phase report
    after the verdict lines and writes a trace, the rest of the output as
    without it."""
    work = trained[0]
    monkeypatch.chdir(work)
    paths = ["c3_s0.wav", "c4_s1.wav"]
    capsys.readouterr()
    report = {}
    rc, spans = _traced_cli(["--device", "cpu", "--identify", *paths],
                            [ProfilerActivity.CPU], report)
    plain = capsys.readouterr().out
    assert rc == 0
    phases = {"load", "ingest", "features", "embed", "gate"}
    assert set(report["phase_seconds"]) == phases
    assert phases <= set(spans)
    assert "Phase timing:" not in plain
    report = {}
    assert cli.main(["--device", "cpu", "--identify", *paths, "--profile", "traces"],
                    report=report) == 0
    out = capsys.readouterr().out
    assert set(report["phase_seconds"]) == phases
    before, after = out.split("Phase timing:")
    assert before == plain
    for name in (*phases, "total"):
        assert re.search(rf"^  {name} +\d+\.\d{{3}}s", after, re.M), name
    traces = list((work / "traces").iterdir())
    assert len(traces) == 1 and traces[0].name.endswith(".pt.trace.json")
    assert "streamz.embed" in traces[0].read_text()


@pytest.mark.parametrize("rates,resampled", [([16000, 16000, 44100], 2),
                                             ([44100, 44100, 44100], 0)])
def test_ingest_resample_span_counts_the_resampled_clips(tmp_path, rates, resampled):
    """The native ingest's second pass, downmix and resample, is the span
    ``ingest.resample``, its argument the number of clips it resamples; a
    batch with none to resample skips the pass and opens no span."""
    assert native.available(), native.unavailable_reason
    rng = np.random.default_rng(resampled)
    paths = [str(tmp_path / "missing.wav")]
    for i, rate in enumerate(rates):
        paths.append(str(tmp_path / f"r{i}.wav"))
        wav.write_wav(paths[-1], _voice(rng, *SPEAKERS[i], seconds=0.5, rate=rate), rate)
    with profile(activities=[ProfilerActivity.CPU], record_shapes=True) as prof:
        out = audio.batch_resample(paths)
    assert [p for p, _ in out] == paths[1:]
    spans = _streamz(prof)
    if resampled:
        (span,) = spans["ingest.resample"]
        assert list(span.concrete_inputs) == [resampled]
    else:
        assert "ingest.resample" not in spans


@pytest.mark.cuda
def test_spans_cast_no_shadow_on_the_device(tmp_path, monkeypatch):
    """A default run on the card traced with CUDA activity: its spans are
    CPU events, and no CUDA-typed event carries a ``streamz.`` name."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    monkeypatch.chdir(_corpus(tmp_path))
    monkeypatch.setenv("STREAMZ_NO_AUTOTUNE", "1")
    monkeypatch.setenv("STREAMZ_AUTOTUNE_CACHE", str(tmp_path / "autotune.json"))
    monkeypatch.setattr(drivers, "_key_counter", [0])
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        assert cli.main(["--burn-in-limit", "2"]) == 0
        torch.cuda.synchronize()
    events = prof.events()
    assert any(e.device_type == DeviceType.CUDA for e in events)
    shadows = [e.name for e in events
               if e.device_type == DeviceType.CUDA and e.name.startswith("streamz.")]
    assert shadows == []
    spans = {e.name[len("streamz."):] for e in events if e.name.startswith("streamz.")}
    assert DEFAULT_RUN_SPANS <= spans, DEFAULT_RUN_SPANS - spans
