"""The reader of the native resampler's span: its value per clip, None
where the program recorded no such span, and its manifest entry."""

import pytest

from portbench import harness

NAME = "resample_ms_per_clip.identify"


def _run(host_ops):
    trace = harness.Trace([], [("window", 10.0, 10.0)], list(host_ops), 10.0, 0.0,
                          (10.0, 20.0))
    units = [{"clips": 64, "phase_seconds": {"ingest": 0.3}},
             {"clips": 32, "phase_seconds": {"ingest": 0.2}}]
    return harness.Run("vox1251-identify", units=units, trace=trace)


def test_reads_the_span_per_clip():
    # Two batches' passes in the window, one before it (not counted), and
    # the ingest phase around them (not this span).
    run = _run([("streamz.ingest.resample", 11.0, 0.128),
                ("streamz.ingest.resample", 15.0, 0.064),
                ("streamz.ingest.resample", 9.0, 0.5),
                ("streamz.ingest", 10.9, 0.3)])
    assert harness.load_reader(NAME)(run) == pytest.approx(2.0)


def test_none_without_the_span():
    """A 44.1 kHz batch, or a program older than the span, reads None."""
    read = harness.load_reader(NAME)
    assert read(_run([("streamz.ingest", 11.0, 0.3)])) is None
    assert read(harness.Run("x", units=[{"clips": 64}])) is None


def test_manifest_entry():
    (entry,) = [m for m in harness.manifest()["per_layer"] if m["name"] == NAME]
    assert entry == {"name": NAME, "unit": "ms", "better": "lower",
                     "source": "program_span", "layer": "CLI and host ingest",
                     "moves": "identify_clips_per_s", "workloads": ["vox1251-identify"]}
