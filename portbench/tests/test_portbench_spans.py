"""The readers of the program's spans and phases on hand-made traces: their
values, None where the program recorded nothing, and the device operations
counted only inside their span."""

import pytest

from portbench import harness, spans

TRAIN = {"corpus_draws_s.train", "draws_ms_per_file.train", "discovery_ops_per_file.train",
         "features_pack_ms_per_clip.train", "features_upload_ms_per_clip.train"}
IDENTIFY = {"load_ms_per_clip.identify", "embed_ms_per_clip.identify",
            "gate_ms_per_clip.identify", "features_pack_ms_per_clip.identify",
            "features_upload_ms_per_clip.identify"}


def _trace(host_ops, ops=(), bounds=(10.0, 20.0)):
    return harness.Trace(list(ops), [("window", bounds[0], bounds[1] - bounds[0])],
                         list(host_ops), bounds[1] - bounds[0], 0.0, bounds)


def _train_run():
    """Two default runs of 4 clips: the discovery phase of each, with
    operations before, inside and after it; the draws; the features."""
    host = [("streamz.discovery", 11.0, 1.0), ("streamz.discovery", 15.0, 1.0),
            ("streamz.corpus.draws", 10.5, 0.25), ("streamz.corpus.draws", 14.5, 0.5),
            ("streamz.features.pack", 10.1, 0.004), ("streamz.features.pack", 14.1, 0.004),
            ("streamz.features.upload", 10.2, 0.002), ("aten::copy_", 11.2, 0.5)]
    host += [("streamz.train.draws", 11.0 + 0.1 * k, 0.001) for k in range(8)]
    # one before the window: not counted
    host += [("streamz.train.draws", 9.0, 5.0), ("streamz.features.upload", 9.5, 0.3)]
    ops = ([("k", 10.9, 0.01)] + [("k", 11.0 + 0.1 * k, 0.01) for k in range(10)]
           + [("k", 16.5, 0.01), ("k", 15.5, 0.01)])
    units = [{"clips": 4, "phase_seconds": {"discovery": 1.0}} for _ in range(2)]
    return harness.Run("ref8-train", units=units, trace=_trace(host, ops))


def _identify_run():
    units = [{"clips": 64, "phase_seconds": {"load": 0.32, "embed": 0.016, "gate": 0.0064,
                                             "ingest": 1.0, "features": 0.2}},
             {"clips": 32, "phase_seconds": {"load": 0.16, "embed": 0.008, "gate": 0.0032,
                                             "ingest": 0.5, "features": 0.1}}]
    host = [("streamz.features.pack", 11.0, 0.048), ("streamz.features.upload", 11.1, 0.096),
            ("streamz.features.pack", 12.0, 0.048)]
    return harness.Run("ref8-identify", units=units, trace=_trace(host))


def _read(name, run):
    return harness.load_reader(name)(run)


def test_train_readers():
    run = _train_run()
    assert _read("corpus_draws_s.train", run) == pytest.approx(0.375)
    assert _read("draws_ms_per_file.train", run) == pytest.approx(1.0)
    assert _read("features_pack_ms_per_clip.train", run) == pytest.approx(1.0)
    assert _read("features_upload_ms_per_clip.train", run) == pytest.approx(0.25)
    # 10 operations start in the first discovery range, 1 in the second;
    # those at 10.9 and 16.5 lie outside both: 11 over 8 files.
    assert _read("discovery_ops_per_file.train", run) == pytest.approx(11 / 8)
    run.trace.ops = []  # a trace without a device: no count, not 0
    assert _read("discovery_ops_per_file.train", run) is None


def test_identify_readers():
    run = _identify_run()
    assert _read("load_ms_per_clip.identify", run) == pytest.approx(5.0)
    assert _read("embed_ms_per_clip.identify", run) == pytest.approx(0.25)
    assert _read("gate_ms_per_clip.identify", run) == pytest.approx(0.1)
    assert _read("features_pack_ms_per_clip.identify", run) == pytest.approx(1.0)
    assert _read("features_upload_ms_per_clip.identify", run) == pytest.approx(1.0)


@pytest.mark.parametrize("name", sorted(TRAIN | IDENTIFY))
def test_none_where_the_program_recorded_nothing(name):
    """A program without spans or phases (one older than them), or no
    trace at all, reads None and never 0."""
    units = [{"clips": 64, "phase_seconds": {"ingest": 1.0, "features": 0.2}}]
    bare = harness.Run("x", units=units,
                       trace=_trace([("aten::copy_", 11.0, 0.1)], [("k", 11.0, 0.1)]))
    assert _read(name, bare) is None
    assert _read(name, harness.Run("x", units=units)) is None


def test_ranges_keep_the_window_and_the_exact_name():
    run = harness.Run("x", units=[{"clips": 1}], trace=_trace(
        [("streamz.features.pack", 12.0, 1.0), ("streamz.features.pack.more", 13.0, 1.0),
         ("portbench.features.pack", 14.0, 1.0), ("streamz.features.pack", 19.5, 1.0)]))
    assert spans.ranges(run, "features.pack") == [(12.0, 13.0)]
    assert spans.seconds(run, "features.pack") == 1.0
    assert spans.seconds(run, "corpus.draws") is None


def test_every_new_reader_is_in_the_manifest_for_its_cells():
    by_name = {m["name"]: m for m in harness.manifest()["per_layer"]}
    for name in TRAIN:
        assert by_name[name]["workloads"] == ["ref8-train"]
    for name in IDENTIFY:
        assert by_name[name]["workloads"] == ["vox1251-identify", "ref8-identify"]
