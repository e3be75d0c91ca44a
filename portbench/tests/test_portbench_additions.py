"""A configuration, a cell and a per-layer metric added as new files (and
new entries in BENCHMARK.json) are found with no edit to any file the
benchmark already has."""

import hashlib
import json
import shutil

from portbench import harness


def _digests(root):
    return {p.relative_to(root): hashlib.sha256(p.read_bytes()).hexdigest()
            for p in (root / "portbench").rglob("*") if p.is_file()
            and "__pycache__" not in p.parts and "_cache" not in p.parts}


def test_new_config_cell_and_metric_are_found(tmp_path):
    root = tmp_path / "checkout"
    shutil.copytree(harness.ROOT / "portbench", root / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__", "_cache"))
    man = harness.manifest()
    before = _digests(root)

    conf = json.loads((root / "portbench/configs/streamz-ref-8spk.json").read_text())
    conf.update(name="streamz-ref-16spk", speakers=16)
    (root / "portbench/configs/streamz-ref-16spk.json").write_text(json.dumps(conf))
    wl = json.loads((root / "portbench/workloads/ref8-identify.json").read_text())
    wl.update(name="ref16-identify", config="streamz-ref-16spk")
    (root / "portbench/workloads/ref16-identify.json").write_text(json.dumps(wl))
    (root / "portbench/layer_metrics/clips_per_batch.identify.py").write_text(
        "def read(run):\n    return sum(u['clips'] for u in run.units) / len(run.units)\n")
    man["configs"].append({"name": "streamz-ref-16spk", "source": "x",
                           "file": "portbench/configs/streamz-ref-16spk.json",
                           "reduced": [], "why": "x"})
    man["workloads"].append({"name": "ref16-identify", "config": "streamz-ref-16spk",
                             "traffic": "identify_64x44k", "chips": 1, "why": "x"})
    for m in man["end_to_end"]:
        if m["name"] == "identify_clips_per_s":
            m["workloads"].append("ref16-identify")
    man["per_layer"].append({"name": "clips_per_batch.identify", "unit": "clips",
                             "better": "higher", "source": "host_clock", "layer": "x",
                             "moves": "identify_clips_per_s",
                             "workloads": ["ref16-identify"]})
    (root / "BENCHMARK.json").write_text(json.dumps(man))

    cell = harness.load_cell("ref16-identify", root)
    assert cell.config["speakers"] == 16
    assert harness.load_driver(cell.workload["driver"], root / "portbench").check
    assert "clips_per_batch.identify" in [m["name"] for m in cell.per_layer]
    read = harness.load_reader("clips_per_batch.identify", root / "portbench")
    assert read(harness.Run("ref16-identify", units=[{"clips": 64}, {"clips": 32}])) == 48
    after = _digests(root)
    assert all(after[k] == v for k, v in before.items())
