"""The manifest, configurations, workloads, drivers and per-layer metrics
load by name, and their names and units keep to the allowed characters."""

import json
import re

import pytest

from portbench import harness

MAN = harness.manifest()
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def test_manifest_keys_and_limits():
    assert set(MAN) == {"command", "paths", "run_seconds", "configs", "workloads",
                        "end_to_end", "per_layer"}
    assert MAN["command"] == ["python3", "portbench/run.py"]
    assert MAN["paths"] == ["portbench"]
    assert 1 <= MAN["run_seconds"] <= 51
    assert len(json.dumps(MAN)) <= 64 * 1024
    assert any(m["name"] == "setup_s" and m["bound"] <= 0.25 for m in MAN["end_to_end"])


def test_names_units_and_one_line_texts():
    names = []
    for group in ("configs", "workloads", "end_to_end", "per_layer"):
        for e in MAN[group]:
            assert NAME.match(e["name"]), e["name"]
            names.append((group, e["name"]))
            for key in ("why", "layer", "source"):
                if key in e and group in ("configs", "workloads", "per_layer"):
                    assert 1 <= len(e[key]) <= 200 and "\n" not in e[key] and "\t" not in e[key]
            if "unit" in e:
                assert UNIT.match(e["unit"]), e["unit"]
                assert e["better"] in ("lower", "higher")
    assert len(names) == len(set(names))
    for c in MAN["configs"]:
        assert all(NAME.match(k) for k in c["reduced"]) and len(c["reduced"]) <= 16
    for w in MAN["workloads"]:
        assert NAME.match(w["config"]) and NAME.match(w["traffic"]) and w["chips"] in (1, 4)


@pytest.mark.parametrize("cell", [w["name"] for w in MAN["workloads"]])
def test_every_cell_loads_its_pieces(cell):
    c = harness.load_cell(cell)
    assert c.workload["config"] == next(w["config"] for w in MAN["workloads"]
                                        if w["name"] == cell)
    driver = harness.load_driver(c.workload["driver"])
    for fn in ("setup", "window", "end_to_end", "check", "control"):
        assert callable(getattr(driver, fn))
    e2e = {m["name"] for m in c.end_to_end}
    assert "setup_s" in e2e and len(e2e) >= 2
    assert c.per_layer, "every cell reports a per-layer metric"
    for m in c.per_layer:
        assert m["moves"] in e2e, (m["name"], m["moves"])
        assert callable(harness.load_reader(m["name"]))
    assert set(c.workload["limits"]) and all(v >= 0 for v in c.workload["limits"].values())


def test_every_config_is_used_and_in_its_file():
    used = {w["config"] for w in MAN["workloads"]}
    files = set()
    for c in MAN["configs"]:
        assert c["name"] in used
        assert c["file"].startswith("portbench/configs/") and c["file"] not in files
        files.add(c["file"])
        body = json.loads((harness.ROOT / c["file"]).read_text())
        assert body["name"] == c["name"] and body["reduced"] == c["reduced"]


def test_layers_are_named_alike():
    by_metric_family = {}
    for m in MAN["per_layer"]:
        assert 1 <= len(m["layer"]) <= 200
        by_metric_family.setdefault(m["name"].split(".")[0], set()).add(m["layer"])
    assert all(len(v) == 1 for v in by_metric_family.values())
