"""On the card, at each cell's own size: the program passes its check and
the control (the reference in TF32 in the program's place) fails it, on
three seeds.  Run with ``python -m pytest -m cuda portbench/tests`` on a
machine with an NVIDIA card; it skips elsewhere."""

import pytest

from portbench import control, harness

CELLS = [w["name"] for w in harness.manifest()["workloads"]]


@pytest.mark.cuda
@pytest.mark.parametrize("name", CELLS)
def test_the_control_fails_where_the_program_passes(name, tmp_path, monkeypatch):
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the control runs at the cell's own size")
    monkeypatch.setenv("TMPDIR", str(tmp_path))
    cell = harness.load_cell(name)
    limits = cell.workload["limits"]
    for i in range(3):
        got = control.readings(cell, 3_300_000_001 + 7919 * i, 2.0)
        assert got["failed"] == 0
        assert all(v <= limits[k] for k, v in got["program"].items()), got["program"]
        assert any(v > limits[k] for k, v in got["control"].items()), got["control"]
