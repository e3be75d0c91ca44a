"""No module under portbench/ imports JAX or the JAX package, compared by
whole top-level name; the plain reference imports nothing of the port."""

import ast
from pathlib import Path

import pytest

from portbench import harness

BENCH = harness.ROOT / "portbench"


def imported_roots(path: Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module.split(".")[0]
        elif isinstance(node, ast.Call) and getattr(node.func, "attr", "") == "import_module":
            if node.args and isinstance(node.args[0], ast.Constant):
                yield str(node.args[0].value).split(".")[0]


def scan(root: Path, forbidden):
    return sorted((str(p.relative_to(root)), m) for p in root.rglob("*.py")
                  if "_cache" not in p.parts for m in imported_roots(p) if m in forbidden)


def test_benchmark_imports_no_jax_nor_the_jax_package():
    assert scan(BENCH, harness.FORBIDDEN) == []


def test_reference_imports_nothing_of_the_port():
    assert scan(BENCH / "reference", (*harness.FORBIDDEN, harness.PROGRAM)) == []


@pytest.mark.parametrize("line,hit", [
    ("import jax\n", True), ("import jax.numpy as jnp\n", True),
    ("from streamz_tpu import cli\n", True), ("from streamz_tpu.dsp import mel\n", True),
    ("import streamz_tpu_torch\n", False), ("from streamz_tpu_torch.cli import main\n", False),
    ("import jaxtyping\n", False), ("import flax\n", True),
])
def test_the_scan_compares_whole_top_level_names(tmp_path, line, hit):
    (tmp_path / "m.py").write_text(line)
    assert bool(scan(tmp_path, harness.FORBIDDEN)) == hit


def test_the_reference_scan_rejects_the_port(tmp_path):
    (tmp_path / "m.py").write_text("from streamz_tpu_torch.nn import prng\n")
    assert scan(tmp_path, (*harness.FORBIDDEN, harness.PROGRAM))


def test_forbidden_modules_by_whole_name(monkeypatch):
    import sys
    import types

    monkeypatch.setitem(sys.modules, "streamz_tpu_torch_fake", types.ModuleType("x"))
    assert "streamz_tpu_torch_fake" not in harness.forbidden_modules()
    monkeypatch.setitem(sys.modules, "streamz_tpu.fake", types.ModuleType("x"))
    assert "streamz_tpu.fake" in harness.forbidden_modules()
