"""Package rules of the PyTorch/CUDA port (streamz_tpu_torch).

It imports neither ``jax`` nor anything of ``streamz_tpu``; its entry points
run on CUDA unless the CPU is asked for, and never fall back quietly; the
kernel source names the TPU kernel it replaces.
"""

import ast
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
PKG = ROOT / "streamz_tpu_torch"
MODULES = sorted(PKG.rglob("*.py"))


def _imported_names(path: Path):
    tree = ast.parse(path.read_text(encoding="utf-8"), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name
        elif isinstance(node, ast.ImportFrom) and node.module and node.level == 0:
            yield node.module


def _forbidden(name: str) -> bool:
    top = name.split(".")[0]
    return top in ("jax", "jaxlib", "streamz_tpu")


@pytest.mark.parametrize("path", MODULES, ids=lambda p: str(p.relative_to(ROOT)))
def test_module_imports_no_jax_and_no_reference_package(path):
    bad = [n for n in _imported_names(path) if _forbidden(n)]
    assert not bad, f"{path.relative_to(ROOT)} imports {bad}"


@pytest.mark.parametrize("module", [
    "runtime/watchdog.py", "runtime/profiler.py", "app/evaluate.py",
    "app/embedquality.py", "infer/cluster.py", "stego/codec.py", "dsp/augment.py",
    "nn/drivers.py", "io/g711.py", "app/stream.py", "app/serve.py", "app/server.py",
    "app/fleet.py", "io/native.py", "runtime/procs.py", "runtime/measure.py",
    "parallel/comm.py", "parallel/mesh.py", "parallel/data_parallel.py",
    "parallel/window_parallel.py",
])
def test_ported_modules_are_scanned_and_name_their_reference(module):
    """The modules ported from the JAX package are among those the import
    rules scan, and each names the module it ports."""
    path = PKG / module
    assert path in MODULES
    assert f"streamz_tpu/{module}" in path.read_text(encoding="utf-8")


def test_importing_every_module_loads_no_jax():
    """A fresh interpreter imports every port module; jax and streamz_tpu
    stay out of sys.modules."""
    mods = [
        ".".join(p.relative_to(ROOT).with_suffix("").parts).replace(".__init__", "")
        for p in MODULES
    ]
    code = (
        "import importlib, sys\n"
        f"for m in {mods!r}:\n"
        "    importlib.import_module(m)\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'streamz_tpu'))\n"
        "print('BAD', bad)\n"
        "sys.exit(1 if bad else 0)\n"
    )
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, cwd=str(ROOT), env=env, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr


def test_auto_frontend_on_cpu_uses_plain_path():
    """'auto' on the CPU is the plain formulation; K1's wrapper on a CPU
    tensor runs K1's plain version and counts no launch."""
    from streamz_tpu_torch.dsp import features, mfcc, mfcc_kernel

    assert features.FeatureExtractor(device="cpu").resolved() == "plain"
    assert features.frontend_core("plain") is mfcc.mfcc_features
    pcm = torch.from_numpy(
        np.random.default_rng(0).normal(0, 0.1, (2, 4000)).astype(np.float32))
    before = mfcc_kernel.mfcc_base_v4.launches
    np.testing.assert_array_equal(
        mfcc_kernel.mfcc_base_v4(pcm).numpy(),
        mfcc_kernel.mfcc_base_bf16x3_plain(pcm, True, tail_fold=True).numpy())
    assert mfcc_kernel.mfcc_base_v4.launches == before


def test_cuda_request_without_card_raises(monkeypatch):
    """Entry points default to CUDA and raise without a card instead of
    running on the CPU."""
    from streamz_tpu_torch.device import resolve_device
    from streamz_tpu_torch.dsp import mfcc
    from streamz_tpu_torch.dsp.features import FeatureExtractor
    from streamz_tpu_torch.nn import checkpoint, model

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for call in (
        lambda: resolve_device(None),
        lambda: resolve_device("cuda"),
        lambda: FeatureExtractor(),
        lambda: mfcc.extract_features_batch([np.zeros(2000, np.int16)]),
        lambda: model.init_params(60, 8, 4, 1),
        lambda: checkpoint.load(str(ROOT / "tests" / "fixtures" / "golden_model.npz")),
    ):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            call()
    assert resolve_device("cpu").type == "cpu"
    with pytest.raises(ValueError):
        resolve_device("meta")


def test_kernel_wrapper_rejects_bad_input():
    from streamz_tpu_torch.dsp import mfcc_kernel

    with pytest.raises(ValueError):
        mfcc_kernel.mfcc_base_v4(torch.zeros((2, 4000), device="meta"))


def test_kernel_source_names_what_it_replaces():
    from streamz_tpu_torch.dsp import mfcc_kernel

    src = mfcc_kernel.SOURCE
    assert src == PKG / "csrc" / "mfcc_base.cu" and src.exists()
    text = src.read_text(encoding="utf-8")
    assert "streamz_tpu/dsp/pallas_mfcc.py:_mfcc_kernel_v4" in text
    assert "__global__" in text and 'extern "C"' in text
    assert "arch=compute_90a,code=sm_90a" in " ".join(mfcc_kernel.NVCC_FLAGS)
    for lib in ("cublas", "cudnn", "cufft"):
        assert lib not in text.lower()
    assert mfcc_kernel.BUILD_DIR == PKG / "_build"
    ignored = (ROOT / ".gitignore").read_text().split()
    assert "streamz_tpu_torch/_build/" in ignored


@pytest.mark.parametrize("name,replaces", [
    ("corpus_grads", "streamz_tpu/nn/pallas_train.py:_train_kernel"),
    ("file_train", "streamz_tpu/nn/pallas_train.py:_file_train_kernel"),
])
def test_training_kernel_sources_name_what_they_replace(name, replaces):
    from streamz_tpu_torch import _cuda_build

    text = _cuda_build.source(name).read_text(encoding="utf-8")
    assert replaces in text
    assert "__global__" in text and 'extern "C"' in text
    assert "atomicAdd" not in text  # the sums run in a fixed order
    for lib in ("cublas", "cudnn", "cutlass"):
        assert lib not in text.lower()


@pytest.mark.parametrize("name,replaces,wrapper", [
    ("mfcc_v3", "streamz_tpu/dsp/pallas_mfcc.py:_mfcc_kernel_v3", "dsp.mfcc_kernel.mfcc_base_v3"),
    ("mfcc_v2", "streamz_tpu/dsp/pallas_mfcc.py:_mfcc_kernel_v2", "dsp.mfcc_kernel.mfcc_base_v2"),
    ("mfcc_frames", "streamz_tpu/dsp/pallas_mfcc.py:_mfcc_kernel", "dsp.mfcc_kernel.mfcc_base_frames"),
    ("forward_probs", "streamz_tpu/nn/pallas_forward.py:_fwd_kernel",
     "nn.forward_kernel.forward_probs_k7"),
])
def test_frontend_and_forward_kernel_sources_name_what_they_replace(name, replaces, wrapper):
    """K2, K3, K4 and K7: hand-written kernels with a plain C entry, no
    library kernel for their product, and a wrapper that counts launches."""
    import importlib

    from streamz_tpu_torch import _cuda_build

    text = _cuda_build.source(name).read_text(encoding="utf-8")
    assert replaces in text
    assert "__global__" in text and 'extern "C"' in text
    for lib in ("cublas", "cudnn", "cufft", "cutlass"):
        assert lib not in text.lower()
    mod, fn = wrapper.rsplit(".", 1)
    assert isinstance(getattr(importlib.import_module(f"streamz_tpu_torch.{mod}"), fn).launches, int)


def test_training_entry_points_need_a_card_or_the_cpu(monkeypatch, tmp_path):
    """The default run on CUDA without a card fails with rc 1 and writes
    nothing; the kernels' wrappers take CPU tensors through their plain
    versions without counting a launch."""
    from streamz_tpu_torch import cli
    from streamz_tpu_torch.nn import model, train_kernels as tk

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.chdir(tmp_path)
    (tmp_path / "train_files.txt").write_text("a.wav,0\n")
    assert cli.main([]) == 1
    assert not (tmp_path / "model.npz").exists()
    params = model.init_params(60, 32, 16, 2, device="cpu")
    before = (tk.corpus_grads_k5.launches, tk.train_windows_k6.launches)
    tk.corpus_grads_k5(params, torch.zeros(4, 60), torch.zeros(4, dtype=torch.int32),
                       torch.ones(4), 2)
    tk.train_windows_k6(params, torch.zeros(1, 8, 60), torch.ones(1, 8),
                        torch.zeros(128), 2, 0.05)
    assert (tk.corpus_grads_k5.launches, tk.train_windows_k6.launches) == before
    with pytest.raises(ValueError):
        tk.corpus_grads_k5(params, torch.zeros((4, 60), device="meta"),
                           torch.zeros(4, dtype=torch.int32), torch.ones(4), 2)


@pytest.mark.parametrize("script", ["tc_tile_profile.py", "k7_profile.py"])
def test_profile_scripts_edit_the_sources_they_measure(script):
    """The card's measurement scripts build copies of a kernel source with
    text edits: each edit's anchor occurs once in today's source, and the
    scripts, like the package, import no jax."""
    import importlib.util

    path = ROOT / script
    assert not [m for m in _imported_names(path) if _forbidden(m)]
    spec = importlib.util.spec_from_file_location(path.stem, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    if script == "tc_tile_profile.py":
        edits = [mod.CLOCKS, mod.CLUSTER1, mod.CLUSTER4]
    else:
        edits = list(mod.VARIANTS.values()) + [mod.CLOCKS]
    for e in edits:
        assert mod.edited(e)
