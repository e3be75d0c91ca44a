"""Build and load the port's hand-written CUDA kernels.

Each kernel source ``csrc/<name>.cu`` is compiled by ``nvcc`` for
``sm_90a`` into a shared library with a plain C interface, at first use,
into the gitignored ``streamz_tpu_torch/_build/``, and loaded with
``ctypes``.  A library's name carries a hash of its source, the shared
headers (``csrc/*.cuh``), the flags and ``nvcc --version``, so a change to
any of them builds anew.  :func:`build_all` starts one ``nvcc`` per source,
all at once.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path
from typing import Callable, Dict, Iterable

PKG = Path(__file__).resolve().parent
SOURCE_DIR = PKG / "csrc"
BUILD_DIR = PKG / "_build"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_lock = threading.Lock()
_libs: Dict[str, ctypes.CDLL] = {}
build_logs: Dict[str, str] = {}  # the compiler's report per built source


def source(name: str) -> Path:
    return SOURCE_DIR / f"{name}.cu"


def nvcc() -> str:
    cand = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError(
            "nvcc not found: the CUDA kernels are compiled from csrc/ at "
            "first use; set CUDA_HOME to the CUDA toolkit"
        )
    return found


def source_hash(name: str) -> str:
    """A hash of what a kernel's library is built from, the compiler aside:
    ``csrc/<name>.cu``, the shared headers and the flags."""
    key = hashlib.sha256(source(name).read_bytes())
    for header in sorted(SOURCE_DIR.glob("*.cuh")):
        key.update(header.name.encode() + b"\0" + header.read_bytes())
    key.update("\0".join(NVCC_FLAGS).encode())
    return key.hexdigest()


def build(name: str) -> Path:
    """Compile ``csrc/<name>.cu`` unless the library built from this source,
    these headers, these flags and this ``nvcc`` exists."""
    compiler = nvcc()
    version = subprocess.run(
        [compiler, "--version"], capture_output=True, text=True, check=True
    ).stdout
    src = source(name)
    key = hashlib.sha256(f"{source_hash(name)}\0{version}".encode())
    lib = BUILD_DIR / f"lib{name}_{key.hexdigest()[:16]}.so"
    if lib.exists():
        return lib
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = lib.with_name(f"{lib.name}.{os.getpid()}.{threading.get_ident()}.tmp")
    cmd = [compiler, *NVCC_FLAGS, f"-I{SOURCE_DIR}", "-o", str(tmp), str(src)]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(
            f"nvcc failed ({proc.returncode}): {' '.join(cmd)}\n"
            f"{proc.stdout}{proc.stderr}"
        )
    build_logs[name] = proc.stdout + proc.stderr
    os.replace(tmp, lib)
    return lib


def build_all(names: Iterable[str]) -> Dict[str, Path]:
    """Build several sources at once, one ``nvcc`` process each."""
    names = list(names)
    with ThreadPoolExecutor(max_workers=max(1, len(names))) as pool:
        return dict(zip(names, pool.map(build, names)))


def load(name: str, declare: Callable[[ctypes.CDLL], None]) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu`` (built if needed);
    ``declare`` sets its functions' argument and result types once."""
    with _lock:
        if name not in _libs:
            lib = ctypes.CDLL(str(build(name)))
            declare(lib)
            _libs[name] = lib
        return _libs[name]
