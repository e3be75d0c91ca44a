"""What the drivers share around the program: its builds, its entry point
with its output captured, and the hooks that keep what it produced."""

from __future__ import annotations

import contextlib
import io
import os
import sys
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path
from typing import Dict, List, Tuple

_ORIGINAL: Dict[tuple, object] = {}


def original(module, name: str):
    """The program's own function, also once a hook has replaced it."""
    return _ORIGINAL.setdefault((module.__name__, name), getattr(module, name))


def build(kernels: List[str]) -> None:
    """The program's kernels and its native ingest library, built at once
    into the checkout (a no-op once built there)."""
    from streamz_tpu_torch import _cuda_build
    from streamz_tpu_torch.io import native

    with ThreadPoolExecutor(max_workers=1) as pool:
        lib = pool.submit(native.load)
        if kernels:
            _cuda_build.build_all(kernels)
    if lib.result() is None:
        raise RuntimeError(f"native ingest did not build: {native.unavailable_reason}")


def run_cli(argv: List[str], cwd: Path) -> Tuple[int, dict, List[str]]:
    """``streamz_tpu_torch.cli.main(argv)`` in ``cwd``: (exit code, its
    report, its standard output's lines).  Its standard error is shown only
    when it fails."""
    from streamz_tpu_torch import cli

    report: dict = {}
    out, err = io.StringIO(), io.StringIO()
    here = os.getcwd()
    os.chdir(cwd)
    try:
        with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
            rc = cli.main(list(argv), report=report)
    finally:
        os.chdir(here)
    if rc != 0:
        print(err.getvalue()[-2000:], file=sys.stderr)
    return rc, report, out.getvalue().splitlines()


def frontend_choice() -> str:
    """The frontend the program's probe chose in this process."""
    from streamz_tpu_torch.runtime import autotune

    return str(autotune._memory.get(autotune._key("frontend"), "not probed"))
