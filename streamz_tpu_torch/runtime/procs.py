"""Wedge-proof subprocess execution for device probes.

The port's copy of ``streamz_tpu/runtime/procs.py``.  A process blocked on
a wedged device sits in uninterruptible (D-state) sleep where SIGKILL does
not take: its pipes never reach EOF and ``subprocess.run``'s post-kill
``wait()`` blocks the parent forever.  The one pattern that survives this,
used by :func:`streamz_tpu_torch.runtime.measure.wait_device_healthy`:

- pipe-free I/O (DEVNULL, or unlinked temp files when output is needed);
- a bounded ``wait`` for the child;
- ``kill`` then a short bounded grace, then ABANDON the child if it still
  will not die (it exits on its own when the device recovers; the temp
  files are already unlinked).
"""

from __future__ import annotations

import subprocess
import sys
import tempfile
from typing import List, Optional, Tuple


def run_abandonable(
    cmd: List[str],
    timeout: float,
    *,
    env: Optional[dict] = None,
    capture: bool = False,
    kill_grace: float = 5.0,
) -> Tuple[Optional[int], bool, str, str]:
    """Run ``cmd``; return ``(rc, timed_out, stdout, stderr)``.

    ``rc`` is ``None`` when the child timed out (and was killed/abandoned)
    or could not be spawned.  Output is only collected with ``capture=True``
    (decoded with ``errors='replace'`` — a SIGKILL mid-multibyte-character
    must not take down the caller's retry loop).
    """
    timed_out = False
    rc: Optional[int] = None
    out = err = ""
    fo = fe = None
    try:
        if capture:
            fo = tempfile.TemporaryFile("w+b")
            fe = tempfile.TemporaryFile("w+b")
            stdout, stderr = fo, fe
        else:
            stdout = stderr = subprocess.DEVNULL
        try:
            proc = subprocess.Popen(cmd, stdout=stdout, stderr=stderr, env=env)
        except Exception as e:
            return None, False, "", f"spawn failed: {e}"
        try:
            rc = proc.wait(timeout=timeout)
        except subprocess.TimeoutExpired:
            timed_out = True
            proc.kill()
            try:
                proc.wait(timeout=kill_grace)
            except subprocess.TimeoutExpired:
                pass  # D-state: abandon it
        if capture:
            for f, attr in ((fo, "out"), (fe, "err")):
                try:
                    f.seek(0)
                    text = f.read().decode("utf-8", errors="replace")
                except Exception:
                    text = ""
                if attr == "out":
                    out = text
                else:
                    err = text
        return rc, timed_out, out, err
    finally:
        for f in (fo, fe):
            if f is not None:
                try:
                    f.close()
                except Exception:
                    pass


def probe_ok(code: str, timeout: float, env: Optional[dict] = None) -> bool:
    """Run a python snippet silently; True iff it exits 0 within ``timeout``."""
    rc, _, _, _ = run_abandonable(
        [sys.executable, "-c", code], timeout, env=env, capture=False,
    )
    return rc == 0
