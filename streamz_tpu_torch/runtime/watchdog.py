"""Host-thread stall watchdog: the port's copy of
``streamz_tpu/runtime/watchdog.py``.

The reference runs a deadlock-detector thread polling parking_lot every 2 s
(``streamz-rs/src/main.rs:328-342``).  The SPMD rebuild has no lock-based
sharing to deadlock (SURVEY.md §5.2), so the only stall surface left is the
*host* ingest pool (native batch decode / Python thread pool).  This watchdog
wraps those phases: a daemon thread prints a diagnostic if a phase exceeds its
deadline, instead of the program hanging silently.
"""

from __future__ import annotations

import contextlib
import sys
import threading
import traceback
from typing import Iterator


@contextlib.contextmanager
def watchdog(phase: str, timeout_s: float = 300.0) -> Iterator[None]:
    """Print all thread stacks if ``phase`` runs longer than ``timeout_s``."""
    done = threading.Event()

    def _watch() -> None:
        if not done.wait(timeout_s):
            print(
                f"[watchdog] phase '{phase}' still running after "
                f"{timeout_s:.0f}s; thread stacks:",
                file=sys.stderr,
            )
            for tid, frame in sys._current_frames().items():
                print(f"[watchdog] thread {tid}:", file=sys.stderr)
                traceback.print_stack(frame, file=sys.stderr)

    t = threading.Thread(target=_watch, daemon=True)
    t.start()
    try:
        yield
    finally:
        done.set()
