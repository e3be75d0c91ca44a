"""Per-phase timing and tracing: the port of ``streamz_tpu/runtime/profiler.py``.

The reference has no profiling at all (SURVEY.md §5.1; its only
observability is indicatif progress bars).

- :func:`span`: a host range named ``streamz.<name>`` in the running
  ``torch.profiler``, at the layer boundaries inside a phase; with no
  profiler running it costs one flag check;
- :class:`PhaseTimer`: wall-clock seconds per phase of the CLI (ingest,
  features, corpus, stego, discovery, finalize, eval; load, embed and gate
  under ``--identify``), each phase ending in a device synchronisation on a
  card, so that a phase's time holds its own device work and none of the
  phase before; each phase is also a span of its name;
- :func:`trace`: ``torch.profiler`` over a region, CPU activity plus CUDA
  activity on a card, written into a directory as a TensorBoard-loadable
  trace when one is given.

Enabled from the CLI with ``--profile [dir]``.
"""

from __future__ import annotations

import contextlib
import time
from typing import Dict, Iterator, Optional

import torch
import torch.autograd.profiler as _autograd_profiler

_OFF = contextlib.nullcontext()


def span(name: str, *args):
    """A context manager that records a host range named ``streamz.<name>``
    into the running ``torch.profiler``, ``args`` as its inputs (kept where
    the profiler records shapes: the item's index, where the span belongs
    to one item of a loop), and does nothing else.

    The range is a CPU operation, not a user annotation:
    ``record_function``'s annotations get a CUDA-typed shadow on the
    device timeline under CUDA activity, which a reader of the trace would
    count as device work.  With no profiler running the call costs one
    flag check and returns a shared no-op."""
    if not _autograd_profiler._is_profiler_enabled:
        return _OFF
    if args:
        return torch._C._profiler._RecordFunctionFast("streamz." + name, args)
    return torch._C._profiler._RecordFunctionFast("streamz." + name)


class PhaseTimer:
    """Seconds per named phase; a phase entered twice adds up."""

    def __init__(self, device: "torch.device | None" = None) -> None:
        self.phases: Dict[str, float] = {}
        self._cuda = device is not None and torch.device(device).type == "cuda"

    def _sync(self) -> None:
        if self._cuda:
            torch.cuda.synchronize()

    @contextlib.contextmanager
    def phase(self, name: str) -> Iterator[None]:
        """Times the block, between a synchronisation before it and one
        after it; the span of the same name covers the time counted, the
        closing synchronisation included."""
        self._sync()
        start = time.perf_counter()
        with span(name):
            try:
                yield
            finally:
                self._sync()
                self.phases[name] = self.phases.get(name, 0.0) + (
                    time.perf_counter() - start
                )

    def report(self) -> str:
        total = sum(self.phases.values())
        lines = ["Phase timing:"]
        for name, secs in sorted(self.phases.items(), key=lambda kv: -kv[1]):
            pct = 100.0 * secs / total if total else 0.0
            lines.append(f"  {name:<20} {secs:8.3f}s  {pct:5.1f}%")
        lines.append(f"  {'total':<20} {total:8.3f}s")
        return "\n".join(lines)


@contextlib.contextmanager
def trace(trace_dir: Optional[str],
          device: "torch.device | None" = None) -> Iterator[None]:
    """``torch.profiler`` over the region when ``trace_dir`` is set, with
    CUDA activity when ``device`` is a card; on exit the trace is written
    into ``trace_dir`` (``<host>_<pid>.<time>.pt.trace.json``).  A no-op
    without ``trace_dir``."""
    if not trace_dir:
        yield
        return
    from torch.profiler import ProfilerActivity, profile, tensorboard_trace_handler

    activities = [ProfilerActivity.CPU]
    if device is not None and torch.device(device).type == "cuda":
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities,
                 on_trace_ready=tensorboard_trace_handler(trace_dir)):
        yield
