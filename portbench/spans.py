"""Reductions over the program's own spans in a traced window, which the
per-layer readers (``layer_metrics/``) share.

The program records a host range named ``streamz.<name>`` at each of its
layer boundaries while ``torch.profiler`` runs
(``streamz_tpu_torch.runtime.profiler.span``; every ``PhaseTimer`` phase is
one too), and ``harness.summarize_profile`` keeps them among the trace's
``host_ops``.  A program without a span reads None here, never 0.
"""

from __future__ import annotations

from typing import List, Optional, Tuple

PREFIX = "streamz."


def ranges(run, name: str) -> List[Tuple[float, float]]:
    """(start, end) in seconds of each ``streamz.<name>`` range inside the
    trace's bounds."""
    if run.trace is None:
        return []
    lo, hi = run.trace.bounds
    full = PREFIX + name
    return [(s, s + d) for n, s, d in run.trace.host_ops
            if n == full and lo <= s and s + d <= hi]


def seconds(run, name: str) -> Optional[float]:
    """Seconds of the span over the traced window, None where it is absent."""
    found = ranges(run, name)
    return sum(e - s for s, e in found) if found else None


def per_unit(run, name: str) -> Optional[float]:
    """Seconds of the span per unit (default run or ``--identify`` batch)."""
    secs = seconds(run, name)
    return None if secs is None or not run.units else secs / len(run.units)


def ms_per_clip(run, name: str) -> Optional[float]:
    """Milliseconds of the span per clip of the units."""
    secs = seconds(run, name)
    clips = sum(u["clips"] for u in run.units)
    return None if secs is None or clips == 0 else 1e3 * secs / clips


def ops_per_clip(run, name: str) -> Optional[float]:
    """Device operations that start inside the span, per clip of the units;
    None for a trace that holds no device operation at all."""
    found = ranges(run, name)
    clips = sum(u["clips"] for u in run.units)
    if not found or clips == 0 or not run.trace.ops:
        return None
    n = sum(1 for _, t, _ in run.trace.ops if any(s <= t <= e for s, e in found))
    return n / clips
