"""Reductions that the per-layer readers (``layer_metrics/``) share.

A reader gets the run (``harness.Run``): its units (one default run, one
``--identify`` batch), each with its ``clips``, its
``phase_seconds`` (the program's ``PhaseTimer``: each phase ends in a
device synchronisation), its span (``start``, ``end``) and its ``work``
(``roofline.Work`` by part), and the trace of the traced window.  A
reader returns None where there is nothing to read: it never returns 0
for a share of a roofline or of a peak.
"""

from __future__ import annotations

from typing import Optional

from portbench import roofline

MFCC = r"mfcc_base_kernel|mfcc_v3_kernel"    # K1, or K2 where the probe chose it
K5 = r"\b(layer1_kernel|layer_kernel|softmax_kernel|grads_kernel|finish_kernel)\b"
K6 = r"file_train_kernel"


def phase_ms_per(run, phase: str, per: str = "clips") -> Optional[float]:
    """Milliseconds of ``phase`` per clip (or per ``per``) over the units."""
    secs = [u["phase_seconds"].get(phase) for u in run.units]
    if not run.units or any(s is None for s in secs):
        return None
    return 1e3 * sum(secs) / sum(u[per] for u in run.units)


def phase_s_per_unit(run, phase: str) -> Optional[float]:
    secs = [u["phase_seconds"].get(phase) for u in run.units]
    if not run.units or any(s is None for s in secs):
        return None
    return sum(secs) / len(secs)


def roofline_share(run, part: str, pattern: str) -> Optional[float]:
    """Percent: the least time of the units' ``part`` work over the traced
    time of the kernels matching ``pattern``."""
    if run.trace is None:
        return None
    secs, launches = run.trace.kernel_seconds(pattern)
    if launches == 0 or secs <= 0:
        return None
    least = sum(u["work"][part].seconds() for u in run.units if part in u["work"])
    return 100.0 * least / secs


def frontend_share(run) -> Optional[float]:
    """The MFCC kernel's share: K1's, or K2's where the probe chose it (the
    same function's work), over the time of whichever ran."""
    return roofline_share(run, "frontend", MFCC)


def idle(run) -> Optional[float]:
    """Percent of the traced window in which no device operation ran."""
    if run.trace is None or run.trace.window_s <= 0 or run.trace.busy_s <= 0:
        return None
    return 100.0 * (1.0 - run.trace.busy_s / run.trace.window_s)


def mfu(run) -> Optional[float]:
    """Percent: the least time of all the units' work over the window."""
    if run.trace is None or run.trace.window_s <= 0:
        return None
    least = roofline.total(w for u in run.units for w in u["work"].values()).seconds()
    return 100.0 * least / run.trace.window_s if least > 0 else None
