"""Measured backend selection, cached per card.

The port of ``streamz_tpu/runtime/autotune.py``.  When two formulations of
a hot stage exist (here the MFCC base as K1, the TPU kernel v4's
formulation, against K2, v3's), the default is chosen by measurement on
the card in use, not hardcoded.  Decisions are cached in-process and on disk under
``"<stage>:<torch.cuda.get_device_name()>"``, so later processes on the
same kind of card skip the probe.

A stored decision holds for the candidate set it was measured against,
each candidate with its version (for a kernel, the hash of the sources it
is built from): a rebuilt kernel is probed again.

When the static default is one of the candidates, it stays unless another
candidate beats it by more than the probe's own run-to-run spread: a probe
may return the times of its repeated runs, and the spread it read is
stored with the decision.  The frontend's K1 and K2 differ by under 3%,
and the lower of two times alone picked one in some processes and the
other in the next.

In a multi-process run (a process group of two or more ranks) a choice
made without a ``mesh`` probes nothing and reads and writes no cache:
every rank takes the static default, as the JAX package does on more than
one host (``streamz_tpu/runtime/autotune.py:153-158``, ``:234-235``), so
that every rank runs the same kernels whatever its cache holds.  A choice
made with the ``mesh`` every rank calls it under (the discovery scan's
route, ``streamz_tpu/app/device_loop.py:330-424``) is made by every rank
alike, when the ranks share one host: a cached decision counts only when
every rank holds the same one; otherwise every rank runs every probe, the
times are all-reduced to their maximum, every rank takes the same winner,
and rank 0 alone writes the disk cache.  Across hosts it is the default.

Unlike the JAX package, a probe that raises is not skipped: a candidate
kernel that fails to build or launch fails the run instead of quietly
losing the measurement.  Only writing the disk cache may fail silently.
"""

from __future__ import annotations

import json
import os
import tempfile
from typing import Callable, Dict, Optional, Sequence, Tuple, Union

import torch

from streamz_tpu_torch.parallel import comm


def _default_cache_path() -> str:
    """Per-user cache file in the temporary directory (a world-shared name
    breaks for the second user of a machine); ``STREAMZ_AUTOTUNE_CACHE``
    overrides it."""
    try:
        uid = f"-{os.getuid()}"
    except AttributeError:  # non-POSIX
        uid = ""
    return os.path.join(tempfile.gettempdir(), f"streamz_tpu_torch_autotune{uid}.json")


_CACHE_PATH = os.environ.get("STREAMZ_AUTOTUNE_CACHE", _default_cache_path())
_memory: Dict[str, str] = {}
# The seconds each candidate's probe measured, per cache key, from the last
# probe in this process (the median of its runs where it returned several),
# and the relative run-to-run spread the decision read.
probe_times: Dict[str, Dict[str, float]] = {}
probe_spread: Dict[str, float] = {}

ProbeResult = Union[float, Sequence[float]]


def _cache_path() -> str:
    """Resolved per call, so ``STREAMZ_AUTOTUNE_CACHE`` set after import
    wins."""
    return os.environ.get("STREAMZ_AUTOTUNE_CACHE") or _CACHE_PATH


def _disk_get(key: str) -> dict:
    """The cached ``{"choice", "candidates"}`` entry for ``key``, or ``{}``."""
    try:
        with open(_cache_path()) as f:
            entry = json.load(f).get(key)
    except (OSError, ValueError, AttributeError):
        return {}
    return entry if isinstance(entry, dict) else {}


def _disk_put(key: str, value) -> None:
    """Merge ``key: value`` into the cache file under an exclusive lock on a
    sidecar lockfile, published by temp file + ``os.replace`` so a reader
    never sees torn JSON.  A cache that cannot be written is skipped."""
    try:
        path = _cache_path()
        with open(path + ".lock", "w") as lock_f:
            try:
                import fcntl

                fcntl.flock(lock_f, fcntl.LOCK_EX)
            except (ImportError, OSError):
                pass  # no flock here: still atomic through the replace
            cached = {}
            try:
                with open(path) as f:
                    cached = json.load(f)
            except (OSError, ValueError):
                pass  # absent or corrupt: start a fresh one
            if not isinstance(cached, dict):
                cached = {}
            cached[key] = value
            tmp = path + f".tmp.{os.getpid()}"
            with open(tmp, "w") as f:
                json.dump(cached, f)
            os.replace(tmp, path)
    except OSError:
        pass


def on_cuda() -> bool:
    """Whether the port's entry points run on a CUDA card here (the
    counterpart of the JAX package's ``on_tpu``)."""
    return torch.cuda.is_available()


def device_kind() -> str:
    """The name of the card in use, the cache's key."""
    return torch.cuda.get_device_name(torch.cuda.current_device())


def _key(stage: str) -> str:
    return f"{stage}:{device_kind() if on_cuda() else 'cpu'}"


def probing_disabled() -> bool:
    """``STREAMZ_NO_AUTOTUNE=1`` (or the CLI's ``--no-autotune``) skips every
    measurement probe: cached decisions are still honoured, and a cold cache
    resolves to the static default."""
    return os.environ.get("STREAMZ_NO_AUTOTUNE", "0") == "1"


def _read_probe(result: ProbeResult) -> Tuple[float, float]:
    """(time, relative spread) of one probe's result: a single time has no
    spread; the times of repeated runs give their lower median and
    ``(max - min) / median``."""
    if isinstance(result, (int, float)):
        return float(result), 0.0
    runs = sorted(float(t) for t in result)
    mid = runs[(len(runs) - 1) // 2]
    return mid, (runs[-1] - runs[0]) / mid if mid > 0 else 0.0


def _agreed(mesh, local: Optional[str], candidates, can_probe: bool
            ) -> Tuple[Optional[str], bool]:
    """Every rank's (cached choice, may probe), made one: the choice when
    every rank holds the same candidate (else None), and whether every rank
    may probe.  One all-gather, which every rank reaches."""
    names = sorted(candidates)
    mine = torch.tensor([names.index(local) if local in candidates else -1,
                         int(can_probe)], dtype=torch.int64,
                        device=comm.mesh_device(mesh))
    every = comm.all_gather(mine, mesh).cpu().tolist()
    idx = {i for i, _ in every}
    agreed = names[idx.pop()] if len(idx) == 1 and -1 not in idx else None
    return agreed, all(p for _, p in every)


def _slowest(mesh, read: Dict[str, Tuple[float, float]]) -> Dict[str, Tuple[float, float]]:
    """Each probe's (time, spread), the largest over the ranks: one
    all-reduce."""
    names = sorted(read)
    vals = torch.tensor([v for n in names for v in read[n]], dtype=torch.float64,
                        device=comm.mesh_device(mesh))
    comm.all_reduce_max(vals, mesh)
    vals = vals.cpu().tolist()
    return {n: (vals[2 * i], vals[2 * i + 1]) for i, n in enumerate(names)}


def measured_choice(
    stage: str,
    candidates: Dict[str, Callable[[], ProbeResult]],
    default: str,
    force: bool = False,
    versions: Optional[Dict[str, str]] = None,
    mesh=None,
) -> str:
    """The name of the fastest candidate on this card.

    ``candidates`` maps a name to a zero-argument probe returning a time
    (lower is better), or the times of its repeated runs; each probe warms
    itself up.  ``versions`` maps a name to what that candidate is built
    from: a cached decision whose candidates or versions differ is probed
    again.  Without a card the ``default`` is returned without probing.  An
    exception from a probe propagates.  ``force`` probes again, ignoring
    both caches.

    When ``default`` is a candidate it stays unless the fastest one is
    faster by more than the spread: ``t_best < t_default * (1 - spread)``,
    the spread being the largest relative run-to-run spread of any
    candidate's runs (0 for probes that return one time).  A tie keeps the
    default.  The spread is stored with the decision.

    ``mesh``: a choice every rank of the mesh makes together (see the
    module docstring); every rank must call it with the same arguments.
    """
    ranked = mesh is not None and comm.world_size() > 1
    if comm.world_size() > 1 and not (ranked and comm.single_host()):
        return default  # before any cache lookup: every rank the same
    key = _key(stage)
    measured_set = sorted(
        f"{name}@{versions[name]}" if versions and name in versions else name
        for name in candidates
    )
    cached = None
    if not force:
        if key in _memory:
            cached = _memory[key]
        elif on_cuda():
            entry = _disk_get(key)
            # With probing disabled, a still-valid winner of another
            # candidate set or version beats the static default.
            if entry.get("choice") in candidates and (
                entry.get("candidates") == measured_set or probing_disabled()
            ):
                cached = entry["choice"]
        elif not ranked:
            cached = default
    can_probe = on_cuda() and not probing_disabled()
    if ranked:
        cached, can_probe = _agreed(mesh, cached, candidates, can_probe)
    if cached is not None:
        _memory[key] = cached
        return cached
    if not can_probe:
        # Memoised, never persisted: the next probing process measures.
        _memory[key] = default
        return default

    read = {name: _read_probe(probe()) for name, probe in candidates.items()}
    if ranked:
        read = _slowest(mesh, read)
    times = {name: t for name, (t, _) in read.items()}
    best = min(times, key=times.get)
    entry = {"candidates": measured_set}
    if default in times:
        spread = max(s for _, s in read.values())
        if not times[best] < times[default] * (1.0 - spread):
            best = default
        entry["spread"] = probe_spread[key] = spread
    probe_times[key] = times
    _memory[key] = best
    if not ranked or comm.axis_index(mesh) == 0:
        _disk_put(key, {"choice": best, **entry})
    return best


def cached_choice(stage: str, default_cuda: str, default_other: str) -> str:
    """A no-probe resolve: the cached measured decision when there is one,
    else a static default for a card (``default_cuda``) or the CPU."""
    if not on_cuda():
        return default_other
    if comm.world_size() > 1:
        return default_cuda
    key = _key(stage)
    if key in _memory:
        return _memory[key]
    cached = _disk_get(key).get("choice")
    if cached is not None:
        _memory[key] = cached
        return cached
    return default_cuda


def reset(stage: Optional[str] = None) -> None:
    """Drop in-process decisions (tests)."""
    for k in [k for k in _memory if stage is None or k.startswith(f"{stage}:")]:
        del _memory[k]
        probe_times.pop(k, None)
        probe_spread.pop(k, None)
