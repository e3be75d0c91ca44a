"""The benchmark's harness: finds a cell's pieces by name, runs its set-up,
its measured window and its check, and prints the result line.

Everything that belongs to one configuration, traffic mix or per-layer
metric sits in a file of its own, found by the name that
``BENCHMARK.json`` gives:

- ``configs/<config>.json``: a configuration;
- ``workloads/<cell>.json``: a traffic mix, naming its configuration, its
  driver and its parameters, and the limits of its check;
- ``drivers/<driver>.py``: one kind of traffic, with ``setup``, ``window``,
  ``end_to_end`` and ``check``;
- ``layer_metrics/<metric>.py``: one per-layer metric, a ``read(run)``
  that returns a number or None.
"""

from __future__ import annotations

import gc
import importlib.util
import json
import os
import re
import shutil
import sys
import time
from dataclasses import dataclass, field
from pathlib import Path
from typing import Callable, Dict, List, Optional, Tuple

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
# Top-level module names the measured process may not hold: the JAX
# package is the port's reference, never the system under test.
FORBIDDEN = ("jax", "jaxlib", "flax", "streamz_tpu")
PROGRAM = "streamz_tpu_torch"


def load_json(path: Path) -> dict:
    with open(path, encoding="utf-8") as f:
        return json.load(f)


def manifest(root: Path = ROOT) -> dict:
    return load_json(root / "BENCHMARK.json")


def _module(path: Path, tag: str):
    """A benchmark file loaded as a module by its path (its name may hold
    dots, which an import statement cannot)."""
    if not path.is_file():
        raise FileNotFoundError(f"no {tag} file {path}")
    spec = importlib.util.spec_from_file_location(
        f"portbench_{tag}_{re.sub(r'[^A-Za-z0-9_]', '_', path.stem)}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def load_driver(name: str, base: Path = HERE):
    return _module(base / "drivers" / f"{name}.py", "driver")


def load_reader(name: str, base: Path = HERE) -> Callable[["Run"], Optional[float]]:
    return _module(base / "layer_metrics" / f"{name}.py", "metric").read


@dataclass
class Cell:
    name: str
    chips: int
    workload: dict
    config: dict
    end_to_end: List[dict]
    per_layer: List[dict]


def metric_applies(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def load_cell(name: str, root: Path = ROOT) -> Cell:
    """A cell of ``BENCHMARK.json`` with its workload file, its
    configuration file and the metrics it reports."""
    if not NAME.match(name):
        raise ValueError(f"bad cell name {name!r}")
    man = manifest(root)
    entry = next((w for w in man["workloads"] if w["name"] == name), None)
    if entry is None:
        raise KeyError(f"no cell {name!r} in BENCHMARK.json")
    base = root / "portbench"
    workload = load_json(base / "workloads" / f"{name}.json")
    conf_entry = next(c for c in man["configs"] if c["name"] == entry["config"])
    config = load_json(root / conf_entry["file"])
    return Cell(name, int(entry["chips"]), workload, config,
                [m for m in man["end_to_end"] if metric_applies(m, name)],
                [m for m in man["per_layer"] if metric_applies(m, name)])


def forbidden_modules() -> List[str]:
    """Modules of ``sys.modules`` whose top-level name is forbidden, compared
    whole: ``streamz_tpu_torch`` is the port, ``streamz_tpu`` is not."""
    return sorted({m for m in sys.modules if m.split(".")[0] in FORBIDDEN})


def prepare_env(tmp: Path) -> None:
    """Caches inside the checkout at fixed paths, so that only a cell's
    first run in a checkout builds; the frontend probe's decision in this
    run's own temporary directory, removed first, so that every run pays
    the probe in set-up as a user's first run does."""
    cache = HERE / "_cache"
    os.environ["TRITON_CACHE_DIR"] = str(cache / "triton")
    os.environ["TORCH_EXTENSIONS_DIR"] = str(cache / "torch_extensions")
    os.environ["USE_FLAX"] = "0"
    os.environ["USE_JAX"] = "0"
    probe = tmp / "autotune.json"
    if probe.exists():
        probe.unlink()
    os.environ["STREAMZ_AUTOTUNE_CACHE"] = str(probe)
    for key in ("STREAMZ_DIST_AUTO", "STREAMZ_NO_AUTOTUNE", "STREAMZ_SHARD_DISCOVERY",
                "STREAMZ_STORE_MAX_MB"):
        os.environ.pop(key, None)


def work_dir(cell: str) -> Path:
    """The run's scratch directory under ``TMPDIR``, emptied first."""
    base = Path(os.environ.get("TMPDIR") or "/tmp") / "portbench" / cell
    if base.exists():
        shutil.rmtree(base)
    base.mkdir(parents=True)
    return base


# ---------------------------------------------------------------------------
# What a run hands to the per-layer readers.
# ---------------------------------------------------------------------------


@dataclass
class Trace:
    """A traced window reduced to what the readers need: device operations
    as (name, start s, seconds), the benchmark's spans as (name, start s,
    seconds), the busy seconds and the window's length."""

    ops: List[Tuple[str, float, float]]
    spans: List[Tuple[str, float, float]]
    host_ops: List[Tuple[str, float, float]]
    window_s: float
    busy_s: float = 0.0
    bounds: Tuple[float, float] = (0.0, 0.0)

    def kernel_seconds(self, pattern: str) -> Tuple[float, int]:
        """Seconds and launches of the device operations whose name matches."""
        rx = re.compile(pattern)
        hits = [d for n, _, d in self.ops if rx.search(n)]
        return float(sum(hits)), len(hits)


@dataclass
class Run:
    """A run as the per-layer readers see it."""

    cell: str
    units: List[dict] = field(default_factory=list)   # per default run or batch
    trace: Optional[Trace] = None


def summarize_profile(prof) -> Trace:
    """Device operations, spans and host operations of a finished
    ``torch.profiler`` run, on the window of its ``portbench.window`` span."""
    from torch.autograd import DeviceType

    ops, spans, host = [], [], []
    for e in prof.events():
        start, dur = e.time_range.start / 1e6, e.time_range.elapsed_us() / 1e6
        if e.name.startswith("portbench."):
            if e.device_type != DeviceType.CUDA:  # not its shadow on the GPU timeline
                spans.append((e.name[len("portbench."):], start, dur))
        elif e.device_type == DeviceType.CUDA:
            ops.append((e.name, start, dur))
        elif dur > 0:
            host.append((e.name, start, dur))
    ops.sort(key=lambda o: o[1])
    _, lo, length = next(s for s in spans if s[0] == "window")
    busy = _union(((s, s + d) for _, s, d in ops), lo, lo + length)
    return Trace(ops, spans, host, length, busy, (lo, lo + length))


def _union(intervals, lo: float, hi: float) -> float:
    total, end = 0.0, lo
    for s, e in sorted(intervals):
        s, e = max(s, end), min(e, hi)
        if e > s:
            total += e - s
            end = e
    return total


def breakdown(tr: Trace) -> dict:
    """The device operations that took most time, and the longest idle
    gaps named by what the host was doing: the benchmark's innermost span
    and the shortest host operation around the gap's middle."""
    by_name: Dict[str, float] = {}
    for n, _, d in tr.ops:
        by_name[n] = by_name.get(n, 0.0) + d
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:10]
    lo, hi = tr.bounds
    gaps, end = [], lo
    for _, s, d in tr.ops:
        if s > end:
            gaps.append((end, s))
        end = max(end, s + d)
    if hi > end:
        gaps.append((end, hi))
    gaps = sorted(gaps, key=lambda g: g[0] - g[1])[:10]
    named = []
    for a, b in gaps:
        mid = 0.5 * (a + b)
        span = min((x for x in tr.spans if x[1] <= mid <= x[1] + x[2]),
                   key=lambda x: x[2], default=None)
        op = min((x for x in tr.host_ops if x[1] <= mid <= x[1] + x[2]),
                 key=lambda x: x[2], default=None)
        label = "/".join(p for p in (span[0] if span else "", op[0] if op else "") if p)
        named.append([label or "no host activity", b - a])
    return {"device_ops": [[n, s] for n, s in top], "idle_gaps": named}


# ---------------------------------------------------------------------------
# One run of a cell.
# ---------------------------------------------------------------------------


@dataclass
class Context:
    """What a driver gets: the cell, the seed, the window, the device and
    its scratch directory."""

    cell: Cell
    seed: int
    seconds: float
    trace: bool
    device: str
    work: Path
    log: Callable[[str], None] = lambda s: print(s, file=sys.stderr, flush=True)


def spread(values: List[float]) -> str:
    """Extremes, quartiles and median of a list, for a run's log."""
    import numpy as np

    q = np.percentile(values, [0, 25, 50, 75, 100])
    return "min %.4f q1 %.4f median %.4f q3 %.4f max %.4f" % tuple(q)


def percentile(values, q: float) -> float:
    import numpy as np

    return float(np.percentile(np.asarray(values, dtype=np.float64), q))


def run_cell(cell: Cell, seed: int, seconds: float, trace: bool, device: str = "cuda",
             t_process: Optional[float] = None) -> Tuple[dict, List[Tuple[str, float, float]]]:
    """Set-up, the measured (or traced) window, the check.  Returns the
    result line's object and the check's (name, value, limit) rows."""
    import torch

    t_start = time.perf_counter() if t_process is None else t_process
    work = work_dir(cell.name)
    prepare_env(work)
    ctx = Context(cell, seed, seconds, trace, device, work)
    driver = load_driver(cell.workload["driver"])
    on_card = device.startswith("cuda")
    state = driver.setup(ctx)
    # What set-up made lives on: keep the collector off it in the window.
    gc.collect()
    gc.freeze()
    if on_card:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
    setup_s = time.perf_counter() - t_start
    run = Run(cell.name)
    if trace:
        out = _traced_window(driver, state, ctx, run, on_card)
    else:
        out = driver.window(state, ctx, run)
    peak = torch.cuda.max_memory_allocated() if on_card else 0
    if trace:
        metrics = {}
        for m in cell.per_layer:
            v = load_reader(m["name"])(run)
            if v is not None:
                metrics[m["name"]] = {"value": float(v), "unit": m["unit"]}
    else:
        values = driver.end_to_end(out, ctx)
        values["setup_s"] = setup_s
        metrics = {m["name"]: {"value": float(values[m["name"]]), "unit": m["unit"]}
                   for m in cell.end_to_end}
    attempted, failed = out["attempted"], out["failed"]
    rows = driver.check(state, out, ctx)
    limits = cell.workload["limits"]
    checks = [(n, float(v), float(limits[n])) for n, v in rows]
    correct = failed == 0 and attempted > 0 and all(v <= lim for _, v, lim in checks)
    device_info = {"platform": "gpu" if on_card else "cpu",
                   "kind": torch.cuda.get_device_name(0) if on_card else "cpu",
                   "count": 1, "memory_peak_bytes": int(peak)}
    result = {"correct": bool(correct), "attempted": int(attempted), "failed": int(failed),
              "metrics": metrics, "device": device_info}
    if trace and run.trace is not None:
        device_info["busy_s"] = run.trace.busy_s
        device_info["window_s"] = run.trace.window_s
        result["breakdown"] = breakdown(run.trace)
    result["check"] = {n: {"value": v, "limit": lim} for n, v, lim in checks}
    return result, checks


def _traced_window(driver, state, ctx: Context, run: Run, on_card: bool):
    """The driver's traced work under ``torch.profiler``, CPU and CUDA; the
    window is the benchmark's span ``window`` around it."""
    import torch
    from torch.profiler import ProfilerActivity, profile, record_function

    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if on_card else [])
    with profile(activities=acts) as prof:
        with record_function("portbench.window"):
            out = driver.window(state, ctx, run)
            if on_card:
                torch.cuda.synchronize()
    run.trace = summarize_profile(prof)
    return out
