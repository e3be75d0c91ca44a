"""Readings that set the check's limits, and the control that has to fail it.

    python3 portbench/control.py --workload <cell> --seeds <n> [--first <seed>]
                                 [--seconds <s>] [--out <file>]

For each seed: the cell's set-up, a short window at the cell's own load,
then the numbers that its check compares twice: the program against the
plain reference (the lower readings), the reference in TF32 put in the
program's place against the reference (the control, which has to fail),
and, for a driver that has them, the faults planted in the reference.
One JSON line per seed goes to standard output and, with ``--out``, to
that file.  Not part of a benchmark run.
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from portbench import harness  # noqa: E402


def readings(cell: harness.Cell, seed: int, seconds: float, device: str = "cuda") -> dict:
    """One seed's program and control numbers for ``cell``."""
    harness.prepare_env(harness.work_dir(cell.name))
    ctx = harness.Context(cell, seed, seconds, False, device, harness.work_dir(cell.name))
    driver = harness.load_driver(cell.workload["driver"])
    state = driver.setup(ctx)
    out = driver.window(state, ctx, harness.Run(cell.name))
    program = dict(driver.check(state, out, ctx))
    control = dict(driver.control(state, out, ctx))
    faults = driver.faults(state, out, ctx) if hasattr(driver, "faults") else {}
    return {"seed": seed, "failed": out["failed"], "program": program, "control": control,
            "faults": faults}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, default=3)
    ap.add_argument("--first", type=int, default=3_000_000_001)
    ap.add_argument("--seconds", type=float, default=2.0)
    ap.add_argument("--out")
    args = ap.parse_args(argv)
    cell = harness.load_cell(args.workload)
    for i in range(args.seeds):
        line = json.dumps(readings(cell, args.first + 7919 * i, args.seconds))
        print(line, flush=True)
        if args.out:
            with open(args.out, "a") as f:
                f.write(line + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
