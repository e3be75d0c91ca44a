"""Run one cell of the benchmark once:

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout on a machine with an NVIDIA card.  It makes
the cell's inputs from the seed, warms up, measures for ``--seconds``
(with ``--trace 1``: traces the cell's traced work instead), checks what
the timed path produced against the plain reference in
``portbench/reference/``, prints each number compared beside its limit on
standard error, and prints one JSON line last on standard output.  It
exits with 1 and prints no result without a card, or when the measured
process holds JAX or the JAX package once the window has closed.
"""

from __future__ import annotations

import time

T_PROCESS = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from portbench import harness  # noqa: E402


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    import torch

    cell = harness.load_cell(args.workload)
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        print(f"portbench: {args.workload} needs {cell.chips} CUDA device(s); "
              f"found {torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 1
    if not 0 <= args.seed < 2**63:
        print(f"portbench: seed {args.seed} is outside [0, 2**63)", file=sys.stderr)
        return 1
    result, checks = harness.run_cell(cell, args.seed, args.seconds, bool(args.trace),
                                      "cuda", T_PROCESS)
    found = harness.forbidden_modules()
    if found:
        print(f"portbench: the measured process holds {found}", file=sys.stderr)
        return 1
    for name, value, limit in checks:
        print(f"check {name} {value!r} limit {limit!r}", file=sys.stderr)
    print(f"correct {result['correct']}", file=sys.stderr, flush=True)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
