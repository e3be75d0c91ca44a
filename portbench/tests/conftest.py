"""The benchmark's CPU tests: ``pytest portbench/tests`` from the root of a
checkout.  Tests that need a card are marked ``cuda`` and decide inside
the test."""

import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))
