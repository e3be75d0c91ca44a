"""Device operations that start inside the program's discovery phase, per
file: the launches and copies beside K6."""

from portbench import spans


def read(run):
    return spans.ops_per_clip(run, "discovery")
