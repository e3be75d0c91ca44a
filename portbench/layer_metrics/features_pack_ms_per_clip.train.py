"""The frontend's host packing (float conversion, zero-padded buckets) per
clip of a default run, from the program's span ``features.pack``."""

from portbench import spans


def read(run):
    return spans.ms_per_clip(run, "features.pack")
