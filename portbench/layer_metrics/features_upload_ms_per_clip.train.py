"""The upload of the frontend's padded buckets per clip of a default run,
from the program's span ``features.upload``."""

from portbench import spans


def read(run):
    return spans.ms_per_clip(run, "features.upload")
