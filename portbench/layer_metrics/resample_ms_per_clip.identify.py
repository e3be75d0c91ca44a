"""The native resampler's pass (downmix and resample, inside ingest) per
clip of an --identify batch, from the program's span ``ingest.resample``.
None where no clip was resampled, or the program has no such span."""

from portbench import spans


def read(run):
    return spans.ms_per_clip(run, "ingest.resample")
