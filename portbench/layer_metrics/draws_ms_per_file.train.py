"""The discovery loop's per-file epoch views (threefry draws, shuffle,
dropout) per file, from the program's span ``train.draws``."""

from portbench import spans


def read(run):
    return spans.ms_per_clip(run, "train.draws")
