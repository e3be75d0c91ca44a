"""Seconds of the corpus epochs' order and dropout draws per default run, from
the program's span ``corpus.draws``."""

from portbench import spans


def read(run):
    return spans.per_unit(run, "corpus.draws")
