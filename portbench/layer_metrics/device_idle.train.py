"""Percent of the traced default runs in which no device operation ran."""

from portbench import layers


def read(run):
    return layers.idle(run)
