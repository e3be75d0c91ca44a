"""Milliseconds of the discovery phase per file, from the program's PhaseTimer."""

from portbench import layers


def read(run):
    return layers.phase_ms_per(run, "discovery")
