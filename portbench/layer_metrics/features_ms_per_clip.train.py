"""The frontend phase per clip of a default run, from the program's PhaseTimer."""

from portbench import layers


def read(run):
    return layers.phase_ms_per(run, "features")
