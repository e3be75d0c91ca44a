"""Seconds of the finalize phase per default run, from the program's PhaseTimer."""

from portbench import layers


def read(run):
    return layers.phase_s_per_unit(run, "finalize")
