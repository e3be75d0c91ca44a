"""The similarities, the adaptive gate and the verdict lines per clip of an
--identify batch, from the program's PhaseTimer."""

from portbench import layers


def read(run):
    return layers.phase_ms_per(run, "gate")
