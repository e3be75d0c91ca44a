"""Loading the model (and any embeddings rebuilt for an older checkpoint)
per clip of an --identify batch, from the program's PhaseTimer."""

from portbench import layers


def read(run):
    return layers.phase_ms_per(run, "load")
