"""K5's share of its roofline over the traced corpus phases."""

from portbench import layers


def read(run):
    return layers.roofline_share(run, "corpus", layers.K5)
