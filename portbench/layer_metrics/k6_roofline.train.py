"""K6's share of its roofline over the traced discovery phases."""

from portbench import layers


def read(run):
    return layers.roofline_share(run, "k6", layers.K6)
