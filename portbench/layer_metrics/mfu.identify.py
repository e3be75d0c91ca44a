"""The traced --identify batches' least time on the card over their time, in percent."""

from portbench import layers


def read(run):
    return layers.mfu(run)
