"""The MFCC kernel's share of its roofline in the traced --identify batches: K1's, or K2's where the probe chose it."""

from portbench import layers


def read(run):
    return layers.frontend_share(run)
