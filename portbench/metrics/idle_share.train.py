"""The share of the traced training window in which the device ran nothing."""

from portbench import readers


def read(ctx):
    return readers.idle_share(ctx, "train")
