"""K1 and K2's share of their roofline in the training window."""

from portbench import readers


def read(ctx):
    return readers.attn_roofline(ctx, "train")
