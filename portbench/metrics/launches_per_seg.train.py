"""Device kernels launched in the traced training window over the segments
its completed optimizer steps trained."""

from portbench import readers


def read(ctx):
    return readers.launches_per(ctx, "train", "segments")
